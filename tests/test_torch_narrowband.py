"""The port's narrowband estimators and per-bin absorption against the JAX
package, in float64 on the same numpy inputs (small sizes: the 8-mic 1 m
cube at 16 kHz x 0.1-0.25 s): ``models/beamformer.py``'s locating half,
``music.py``, ``order.py``, ``capon.py``, the group jackknife and
``summary_from_covariance``, the api's narrowband branch, and the per-bin
render.

Tolerances: 1e-9 relative for bin selection, maps, inverses, refined
frequencies, information criteria and the per-bin render; 1e-8 for
noise-subspace projections (the embedding doubles every eigenvalue, so
``eigh`` may return any rotation inside a pair: projections are unique,
eigenvectors are not); 1e-6 m for positions; equality for source counts.
Grid searches follow ``tests/test_torch_srp.py``'s tie rule: held to JAX
where the coarse map's top two cells differ by more than 1e-9 relative,
else the port's coarse cell must be one of JAX's tied cells."""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiolocalization_tpu as jpkg
import pyaudiolocalization_tpu_torch as tpkg
from pyaudiolocalization_tpu.models import beamformer as jbf
from pyaudiolocalization_tpu.models import capon as jcap
from pyaudiolocalization_tpu.models import music as jmu
from pyaudiolocalization_tpu.models import order as jord
from pyaudiolocalization_tpu.models import simulator as jsim
from pyaudiolocalization_tpu.models import srp as jsrp
from pyaudiolocalization_tpu.models import uncertainty as junc
from pyaudiolocalization_tpu.utils.materials import MaterialTable
from pyaudiolocalization_tpu_torch.models import acoustics as tac
from pyaudiolocalization_tpu_torch.models import beamformer as tbf
from pyaudiolocalization_tpu_torch.models import capon as tcap
from pyaudiolocalization_tpu_torch.models import music as tmu
from pyaudiolocalization_tpu_torch.models import order as tord
from pyaudiolocalization_tpu_torch.models import simulator as tsim
from pyaudiolocalization_tpu_torch.models import uncertainty as tunc

FS = 16000.0
C = 343.0
CUBE = np.array([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0)
                 for z in (0.0, 1.0)])
LO = np.array([0.08, 0.08, 0.08])
HI = np.array([0.92, 0.92, 0.92])
BAND = (300.0, 3400.0)
TOL = 1e-9


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def tones(sources, freqs, n=1600, seed=0, noise=0.01):
    """(8, n) cube signals: each source's tone sin(2 pi f (t - d/c) + k)/d
    summed, plus white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    out = np.zeros((len(CUBE), n))
    for k, (src, f) in enumerate(zip(sources, freqs)):
        d = np.linalg.norm(np.asarray(src)[None] - CUBE, axis=-1)
        out += np.sin(2 * np.pi * f * (t[None] - d[:, None] / C) + k) \
            / np.maximum(d, 0.1)[:, None]
    return out + noise * rng.standard_normal(out.shape)


SCENES = [tones([(0.3, 0.6, 0.4)], [800.0], seed=1),
          tones([(0.7, 0.2, 0.55)], [800.0], seed=2)]
MIX = tones([(0.3, 0.6, 0.4), (0.7, 0.3, 0.6)], [600.0, 950.0], n=4000,
            seed=3)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


def _snaps(sig):
    return jmu.snapshot_frames(_j(sig), 256), tmu.snapshot_frames(_t(sig),
                                                                  256)


def _bins(snaps_j, snaps_t, band=BAND):
    idx_j, w_j = jbf.select_bins(jnp.mean(jnp.abs(snaps_j), axis=1), FS, 256,
                                 8, band)
    idx_t, w_t = tbf.select_bins(torch.mean(torch.abs(snaps_t), -2), FS, 256,
                                 8, band)
    return idx_j, w_j, idx_t, w_t


def _points(n=6):
    g = np.linspace(0.1, 0.9, n)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


# ---------------------------------------------------------------------------
# Bins, maps, subspaces, inverses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("band", [None, BAND])
def test_select_bins_matches_jax(band):
    spectra = np.fft.rfft(SCENES[0], 2048)
    idx_j, w_j = jbf.select_bins(_j(spectra), FS, 2048, 12, band)
    idx_t, w_t = tbf.select_bins(_t(spectra), FS, 2048, 12, band)
    assert idx_t.tolist() == np.asarray(idx_j).tolist()
    assert _rel(w_t, w_j) < TOL


def test_select_bins_keeps_index_order_on_ties():
    """Silence: every bin ties at 0; the indices come in index order with
    zero weights (jax.lax.top_k's order), and nothing is NaN."""
    spectra = np.zeros((8, 129), complex)
    idx_j, w_j = jbf.select_bins(_j(spectra), FS, 256, 8, BAND)
    idx_t, w_t = tbf.select_bins(_t(spectra), FS, 256, 8, BAND)
    assert idx_t.tolist() == np.asarray(idx_j).tolist() == list(range(8))
    assert torch.all(w_t == 0)


def test_steered_power_map_matches_jax():
    spectra = np.fft.rfft(SCENES[0], 2048)
    idx_j, w_j = jbf.select_bins(_j(spectra), FS, 2048, 12, BAND)
    idx_t, w_t = tbf.select_bins(_t(spectra), FS, 2048, 12, BAND)
    pts = _points()
    want = jbf.steered_power_map(_j(spectra), idx_j, w_j, _j(pts), _j(CUBE),
                                 FS, 2048, C)
    got = tbf.steered_power_map(_t(spectra), idx_t, w_t, _t(pts), _t(CUBE),
                                FS, 2048, C)
    assert _rel(got, want) < TOL


def test_snapshots_and_embedded_covariances_match_jax():
    snaps_j, snaps_t = _snaps(SCENES[0])
    assert _rel(snaps_t, snaps_j) < TOL
    idx_j, _, idx_t, _ = _bins(snaps_j, snaps_t)
    emb_j = jmu.embedded_covariances(snaps_j, idx_j)
    emb_t = tmu.embedded_covariances(snaps_t, idx_t)
    assert emb_t.shape == (8, 16, 16)
    assert _rel(emb_t, emb_j) < TOL
    a = np.random.default_rng(0).standard_normal((2, 3, 3))
    assert _rel(tmu.embed_planes(_t(a[0]), _t(a[1])),
                jmu.embed_planes(_j(a[0]), _j(a[1]))) == 0.0


def test_embedded_steering_matches_jax():
    omega = 2 * np.pi * np.array([600.0, 810.0, 1200.0])
    pts = _points(4)
    assert _rel(tmu.embedded_steering(_t(pts), _t(CUBE), _t(omega), C),
                jmu.embedded_steering(_j(pts), _j(CUBE), _j(omega), C)) < TOL


@pytest.mark.parametrize("num_sources", [1, 2])
def test_noise_subspace_projections_match_jax(num_sources):
    """Projections E E^T onto the noise subspace (unique), not the
    eigenvectors (any rotation inside an embedded pair)."""
    sig = SCENES[0] if num_sources == 1 else MIX
    snaps_j, snaps_t = _snaps(sig)
    idx_j, _, idx_t, _ = _bins(snaps_j, snaps_t)
    e_j = np.asarray(jmu._noise_subspaces(snaps_j, idx_j, num_sources))
    e_t = tmu._noise_subspaces(snaps_t, idx_t, num_sources).numpy()
    assert e_t.shape == (8, 16, 16 - 2 * num_sources)
    p_j = e_j @ np.swapaxes(e_j, -1, -2)
    p_t = e_t @ np.swapaxes(e_t, -1, -2)
    assert np.max(np.abs(p_t - p_j)) < 1e-8


@pytest.mark.parametrize("hop", [128, 240])
def test_refine_bin_freqs_matches_jax(hop):
    """hop 240 > 256 / 1.1: the bin centres, unrefined."""
    snaps_j = jmu.snapshot_frames(_j(SCENES[1]), 256, hop)
    snaps_t = tmu.snapshot_frames(_t(SCENES[1]), 256, hop)
    idx_j, _, idx_t, _ = _bins(snaps_j, snaps_t)
    want = jmu.refine_bin_freqs(snaps_j, idx_j, FS, 256, hop)
    got = tmu.refine_bin_freqs(snaps_t, idx_t, FS, 256, hop)
    assert _rel(got, want) < TOL
    base = 2 * np.pi * idx_t.numpy() / 256 * FS
    assert np.allclose(got.numpy(), base) == (hop == 240)


def test_music_maps_match_jax():
    snaps_j, snaps_t = _snaps(SCENES[1])
    idx_j, w_j, idx_t, w_t = _bins(snaps_j, snaps_t)
    subs_j = jmu._noise_subspaces(snaps_j, idx_j, 1)
    subs_t = tmu._noise_subspaces(snaps_t, idx_t, 1)
    om_j = jmu.refine_bin_freqs(snaps_j, idx_j, FS, 256, 128)
    om_t = tmu.refine_bin_freqs(snaps_t, idx_t, FS, 256, 128)
    pts = _points()
    assert _rel(tmu.music_map_bins(subs_t, om_t, _t(pts), _t(CUBE), C),
                jmu.music_map_bins(subs_j, om_j, _j(pts), _j(CUBE), C)) \
        < TOL
    assert _rel(tmu.music_map(subs_t, om_t, w_t, _t(pts), _t(CUBE), C),
                jmu.music_map(subs_j, om_j, w_j, _j(pts), _j(CUBE), C)) < TOL


@pytest.mark.parametrize("scale", [1.0, 0.0])
def test_loaded_inverse_matches_jax(scale):
    """A covariance and digital silence (the 1e-30 trace floor keeps its
    inverse finite)."""
    snaps_j, snaps_t = _snaps(SCENES[0] * scale)
    idx_j, _, idx_t, _ = _bins(snaps_j, snaps_t)
    want = jcap.loaded_inverse(jmu.embedded_covariances(snaps_j, idx_j), 1e-3)
    got = tcap.loaded_inverse(tmu.embedded_covariances(snaps_t, idx_t), 1e-3)
    assert torch.all(torch.isfinite(got))
    assert _rel(got, want) < TOL


def test_capon_maps_match_jax():
    snaps_j, snaps_t = _snaps(MIX)
    idx_j, w_j, idx_t, w_t = _bins(snaps_j, snaps_t)
    inv_j = jcap._loaded_inverses(snaps_j, idx_j, 1e-3)
    inv_t = tcap.loaded_inverse(tmu.embedded_covariances(snaps_t, idx_t),
                                1e-3)
    om_j = jmu.refine_bin_freqs(snaps_j, idx_j, FS, 256, 128)
    om_t = tmu.refine_bin_freqs(snaps_t, idx_t, FS, 256, 128)
    pts = _points()
    assert _rel(tcap.capon_map_bins(inv_t, om_t, _t(pts), _t(CUBE), C),
                jcap.capon_map_bins(inv_j, om_j, _j(pts), _j(CUBE), C)) < TOL
    assert _rel(tcap.capon_map(inv_t, om_t, w_t, _t(pts), _t(CUBE), C),
                jcap.capon_map(inv_j, om_j, w_j, _j(pts), _j(CUBE), C)) < TOL


# ---------------------------------------------------------------------------
# Model order
# ---------------------------------------------------------------------------

def test_information_criteria_and_eigvals_match_jax():
    snaps_j, snaps_t = _snaps(MIX)
    idx_j, _, idx_t, _ = _bins(snaps_j, snaps_t)
    ev_j = jord.complex_eigvals_from_embedded(
        jmu.embedded_covariances(snaps_j, idx_j))
    ev_t = tord.complex_eigvals_from_embedded(
        tmu.embedded_covariances(snaps_t, idx_t))
    assert ev_t.shape == (8, 8) and _rel(ev_t, ev_j) < TOL
    for got, want in zip(tord.information_criteria(ev_t, 30),
                         jord.information_criteria(ev_j, 30)):
        assert _rel(got, want) < TOL
    for method in ("aic", "mdl"):
        for cap in (None, 1):
            assert int(tord.order_from_eigvals(ev_t, 30, method, cap)) == \
                int(jord.order_from_eigvals(ev_j, 30, method, cap))


def _talkers(k, n=16000, seed=5):
    """k broadband talkers (white noise sources) on the cube."""
    rng = np.random.default_rng(seed)
    srcs = [(0.2, 0.7, 0.4), (0.8, 0.3, 0.6), (0.5, 0.9, 0.2)][:k]
    out = np.zeros((8, n))
    nfft = 1 << 15
    f = np.fft.rfftfreq(nfft, 1 / FS)
    for src in srcs:
        spec = np.fft.rfft(rng.standard_normal(n), nfft)
        d = np.linalg.norm(np.asarray(src)[None] - CUBE, axis=-1)
        out += np.fft.irfft(spec[None] * np.exp(-2j * np.pi * f[None]
                                                * d[:, None] / C),
                            nfft)[:, :n] / d[:, None]
    return out + 0.05 * rng.standard_normal(out.shape)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_estimate_num_sources_equals_jax(k):
    sig = _talkers(k)
    want = jord.estimate_num_sources(_j(sig), FS)
    got = tord.estimate_num_sources(_t(sig), FS)
    assert isinstance(got, int) and got == want
    assert tord.estimate_num_sources(_t(sig), FS, method="aic") == \
        jord.estimate_num_sources(_j(sig), FS, method="aic")


# ---------------------------------------------------------------------------
# The searches
# ---------------------------------------------------------------------------

def _coarse_gap(solver, sig):
    """Relative gap between the JAX coarse map's top two cells."""
    pts = jsrp._grid_points(_j(LO), _j(HI), 24, jnp.float64)
    if solver == "beam":
        spectra = jnp.fft.rfft(_j(sig), n=2048)
        idx, w = jbf.select_bins(spectra, FS, 2048, 12, BAND)
        vals = jbf.steered_power_map(spectra, idx, w, pts, _j(CUBE), FS,
                                     2048, C)
    else:
        snaps = jmu.snapshot_frames(_j(sig), 256)
        idx, w = jbf.select_bins(jnp.mean(jnp.abs(snaps), axis=1), FS, 256,
                                 8, BAND)
        om = jmu.refine_bin_freqs(snaps, idx, FS, 256, 128)
        vals = (jmu.music_map(jmu._noise_subspaces(snaps, idx, 1), om, w,
                              pts, _j(CUBE), C) if solver == "music" else
                jcap.capon_map(jcap._loaded_inverses(snaps, idx, 1e-3), om,
                               w, pts, _j(CUBE), C))
    top = np.sort(np.asarray(vals))[-2:]
    return (top[1] - top[0]) / abs(top[1])


LOCATE = {"beam": (jbf.beamform_locate, tbf.beamform_locate,
                   dict(nfft=2048)),
          "music": (jmu.music_locate, tmu.music_locate, {}),
          "capon": (jcap.capon_locate, tcap.capon_locate, {})}


@pytest.mark.parametrize("solver", ["beam", "music", "capon"])
def test_locate_matches_jax_and_batches(solver):
    """Both scenes one by one against JAX (1e-6 m where the coarse map's
    top is clear), and as one batch equal to the single calls."""
    jfn, tfn, kw = LOCATE[solver]
    single = []
    for sig in SCENES:
        want = jfn(_j(sig), _j(CUBE), FS, C, _j(LO), _j(HI), band=BAND, **kw)
        got = tfn(_t(sig), _t(CUBE), FS, C, LO, HI, band=BAND, **kw)
        single.append(got)
        if _coarse_gap(solver, sig) > 1e-9:
            np.testing.assert_allclose(got.position.numpy(),
                                       np.asarray(want.position), atol=1e-6)
            np.testing.assert_allclose(float(got.power), float(want.power),
                                       rtol=1e-8)
        else:
            assert np.any(np.all(np.isclose(got.coarse.numpy(), np.asarray(
                want.coarse)), -1))
    batch = tfn(_t(np.stack(SCENES)), _t(CUBE), FS, C, LO, HI, band=BAND,
                **kw)
    for b, one in enumerate(single):
        np.testing.assert_allclose(batch.position[b].numpy(),
                                   one.position.numpy(), atol=1e-12)
    assert np.max(np.linalg.norm(batch.position.numpy() - np.array(
        [(0.3, 0.6, 0.4), (0.7, 0.2, 0.55)]), axis=-1)) < 0.02


MULTI = {"music": (jmu.music_locate_multi, tmu.music_locate_multi),
         "capon": (jcap.capon_locate_multi, tcap.capon_locate_multi)}


@pytest.mark.parametrize("solver", ["music", "capon"])
@pytest.mark.parametrize("num_sources", [2, "auto"])
def test_locate_multi_matches_jax(solver, num_sources):
    """Two tones (600 + 950 Hz): both peaks within 1e-6 m of JAX's and
    within 2 cm of the sources.  'auto' counts broadband sources (the MDL
    order of two disjoint tones is 1).  The peak values are held to 1e-6
    relative: at a MUSIC peak the noise projection nearly vanishes, and its
    reciprocal amplifies the rounding of the subspace."""
    jfn, tfn = MULTI[solver]
    want = jfn(_j(MIX), _j(CUBE), FS, C, _j(LO), _j(HI),
               num_sources=num_sources, band=BAND, min_separation=0.28)
    got = tfn(_t(MIX), _t(CUBE), FS, C, LO, HI, num_sources=num_sources,
              band=BAND, min_separation=0.28)
    assert got.positions.shape == np.asarray(want.positions).shape
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), atol=1e-6)
    np.testing.assert_allclose(got.powers.numpy(), np.asarray(want.powers),
                               rtol=1e-6)
    if num_sources == 2:
        src = np.array([(0.3, 0.6, 0.4), (0.7, 0.3, 0.6)])
        d = np.linalg.norm(got.positions.numpy()[:, None] - src[None], axis=-1)
        assert np.max(np.min(d, 0)) < 0.02


def test_music_checks_its_source_count():
    with pytest.raises(ValueError, match="num_sources"):
        tmu.music_locate(_t(SCENES[0]), _t(CUBE), FS, C, LO, HI,
                         num_sources=8)
    with pytest.raises(ValueError, match="one scene"):
        tmu.music_locate_multi(_t(np.stack(SCENES)), _t(CUBE), FS, C, LO, HI,
                               num_sources="auto")


# ---------------------------------------------------------------------------
# The group jackknife
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["beam", "capon"])
def test_group_jackknife_covariance_matches_jax(solver):
    jfn, tfn, kw = LOCATE[solver]
    sig = tones([(0.3, 0.6, 0.4)], [800.0], n=4000, seed=7, noise=0.2)
    x_hat = np.array([0.31, 0.59, 0.41])
    radius = 0.12 * (HI - LO)
    want = junc.group_jackknife_covariance(
        _j(sig), lambda s, lo, hi: jfn(s, _j(CUBE), FS, C, lo, hi, band=BAND,
                                       **kw).position, _j(x_hat),
        _j(radius))
    got = tunc.group_jackknife_covariance(
        _t(sig), lambda s, lo, hi: tfn(s, _t(CUBE), FS, C, lo, hi, band=BAND,
                                       **kw).position, _t(x_hat),
        _t(radius))
    assert got.shape == (3, 3) and float(torch.trace(got)) > 0
    assert _rel(got, want) < 1e-6


def test_summary_from_covariance_matches_jax():
    a = np.random.default_rng(1).standard_normal((3, 3))
    cov = a @ a.T * 1e-4
    want = junc.summary_from_covariance(cov, dof=3)
    got = tunc.summary_from_covariance(cov, dof=3)
    assert set(got) == set(want)
    for key in ("covariance", "std", "ellipsoid_radii"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    assert got["sigma_td"] is None and got["unobservable_axes"].shape == (3,
                                                                          0)


# ---------------------------------------------------------------------------
# The api's narrowband branch
# ---------------------------------------------------------------------------

def _api_config(solver, analyze):
    cfg = copy.deepcopy(jpkg.DEFAULT_CONFIG)
    cfg.update(fs=FS, duration=0.25, source_position=[0.3, 0.6, 0.4],
               signal_type="sine", freq=800.0,
               mic_positions=CUBE.tolist())
    cfg["localization"].update(
        lag_mode="physical", sync_mode="none", max_reflections=1,
        num_bootstrap=32, visualize_correlation=False, solver=solver,
        analyze_correlation=analyze,
        search_box=[[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    return cfg


@pytest.mark.parametrize("solver,analyze", [("beam", True),
                                            ("music", False),
                                            ("capon", False)])
def test_api_narrowband_matches_jax(solver, analyze):
    """The 8-mic cube with an 800 Hz tone: the fix within 1e-6 m of JAX's
    and 2 cm of the source, the jackknife covariance within 1e-6 relative
    (``heuristic`` False), the TDOAs zeros unless the metrics need the
    correlations."""
    cfg = _api_config(solver, analyze)
    want = jpkg.localize_sound_source(cfg, show_plots=False,
                                      dtype=jnp.float64)
    got = tpkg.localize_sound_source(cfg, device="cpu", dtype=torch.float64)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], atol=1e-6)
    assert np.linalg.norm(got["estimated_position"] - [0.3, 0.6, 0.4]) < 0.02
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-8)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], atol=1e-12)
    assert np.any(got["tdoas"] != 0) == analyze
    gu, wu = got["uncertainty"], want["uncertainty"]
    assert gu["heuristic"] is False and wu["heuristic"] is False
    assert gu["dof"] == wu["dof"] == 3
    assert _rel(gu["covariance"], wu["covariance"]) < 1e-6
    assert (got["correlation_metrics"] is None) == (not analyze)
    if analyze:
        for pair, w in want["correlation_metrics"].items():
            np.testing.assert_allclose(got["correlation_metrics"][pair]["snr"],
                                       w["snr"], rtol=1e-7)


# ---------------------------------------------------------------------------
# Per-bin absorption
# ---------------------------------------------------------------------------

TABLE = MaterialTable.from_dict({"air": {"absorption": 0.01, "freq": 2e-6},
                                 "wood": {"absorption": 0.05, "freq": 3e-5},
                                 "metal": {"absorption": 0.1, "freq": 1e-5}})
MICS4 = CUBE[[0, 4, 2, 1]]
PLANES = np.array([[1.0, 0, 0, -3.0], [0, 1.0, 0, -3.0], [0, 0, 1.0, -3.0]])
IDS = np.array([1, 2, 1])


def test_path_slopes_match_jax():
    src = np.array([0.2, 0.6, 0.4])
    imgs_j = jpkg.models.acoustics.image_sources(
        _j(src), _j(PLANES), jnp.asarray(IDS), _j(MICS4), 1000.0,
        _j(TABLE.absorption), _j(TABLE.freq), 2, 0.01)
    imgs_t = tac.image_sources(_t(src), _t(PLANES), torch.tensor(IDS),
                               _t(MICS4), 1000.0, _t(TABLE.absorption),
                               _t(TABLE.freq), 2, 0.01)
    want = jsim.scene_path_slopes(_j(src), _j(MICS4), imgs_j, _j(TABLE.freq))
    got = tsim.scene_path_slopes(_t(src), _t(MICS4), imgs_t, _t(TABLE.freq))
    assert got.shape == (4, 1 + 9) and _rel(got, want) < TOL
    d = torch.tensor([0.05, 2.0])
    assert torch.allclose(tac.attenuation_freq_slope(d, 1, _t(TABLE.freq)),
                          torch.tensor([0.1, 2.0]) * 3e-5)


@pytest.mark.parametrize("fast", [True, False])
def test_per_bin_render_matches_jax(fast):
    """simulate_signals_fast (the static power-of-two length) and
    simulate_signals (the exact 2N render) with per-bin absorption."""
    args = ([0.2, 0.6, 0.4], MICS4, 8000.0, C, 0.25, "chirp", 1000.0, PLANES,
            IDS, TABLE.absorption, TABLE.freq, 2, 0.01)
    jfn = jsim.simulate_signals_fast if fast else jsim.simulate_signals
    tfn = tsim.simulate_signals_fast if fast else tsim.simulate_signals
    want = jfn(*args, key=jax.random.PRNGKey(0), dtype=jnp.float64,
               absorption_mode="per-bin")
    got = tfn(*args, dtype=torch.float64, device="cpu",
              absorption_mode="per-bin")
    assert got.shape == (4, 2000) and _rel(got, want) < TOL
    carrier = tfn(*args, dtype=torch.float64, device="cpu")
    assert _rel(got, carrier) > 1e-3        # the per-bin law changes it


def test_per_bin_warns_on_reference_scale_coefficients():
    table = jpkg.utils.materials.default_table()
    with pytest.warns(UserWarning, match="per-bin"):
        tsim.simulate_signals_fast(
            [0.5, 0.5, 0.5], MICS4, 8000.0, C, 0.1, "sine", 1000.0, PLANES,
            IDS, table.absorption, table.freq, 1, 0.01, dtype=torch.float64,
            device="cpu", absorption_mode="per-bin")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsim.simulate_signals_fast(
            [0.5, 0.5, 0.5], MICS4, 8000.0, C, 0.1, "sine", 1000.0, PLANES,
            IDS, TABLE.absorption, TABLE.freq, 1, 0.01, dtype=torch.float64,
            device="cpu", absorption_mode="per-bin")
    with pytest.raises(ValueError, match="absorption_mode"):
        tsim.simulate_signals_fast(
            [0.5, 0.5, 0.5], MICS4, 8000.0, C, 0.1, "sine", 1000.0, PLANES,
            IDS, TABLE.absorption, TABLE.freq, 1, 0.01, device="cpu",
            absorption_mode="bogus")

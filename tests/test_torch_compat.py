"""The port's compat layer (pyaudiolocalization_tpu_torch/compat.py)
against the JAX package's, function by function, NumPy in and NumPy out on
the CPU in float64 (torch's default dtype set to float64 for the test, as
the JAX package runs with x64): the deterministic functions within 1e-9 of
the JAX answer; the random ones (pink noise, speech, the bootstrap and the
tests over it, k-means seeds, the calibration recording's noise) with the
JAX package's draws fed into the port's shaping, and the port's own draws
from its seeded module generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu import compat as jc
from pyaudiolocalization_tpu.models import cluster as jcl
from pyaudiolocalization_tpu.utils.materials import material_properties
from pyaudiolocalization_tpu_torch import compat as tc
from pyaudiolocalization_tpu_torch.models import solver as tsol
from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import signal as tsig

TOL = 1e-9
CPU = {"device": "cpu"}
FS = 8000.0
MICS = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
TD = [0.001, -0.002, 0.0005, 0.0002, -0.001, 0.0015]
PHYSICAL = {"air": {"absorption": 0.01, "freq": 1e-5},
            "wood": {"absorption": 0.05, "freq": 5e-5}}


@pytest.fixture(autouse=True)
def _float64_and_seeds():
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    jc.seed(0)
    tc.seed(0)
    yield
    torch.set_default_dtype(previous)


def _close(got, want, tol=TOL):
    want = np.asarray(want, float)
    np.testing.assert_allclose(np.asarray(got, float), want, rtol=tol,
                               atol=tol * max(float(np.max(np.abs(want))),
                                              1e-300))


def _jax_key(seed, call):
    """The key the JAX compat layer hands its ``call``-th random function
    after ``seed(seed)`` (split the module key, keep the second half)."""
    key = jax.random.PRNGKey(seed)
    for _ in range(call + 1):
        key, sub = jax.random.split(key)
    return sub


def _pair(n=600, shift=7, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n)
    return a, np.roll(a, shift) + 0.3 * rng.standard_normal(n)


def _jax_permuted_rows(key, sig2, num, chunk=64):
    keys = jax.random.split(key, -(-num // chunk) * chunk)
    return np.stack([np.asarray(jax.random.permutation(keys[d],
                                                       jnp.asarray(sig2)))
                     for d in range(num)])


# ---------------------------------------------------------------------------
# Deterministic functions: the same call on both sides.
# ---------------------------------------------------------------------------

def _calls():
    a, b = _pair()
    s = np.random.default_rng(2).standard_normal(500)
    calib = np.asarray(jc.generate_calibration_signal(FS, 0.1))
    recs = [np.roll(calib, k) for k in (3, 5, 8, 13)]
    corr = jc.phat_correlation(a, b)
    return {
        "speed_of_sound": lambda m: m.speed_of_sound(20.0, 50.0),
        "speed_of_sound_clamped": lambda m: m.speed_of_sound(80.0, 120.0,
                                                             99.0),
        "reflect_point_across_plane": lambda m: m.reflect_point_across_plane(
            [1.0, 2.0, 3.0], [0, 0, 1, -5]),
        "distance": lambda m: m.distance([0, 0, 0], [3, 4, 0]),
        "calculate_attenuation": lambda m: m.calculate_attenuation(
            2.0, "wood", 1000.0, PHYSICAL),
        "calculate_attenuation_fallback": lambda m: m.calculate_attenuation(
            2.0, "bogus", 1000.0, PHYSICAL),
        "phat_correlation": lambda m: m.phat_correlation(a, b),
        "get_time_delays_phat_reference": lambda m: m.get_time_delays_phat(
            a, b, FS, num_peaks=3),
        "get_time_delays_phat_physical": lambda m: m.get_time_delays_phat(
            a, b, FS, lag_mode="physical", max_expected_delay=0.01),
        "compute_peak_to_peak_ratio": lambda m: m.compute_peak_to_peak_ratio(
            corr),
        "compute_snr": lambda m: m.compute_snr(corr),
        "dynamic_bounds_extended": lambda m: m.dynamic_bounds_extended(
            MICS, TD, 343.0),
        "equations": lambda m: m.equations([0.5, 0.4, 0.3], MICS, PAIRS, TD,
                                           343.0),
        "equations_weighted": lambda m: m.equations(
            [0.5, 0.4, 0.3], MICS, PAIRS, TD, 343.0,
            weights=[1, 2, 3, 4, 5, 6]),
        "compute_weights": lambda m: m.compute_weights(
            {(0, 1): {"snr": 4.0}, (1, 2): {"snr": 2.5}}, PAIRS),
        "heuristic_dbscan": lambda m: m.heuristic_initialization_adaptive(
            MICS, PAIRS, TD, 343.0, clustering_method="dbscan", eps=0.3),
        "synchronize_signals_improved":
            lambda m: m.synchronize_signals_improved(
                [s, np.roll(s, 30), np.roll(s, -12)], FS),
        "fractional_delay": lambda m: m.fractional_delay(s, 3.3 / FS, FS),
        "normalize_signal": lambda m: m.normalize_signal(s),
        "dynamic_range_compression":
            lambda m: m.dynamic_range_compression(s, 0.6),
        "dynamic_range_compression_soft_clip":
            lambda m: m.dynamic_range_compression_soft_clip(s, 0.5),
        "resample_audio": lambda m: m.resample_audio(s, 8000.0, 11025.0),
        "noise_reduction_butterworth": lambda m: m.noise_reduction(s, FS),
        "noise_reduction_fir": lambda m: m.noise_reduction(
            s, FS, method="fir", filter_order=31),
        "noise_reduction_wiener": lambda m: m.noise_reduction(
            s, FS, method="wiener"),
        "generate_signal_chirp": lambda m: m.generate_signal(
            "chirp", FS, 0.05, 500.0),
        "generate_signal_sine": lambda m: m.generate_signal(
            "sine", FS, 0.05, 700.0),
        "generate_calibration_signal":
            lambda m: m.generate_calibration_signal(FS, 0.1, "chirp", 300,
                                                    3000),
        "generate_calibration_impulse":
            lambda m: m.generate_calibration_signal(FS, 0.05, "impulse"),
        "analyze_calibration": lambda m: m.analyze_calibration(recs, calib,
                                                               FS),
    }


def _flatten(x):
    """Numbers and arrays out of the nested tuples, lists and dicts the
    functions return, in order."""
    if isinstance(x, dict):
        return [v for k in sorted(x, key=str) for v in _flatten(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _flatten(item)]
    return [np.asarray(x, float)]


@pytest.mark.parametrize("name", sorted(_calls()))
def test_deterministic_functions_match_jax(name):
    fn = _calls()[name]
    want = fn(jc)
    got = fn(_on_cpu(tc))
    assert type(got) is type(want) or isinstance(want, np.ndarray)
    flat_w, flat_g = _flatten(want), _flatten(got)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape
        _close(g, w)


class _on_cpu:
    """The port's compat module with ``device='cpu'`` on every call."""

    def __init__(self, module):
        self._m = module

    def __getattr__(self, name):
        fn = getattr(self._m, name)
        return lambda *a, **k: fn(*a, **k, **CPU)


def test_image_sources_match_jax():
    planes = [{"plane": [1, 0, 0, -5], "material": "wood"},
              {"plane": [0, 1, 0, -4], "material": "air"}]
    for props, order in ((material_properties, 2), (PHYSICAL, 2)):
        want = jc.generate_image_sources_iterative(
            [0.5, 0.5, 0.5], planes, order, 1000.0, props, MICS)
        got = tc.generate_image_sources_iterative(
            [0.5, 0.5, 0.5], planes, order, 1000.0, props, MICS, **CPU)
        assert [g["material"] for g in got] == [w["material"] for w in want]
        for g, w in zip(got, want):
            _close(g["source"], w["source"])
    assert len(got) > 0


def test_reflect_rejects_a_degenerate_plane():
    with pytest.raises(ValueError, match="normal vector"):
        tc.reflect_point_across_plane([0, 0, 0], [0, 0, 0, 1], **CPU)
    with pytest.raises(ValueError, match="weights"):
        tc.equations([0, 0, 0], MICS, PAIRS, TD, 343.0, weights=[1.0], **CPU)
    with pytest.raises(ValueError, match="critical frequencies"):
        tc.noise_reduction(np.zeros(400), 4000.0, **CPU)


def test_read_audio_files_matches_jax(tmp_path):
    from pyaudiolocalization_tpu.utils.audio_io import write_wav
    rng = np.random.default_rng(3)
    paths = []
    for k, fs in enumerate((16000, 11025)):
        paths.append(str(tmp_path / f"m{k}.wav"))
        write_wav(paths[-1], 0.5 * rng.standard_normal(int(fs * 0.05)), fs)
    for g, w in zip(tc.read_audio_files(paths, FS, **CPU),
                    jc.read_audio_files(paths, FS)):
        _close(g, w)


# ---------------------------------------------------------------------------
# Random functions: the JAX draws fed in, and the port's seeded draws.
# ---------------------------------------------------------------------------

def test_pink_noise_and_speech_from_the_draws():
    n = 400
    white = np.asarray(jax.random.normal(_jax_key(0, 0), (n,), jnp.float64))
    want = jc.generate_pink_noise(4000.0, 0.1)
    _close(tsig._pink_from_white(torch.tensor(white), 4000.0), want)
    got = tc.generate_pink_noise(4000.0, 0.1, **CPU)
    gen = torch.Generator().manual_seed(0)
    _close(got, tsig._pink_from_white(torch.randn(n, generator=gen), 4000.0))
    tc.seed(0)
    speech = tc.generate_realistic_speech(4000.0, 0.5, **CPU)
    assert speech.shape == jc.generate_realistic_speech(4000.0, 0.5).shape
    _close(speech, tsig.realistic_speech(torch.Generator().manual_seed(0),
                                         4000.0, 2000, 0.5))
    assert np.max(np.abs(speech)) == pytest.approx(1.0)
    noise = tc.generate_signal("noise", FS, 0.05, 0.0, **CPU)
    assert noise.shape == (400,)


def test_seed_restarts_the_stream():
    tc.seed(7)
    a = tc.generate_signal("noise", FS, 0.05, 0.0, **CPU)
    b = tc.generate_signal("noise", FS, 0.05, 0.0, **CPU)
    tc.seed(7)
    np.testing.assert_array_equal(tc.generate_signal("noise", FS, 0.05, 0.0,
                                                     **CPU), a)
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("n1,n2", [(600, 600), (300, 213)])
def test_bootstrap_from_the_jax_draws(n1, n2):
    """The exact length n1 + n2 - 1 (the route K7 takes on a card): the
    JAX layer's permuted rows through the port's null within 1e-12; the
    port's layer equals its null on its own seeded draws; both nulls'
    thresholds within 10 % (Monte-Carlo spread of 200 draws)."""
    a, b = _pair(max(n1, n2))
    a, b = a[:n1], b[:n2]
    want = jc.bootstrap_significance(a, b, FS, num_bootstrap=200)
    rows = _jax_permuted_rows(_jax_key(0, 0), b, 200)
    fed = ttdoa.bootstrap_threshold(torch.tensor(a), torch.tensor(rows),
                                    n1 + n2 - 1)
    assert abs(float(fed) - want) < 1e-12
    got = tc.bootstrap_significance(a, b, FS, num_bootstrap=200, **CPU)
    own = ttdoa.bootstrap_threshold(
        torch.tensor(a), ttdoa.permuted_rows(
            torch.tensor(b), 200, torch.Generator().manual_seed(0)),
        n1 + n2 - 1)
    assert got == float(own)
    assert abs(got - want) < 0.1 * want


def test_significance_tests_match_jax():
    """perform_significance_test(_bootstrap) and the metric dict: SNR and
    peak-to-peak equal to 1e-9, the significance calls equal (the peak is
    far above either null)."""
    a, b = _pair(800, 9)
    corr = jc.phat_correlation(a, b)
    for name, args in (
            ("perform_significance_test_bootstrap", (a, b, FS)),
            ("perform_significance_test", (corr, a, b, FS)),
            ("compute_cross_correlation_metrics", (corr, a, b, FS))):
        want = getattr(jc, name)(*args)
        got = getattr(tc, name)(*args, **CPU)
        for g, w in zip(_flatten(got), _flatten(want)):
            _close(g, w)
    noise = np.random.default_rng(9).standard_normal(800)
    snr, significant = tc.perform_significance_test(
        tc.phat_correlation(a, noise, **CPU), a, noise, FS, **CPU)
    assert not significant


def _jax_seeds_for_k(points, key, k):
    seeds = np.asarray(jcl.kmeans(jnp.asarray(points), k,
                                  jax.random.fold_in(key, k), iters=0).centers)
    return [int(np.flatnonzero(np.all(points == s, -1))[0]) for s in seeds]


@pytest.mark.parametrize("method", ["kmeans", "dbscan"])
def test_optimal_cluster_count_matches_jax(method):
    """k-means with the JAX package's seeds of each k (fold_in(key, k))
    fed in; DBSCAN is deterministic."""
    rng = np.random.default_rng(5)
    points = np.concatenate([rng.normal(c, 0.05, (6, 3)) for c in
                             ((0, 0, 0), (1, 1, 0), (0, 2, 2))])
    key = _jax_key(0, 0)
    want = jc.determine_optimal_number_of_clusters(points, method=method,
                                                   eps=0.2)
    seeds = ({k: _jax_seeds_for_k(points, key, k) for k in range(2, 6)}
             if method == "kmeans" else None)
    got = tsol.optimal_cluster_count(
        torch.tensor(points), torch.ones(len(points), dtype=torch.bool),
        None, method=method, eps=0.2, seed_indices=seeds)
    assert got == want == 3
    assert tc.determine_optimal_number_of_clusters(
        points, method=method, eps=0.2, **CPU) == 3
    assert tc.determine_optimal_number_of_clusters([[1.0, 2.0, 3.0]],
                                                   **CPU) == 1
    with pytest.raises(ValueError, match="clustering method"):
        tc.determine_optimal_number_of_clusters(points, method="bogus", **CPU)


def test_heuristic_initialization_kmeans():
    """The k-means guesses on the port's own draws are the solver's on the
    same seeded generator; both layers append the mic centroid."""
    got = tc.heuristic_initialization_adaptive(MICS, PAIRS, TD, 343.0, **CPU)
    want = jc.heuristic_initialization_adaptive(MICS, PAIRS, TD, 343.0)
    g, v = tsol.heuristic_initial_guesses(
        torch.tensor(MICS), tuple(p[0] for p in PAIRS),
        tuple(p[1] for p in PAIRS), torch.tensor(TD), 343.0,
        torch.Generator().manual_seed(0))
    _close(got, g.numpy()[v.numpy()])
    centroid = np.mean(MICS, 0).tolist()
    assert any(np.allclose(x, centroid) for x in got)
    assert any(np.allclose(x, centroid) for x in want)


def test_simulate_calibration_recording():
    """Noise-free recordings equal the JAX layer's within 1e-9; with noise
    the recordings are the clean ones plus noise_level times the port
    generator's normal draws."""
    calib = jc.generate_calibration_signal(FS, 0.1)
    src = [0.5, 0.5, 0.5]
    want = jc.simulate_calibration_recording(calib, MICS, src, FS, 343.0,
                                             noise_level=0.0,
                                             material_properties=PHYSICAL)
    got = tc.simulate_calibration_recording(calib, MICS, src, FS, 343.0,
                                            noise_level=0.0,
                                            material_properties=PHYSICAL,
                                            **CPU)
    for g, w in zip(got, want):
        _close(g, w)
    tc.seed(4)
    noisy = tc.simulate_calibration_recording(calib, MICS, src, FS, 343.0,
                                              noise_level=0.1,
                                              material_properties=PHYSICAL,
                                              **CPU)
    clean = tc.simulate_calibration_recording(calib, MICS, src, FS, 343.0,
                                              noise_level=0.0,
                                              material_properties=PHYSICAL,
                                              **CPU)
    draws = torch.randn((4, len(calib)),
                        generator=torch.Generator().manual_seed(4)).numpy()
    _close(np.stack(noisy), np.stack(clean) + 0.1 * draws)


def test_reexports_and_device_default(monkeypatch):
    for name in ("localize_sound_source", "simulate_signals_with_multipath",
                 "run_calibration", "plot_correlation_heatmap",
                 "plot_correlation_3d", "plot_calibration_results",
                 "MaterialTable"):
        assert callable(getattr(tc, name))
    assert tc.material_properties == material_properties
    public = [n for n in dir(jc) if not n.startswith("_")
              and callable(getattr(jc, n))
              and getattr(getattr(jc, n), "__module__", "") ==
              "pyaudiolocalization_tpu.compat"]
    assert all(callable(getattr(tc, n, None)) for n in public), public
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.speed_of_sound(20.0, 50.0)

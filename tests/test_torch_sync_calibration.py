"""The pre-sync (models/sync.py), the cubic-spline refinement it uses
(ops/interp.py) and the calibration subsystem (models/calibration.py) of
the port against the JAX package (float64).  The recordings' noise comes
from different generators, so the analysis is compared on recordings drawn
on the JAX side, and the port's own ``run_calibration`` is held to what
the reference's calibration gives with the default materials (SURVEY.md
Q2: noise only, every SNR below the gate).  Tolerances are stated per
test."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.interpolate
import scipy.signal
import torch

import pyaudiolocalization_tpu as jpkg
from pyaudiolocalization_tpu.models import calibration as jcal
from pyaudiolocalization_tpu.models import sync as jsync
from pyaudiolocalization_tpu.ops import interp as jinterp
from pyaudiolocalization_tpu_torch.models import calibration as tcal
from pyaudiolocalization_tpu_torch.models import sync as tsync
from pyaudiolocalization_tpu_torch.ops import interp as tinterp

F64 = torch.float64
FS = 8000.0


def _config():
    cfg = copy.deepcopy(jpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25)
    return cfg


# ---------------------------------------------------------------------------
# ops/interp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 5, 8])
def test_cubic_spline_matches_jax_and_scipy(n):
    """Coefficients and values within 1e-12 (a dense solve of the same
    system); the values also match scipy's not-a-knot CubicSpline."""
    rng = np.random.default_rng(n)
    x = np.cumsum(rng.uniform(0.5, 1.5, n))
    y = rng.standard_normal(n)
    t = np.linspace(x[0] - 0.5, x[-1] + 0.5, 37)
    want = jinterp.cubic_spline_coeffs(jnp.asarray(x), jnp.asarray(y))
    got = tinterp.cubic_spline_coeffs(torch.tensor(x), torch.tensor(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    vals = tinterp.cubic_spline_eval(torch.tensor(x), got, torch.tensor(t))
    np.testing.assert_allclose(
        vals.numpy(), np.asarray(jinterp.cubic_spline_eval(
            jnp.asarray(x), want, jnp.asarray(t))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(vals.numpy(),
                               scipy.interpolate.CubicSpline(x, y)(t),
                               rtol=0, atol=1e-10)


def test_refine_peak_cubic_matches_jax_over_a_batch():
    """A batch of 5-sample windows against the JAX function window by
    window: the same one of the 100 fine points (the two libraries'
    linspace differ in the last place, hence 1e-12)."""
    rng = np.random.default_rng(0)
    windows = rng.standard_normal((9, 5))
    windows[:, 2] += 3.0
    centres = rng.integers(2, 500, 9).astype(float)
    got = tinterp.refine_peak_cubic(torch.tensor(windows),
                                    torch.tensor(centres))
    want = [float(jinterp.refine_peak_cubic(jnp.asarray(w), c))
            for w, c in zip(windows, centres)]
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=0,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# models/sync
# ---------------------------------------------------------------------------

def _delayed_set(lengths=(1200, 1200, 1200, 1200), lags=(0.0, 3.4, -7.7, 12.2),
                 seed=0):
    """Fractionally delayed copies of one noise burst (JAX's
    fractional_delay), with a little independent noise."""
    from pyaudiolocalization_tpu.ops import delay as jdelay
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(max(lengths))
    out = []
    for n, lag in zip(lengths, lags):
        sig = np.asarray(jdelay.fractional_delay(jnp.asarray(base), lag / FS,
                                                 FS))[:n]
        out.append(sig + 0.01 * rng.standard_normal(n))
    return out


@pytest.mark.parametrize("interp", [True, False])
@pytest.mark.parametrize("lengths", [(1200,) * 4, (1200, 1100, 1250, 900)])
def test_synchronize_signals_matches_jax(interp, lengths):
    """Shifts before rounding within 1e-9 samples (they decide the pads),
    then the aligned signals equal: same pads, same lengths, values within
    1e-12."""
    sigs = _delayed_set(lengths)
    width = max(lengths)
    stacked = np.stack([np.pad(s, (0, width - len(s))) for s in sigs])
    want_shift = np.asarray(jsync._sync_shifts(jnp.asarray(stacked), FS,
                                               interp))
    got_shift = tsync._sync_shifts(torch.tensor(stacked), FS, interp)
    np.testing.assert_allclose(got_shift.numpy(), want_shift, rtol=0,
                               atol=1e-9)
    assert np.any(np.abs(want_shift) > 1)
    want = jsync.synchronize_signals([jnp.asarray(s) for s in sigs], FS,
                                     use_interpolation=interp)
    got = tsync.synchronize_signals([torch.tensor(s) for s in sigs], FS,
                                    use_interpolation=interp)
    assert [g.shape[-1] for g in got] == [w.shape[-1] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)


def test_sync_gates_match_jax():
    """The 50 ms cap and the 0.3 x autocorrelation confidence gate: a
    shift beyond 50 ms and a weak signal's shift as JAX gives them."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal(3000)
    far = np.roll(base, 450)           # 450 samples > 50 ms at 8 kHz
    weak = 0.05 * np.roll(base, 9) + 0.5 * rng.standard_normal(3000)
    stacked = np.stack([base, far, weak])
    want = np.asarray(jsync._sync_shifts(jnp.asarray(stacked), FS, True))
    got = tsync._sync_shifts(torch.tensor(stacked), FS, True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    # The cap zeroes the far shift; the weak peak is not refined.
    assert want[1] == 0.0 and want[2] == round(want[2])


# ---------------------------------------------------------------------------
# models/calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["chirp", "impulse"])
def test_calibration_signal_matches_jax(kind):
    """Within 1e-12 (the same closed form)."""
    want = jcal.generate_calibration_signal(FS, 0.25, kind,
                                            dtype=jnp.float64)
    got = tcal.generate_calibration_signal(FS, 0.25, kind, dtype=F64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError, match="chirp"):
        tcal.generate_calibration_signal(FS, 0.25, "square")


def test_full_cross_correlation_matches_jax_and_scipy():
    """scipy.signal.correlate(mode='full') semantics, within 1e-10."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 700))
    b = rng.standard_normal(650)
    got = tcal.full_cross_correlation(torch.tensor(a), torch.tensor(b))
    want = np.asarray(jcal.full_cross_correlation(jnp.asarray(a),
                                                  jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.numpy()[1],
                               scipy.signal.correlate(a[1], b, mode="full"),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("signal", [False, True])
def test_analyze_calibration_matches_jax_on_its_recordings(signal):
    """Recordings drawn on the JAX side (noise only with the default
    materials, Q2; with a louder clean copy, a matched peak): delays equal
    (the same lag sample), amplitudes and SNR within 1e-9 relative."""
    cfg = _config()
    calib = jcal.generate_calibration_signal(FS, 0.25, dtype=jnp.float64)
    mics = jnp.asarray(cfg["mic_positions"], jnp.float64)
    rec = jcal.simulate_calibration_recording(
        calib, mics, jnp.asarray(cfg["source_position"], jnp.float64), FS,
        343.6, jax.random.PRNGKey(2))
    rec = np.asarray(rec)
    if signal:
        rec = rec + np.stack([np.roll(np.asarray(calib), k)
                              for k in (3, 5, 8, 13)])
    want = jcal.analyze_calibration(jnp.asarray(rec), calib, FS)
    got = tcal.analyze_calibration(torch.tensor(rec),
                                   torch.tensor(np.asarray(calib)), FS)
    np.testing.assert_array_equal(got.delays.numpy(),
                                  np.asarray(want.delays))
    np.testing.assert_allclose(got.amplitudes.numpy(),
                               np.asarray(want.amplitudes), rtol=1e-9)
    np.testing.assert_allclose(got.snr.numpy(), np.asarray(want.snr),
                               rtol=1e-9)
    assert (got.snr.numpy() > tcal.CALIBRATION_SNR_GATE).all() == signal


def test_calibration_recording_matches_jax_without_noise():
    """With noise_level 0 the recordings are the delayed, attenuated
    calibration signal (the exact 2N render) within 1e-12 of its peak; the
    noise is noise_level times the generator's standard normals."""
    cfg = _config()
    calib = jcal.generate_calibration_signal(FS, 0.25, dtype=jnp.float64)
    args = (cfg["mic_positions"], cfg["source_position"], FS, 343.6)
    props = {"air": {"absorption": 0.01, "freq": 1e-6}}
    table = jpkg.MaterialTable.from_dict(props)
    want = np.asarray(jcal.simulate_calibration_recording(
        calib, jnp.asarray(args[0], jnp.float64),
        jnp.asarray(args[1], jnp.float64), FS, 343.6, jax.random.PRNGKey(0),
        noise_level=0.0, absorption_table=jnp.asarray(table.absorption),
        freq_table=jnp.asarray(table.freq)))
    t_calib = torch.tensor(np.asarray(calib))
    got = tcal.simulate_calibration_recording(
        t_calib, *args, torch.Generator().manual_seed(0), noise_level=0.0,
        absorption_table=table.absorption, freq_table=table.freq)
    scale = float(np.abs(want).max())
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * scale)
    noisy = tcal.simulate_calibration_recording(
        t_calib, *args, torch.Generator().manual_seed(5), noise_level=0.5,
        absorption_table=table.absorption, freq_table=table.freq)
    z = torch.randn(got.shape, generator=torch.Generator().manual_seed(5),
                    dtype=F64)
    np.testing.assert_allclose((noisy - got).numpy(), 0.5 * z.numpy(),
                               rtol=0, atol=1e-12)


def test_run_calibration_has_the_reference_shape_and_q2_properties():
    """The port's own run_calibration (its generator, not JAX's): one
    {'delay', 'amplitude', 'snr'} entry a mic, delays within the
    correlation's lag range, and every SNR below the gate — the default
    materials leave the recordings signal-free (Q2), as the JAX package's
    (checked on the same config)."""
    cfg = _config()
    results, signal, recordings = tcal.run_calibration(cfg, device="cpu",
                                                       dtype=F64)
    assert len(results) == 4 and signal.shape == (2000,)
    assert recordings.shape == (4, 2000)
    assert all(set(r) == {"delay", "amplitude", "snr"} for r in results)
    assert all(abs(r["delay"]) < 0.25 for r in results)
    assert all(r["snr"] < tcal.CALIBRATION_SNR_GATE for r in results)
    jres, _, _ = jpkg.run_calibration(cfg, dtype=jnp.float64)
    assert all(r["snr"] < jcal.CALIBRATION_SNR_GATE for r in jres)
    again, _, _ = tcal.run_calibration(cfg, device="cpu", dtype=F64)
    assert again == results
    assert tpkg_exports_run_calibration()


def tpkg_exports_run_calibration():
    import pyaudiolocalization_tpu_torch as tpkg
    return (tpkg.run_calibration is tcal.run_calibration
            and "run_calibration" in tpkg.__all__
            and "simulate_signals_with_multipath" in tpkg.__all__)

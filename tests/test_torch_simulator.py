"""The port's scene simulator against the JAX package: path geometry, the
host delay budget and the whole physical-mode render (float64, rtol 1e-7),
and kernel K3's plain twin against the TPU render kernel run in Pallas
interpret mode (float32; see that test for its bounds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import acoustics as jac
from pyaudiolocalization_tpu.models import simulator as jsim
from pyaudiolocalization_tpu.ops import pallas_fft as pf
from pyaudiolocalization_tpu.ops.delay import fade_window as jfade
from pyaudiolocalization_tpu.utils.config import DEFAULT_CONFIG
from pyaudiolocalization_tpu.utils.materials import MaterialTable
from pyaudiolocalization_tpu_torch.models import acoustics as tac
from pyaudiolocalization_tpu_torch.models import simulator as tsim
from pyaudiolocalization_tpu_torch.ops import cuda_fft
from pyaudiolocalization_tpu_torch.ops.delay import fade_window as tfade

F64 = torch.float64
MICS = np.array(DEFAULT_CONFIG["mic_positions"], float)
PLANES = np.array([[1, 0, 0, -5], [0, 1, 0, -5], [0, 0, 1, -5.0]])
PHYSICAL = MaterialTable.from_dict({
    "air": {"absorption": 0.01, "freq": 1e-6},
    "wood": {"absorption": 0.05, "freq": 2e-6},
    "metal": {"absorption": 0.1, "freq": 1e-6}})


def _close(got, want, rtol=1e-7, atol_scale=1e-9):
    want = np.asarray(want)
    atol = atol_scale * max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("physical", [False, True])
def test_scene_paths_match_jax(physical):
    table = PHYSICAL if physical else MaterialTable.from_dict(None)
    ids = np.array([1, 2, 1])
    src = np.array([0.2, 0.6, 0.4])
    c = 343.0
    jimg = jac.image_sources(jnp.asarray(src), jnp.asarray(PLANES),
                             jnp.asarray(ids), jnp.asarray(MICS), 1000.0,
                             jnp.asarray(table.absorption),
                             jnp.asarray(table.freq), 2, 0.01)
    want = jsim.scene_paths(jnp.asarray(src), jnp.asarray(MICS), c, 1000.0,
                            jimg, jnp.asarray(table.absorption),
                            jnp.asarray(table.freq))
    timg = tac.image_sources(torch.from_numpy(src), torch.from_numpy(PLANES),
                             torch.from_numpy(ids), torch.from_numpy(MICS),
                             1000.0, torch.from_numpy(table.absorption),
                             torch.from_numpy(table.freq), 2, 0.01)
    got = tsim.scene_paths(torch.from_numpy(src), torch.from_numpy(MICS), c,
                           1000.0, timg, torch.from_numpy(table.absorption),
                           torch.from_numpy(table.freq))
    _close(got.delays, want.delays)
    _close(got.gains, want.gains)


def test_static_delay_budget_matches_jax():
    for src, order in [([0.5, 0.5, 0.5], 3), ([0.2, 0.6, 0.4], 1)]:
        for fs in (8000.0, 44100.0):
            assert tsim.static_delay_budget(src, MICS, PLANES, order, fs) == \
                jsim.static_delay_budget(src, MICS, PLANES, order, fs)


@pytest.mark.parametrize("kind,physical", [("chirp", True), ("sine", False)])
def test_simulate_signals_fast_matches_jax(kind, physical):
    table = PHYSICAL if physical else MaterialTable.from_dict(None)
    args = ([0.2, 0.6, 0.4], MICS, 8000.0, 343.0, 0.25, kind, 700.0, PLANES,
            np.array([1, 2, 1]), table.absorption, table.freq, 1, 0.01)
    want = jsim.simulate_signals_fast(*args, key=jax.random.PRNGKey(0),
                                      dtype=jnp.float64)
    got = tsim.simulate_signals_fast(*args, dtype=F64)
    assert got.shape == (4, 2000) and got.dtype == F64
    _close(got, want)


def test_render_plain_matches_tpu_kernel_interpret():
    """K3's plain twin against bfly_delay_sum in interpret mode (f32).

    The TPU kernel synthesizes its ramp phases in float32, which costs it
    5e-6..2e-5 of the row peak against a float64 render at these delays
    (its own oracle test, test_pallas_fft.py, allows 5e-5).  The port's
    twin reduces the phase in float64, so it is held to the float64 render
    at 1e-6 of the peak and to the TPU kernel at the TPU kernel's own 5e-5.
    """
    rng = np.random.default_rng(7)
    fs, nfft, total, out = 8000.0, 2048, 1800, 1500
    base = np.zeros(total, np.float32)
    base[:out] = rng.standard_normal(out)
    d = rng.uniform(0.0, 0.03, (3, 4)).astype(np.float32)
    g = rng.uniform(0.1, 1.0, (3, 4)).astype(np.float32)
    tau = torch.from_numpy(d) * fs
    for finalize in (False, True):
        want = np.asarray(pf.bfly_delay_sum(
            jnp.asarray(base), jnp.asarray(d), jnp.asarray(g), fs, nfft, out,
            fade=jfade(total, dtype=jnp.float32)[:out], finalize=finalize,
            interpret=True))
        got = cuda_fft.delay_sum(
            torch.from_numpy(base), tau, torch.from_numpy(g), nfft, out,
            tfade(total, dtype=torch.float32)[:out], finalize).numpy()
        exact = cuda_fft.delay_sum(
            torch.from_numpy(base).double(), tau.double(),
            torch.from_numpy(g).double(), nfft, out,
            tfade(total, dtype=F64)[:out], finalize).numpy()
        scale = float(np.max(np.abs(exact)))
        assert float(np.max(np.abs(got - exact))) < 1e-6 * scale
        assert float(np.max(np.abs(got - want))) < 5e-5 * scale


def test_render_noise_branch_not_ported():
    """The noise branch is ported now; it needs the scene seeds with the
    SNR and refuses one without the other."""
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="snr_db"):
        cuda_fft.delay_sum(x, torch.zeros(2, 1), torch.ones(2, 1), 64, 64,
                           torch.ones(64), True, snr_db=torch.tensor(20.0))
    with pytest.raises(ValueError, match="snr_db"):
        cuda_fft.delay_sum(x, torch.zeros(2, 1), torch.ones(2, 1), 64, 64,
                           torch.ones(64), True,
                           seeds=torch.zeros(2, dtype=torch.int32))

"""The port's beamformed extraction (models/beamformer.py's extraction
half) against the JAX package in float64 on the CPU: delay-and-sum, the
alignment, the sqrt-Hann STFT / WOLA pair, the tap stacking, the MVDR and
LCMV weights and ``extract_source_mvdr``, on the 8-mic cube at 16 kHz x
0.25 s with signals from the JAX package's ``simulate_signals_fast``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.models import beamformer as jbf
from pyaudiolocalization_tpu.models.simulator import simulate_signals_fast
from pyaudiolocalization_tpu_torch.models import beamformer as tbf

CUBE = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                 [0.0, 0.0, 1.0], [1.0, 1.0, 0.0], [1.0, 0.0, 1.0],
                 [0.0, 1.0, 1.0], [1.0, 1.0, 1.0]])
FS = 16000.0
C = 343.0
TARGET = np.array([0.3, 0.6, 0.4])
INTERFERER = np.array([0.8, 0.2, 0.75])


def _sim(pos, key, signal_type="noise", freq=500.0, duration=0.25):
    return np.array(simulate_signals_fast(
        pos, CUBE, FS, C, duration, signal_type, freq, None, None,
        jnp.asarray([0.01]), jnp.asarray([1e-6]), 0, 1e-4,
        key=jax.random.PRNGKey(key)))


@pytest.fixture(scope="module")
def mix():
    """(target alone, interferer alone at the target's variance) on the
    cube, both (8, 4000) float64."""
    s = _sim(TARGET, 5000)
    i = _sim(INTERFERER, 6000, "sine", 1000.0)
    return s, i * np.sqrt(np.var(s) / np.var(i))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5, 1.0, 3.0, 1.0,
                                            0.0, 1.5]])
def test_extract_source_matches_jax(mix, weights):
    sig = mix[0] + mix[1]
    want = jbf.extract_source(jnp.asarray(sig), CUBE, TARGET, FS, C,
                              mic_weights=None if weights is None
                              else jnp.asarray(weights))
    got = tbf.extract_source(sig, CUBE, TARGET, FS, C, mic_weights=weights,
                             device="cpu")
    assert got.shape == (sig.shape[-1],) and got.dtype == torch.float64
    _close(got, want, 1e-9, 1e-12)


def test_extract_source_takes_leading_axes(mix):
    """(..., M, N) -> (..., N): a stack of captures gives each capture's
    extraction."""
    sig = np.stack([mix[0], mix[1]])
    got = tbf.extract_source(sig, CUBE, TARGET, FS, C, device="cpu")
    for k in range(2):
        _close(got[k], jbf.extract_source(jnp.asarray(sig[k]), CUBE, TARGET,
                                          FS, C), 1e-9, 1e-12)


def test_align_to_position_matches_jax(mix):
    sig = mix[0] + mix[1]
    want = jbf.align_to_position(jnp.asarray(sig), CUBE, TARGET, FS, C)
    got = tbf.align_to_position(sig, CUBE, TARGET, FS, C, device="cpu")
    _close(got, want, 1e-9, 1e-12)


@pytest.mark.parametrize("frame,hop", [(256, 64), (512, 256)])
def test_stft_wola_reconstructs_the_interior(frame, hop):
    x = np.random.default_rng(41).standard_normal((2, 3001))
    spec = tbf.stft_analysis(torch.from_numpy(x), frame, hop)
    _close(spec, jbf.stft_analysis(jnp.asarray(x), frame, hop), 1e-9, 1e-9)
    back = tbf.wola_synthesis(spec, frame, hop, x.shape[-1])
    assert back.shape == x.shape
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-12)
    _close(back, jbf.wola_synthesis(jnp.asarray(spec.numpy()), frame, hop,
                                    x.shape[-1]), 1e-9, 1e-12)


@pytest.mark.parametrize("frame,hop", [(256, 96), (256, 256), (256, 512)])
def test_wola_layout_raises_where_jax_raises(frame, hop):
    with pytest.raises(ValueError, match="hop dividing frame") as want:
        jbf._wola_layout(1000, frame, hop)
    with pytest.raises(ValueError, match="hop dividing frame") as got:
        tbf._wola_layout(1000, frame, hop)
    assert str(got.value) == str(want.value)


def test_sqrt_hann_is_periodic():
    win = tbf._sqrt_hann(256, torch.float64)
    np.testing.assert_array_equal(win.numpy(),
                                  np.asarray(jbf._sqrt_hann(256,
                                                            jnp.float64)))
    assert not np.allclose(win.numpy() ** 2,
                           torch.hann_window(256, periodic=False,
                                             dtype=torch.float64).numpy())


@pytest.mark.parametrize("taps", [1, 3])
@pytest.mark.parametrize("valid", [True, False])
def test_stack_taps_matches_jax(mix, taps, valid):
    spec = tbf.stft_analysis(torch.from_numpy(mix[0]), 256, 64)
    got = tbf.stack_taps(spec, taps, valid)
    want = np.asarray(jbf.stack_taps(jnp.asarray(spec.numpy()), taps, valid))
    t = spec.shape[1]
    assert got.shape == (taps * 8, t - taps + 1 if valid else t, 129)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("taps", [1, 3])
def test_mvdr_weights_match_jax(mix, taps):
    aligned = tbf.align_to_position(mix[0] + mix[1], CUBE, TARGET, FS, C,
                                    device="cpu")
    spec = tbf.stack_taps(tbf.stft_analysis(aligned, 256, 64), taps, True)
    tau = np.random.default_rng(3).uniform(0.0, 2e-3, 8)
    got = tbf.mvdr_weights(spec, torch.from_numpy(tau), FS, 256, 0.3, taps)
    want = jbf.mvdr_weights(jnp.asarray(spec.numpy()), jnp.asarray(tau), FS,
                            256, 0.3, taps=taps)
    for g, w in zip(got, want):
        assert g.shape == (taps * 8, 129)
        _close(g, w, 1e-7, 1e-10 * float(np.abs(np.asarray(w)).max()))


@pytest.mark.parametrize("taps,loading", [(1, 0.3), (1, 0.1), (3, 0.3),
                                          (3, 0.1)])
def test_extract_source_mvdr_matches_jax(mix, taps, loading):
    sig = mix[0] + mix[1]
    want = np.asarray(jbf.extract_source_mvdr(
        jnp.asarray(sig), CUBE, TARGET, FS, C, loading=loading, taps=taps))
    got = tbf.extract_source_mvdr(sig, CUBE, TARGET, FS, C, loading=loading,
                                  taps=taps, device="cpu")
    assert got.shape == (sig.shape[-1],)
    _close(got, want, 1e-7, 1e-10 * np.abs(want).max())


def test_single_mic_passthrough_and_taps_error():
    x = np.random.default_rng(43).standard_normal((1, 2500))
    out = tbf.extract_source_mvdr(x, CUBE[:1], [0.4, 0.2, 0.7], FS, C,
                                  device="cpu")
    np.testing.assert_allclose(out.numpy(), x[0], rtol=0, atol=1e-8)
    with pytest.raises(ValueError, match="taps must be >= 1"):
        tbf.extract_source_mvdr(x, CUBE[:1], [0.4, 0.2, 0.7], FS, C, taps=0,
                                device="cpu")


def test_mvdr_beats_delay_and_sum_on_a_sine_interferer(mix):
    """EVALUATION.md's protocol (tools/eval_sweep.py's extraction section):
    weights adapted on the 1:1 mix, applied to each component; on a 1 kHz
    sine interferer MVDR's SIR beats delay-and-sum's by more than 10 dB and
    keeps most of the target."""
    s_only, i_only = mix
    frame, hop = 256, 64
    ds = tbf.extract_source(s_only, CUBE, TARGET, FS, C, device="cpu")
    di = tbf.extract_source(i_only, CUBE, TARGET, FS, C, device="cpu")
    s_al = tbf.align_to_position(s_only, CUBE, TARGET, FS, C, device="cpu")
    i_al = tbf.align_to_position(i_only, CUBE, TARGET, FS, C, device="cpu")
    wr, wi = tbf.mvdr_weights(
        tbf.stack_taps(tbf.stft_analysis(s_al + i_al, frame, hop), 1, True),
        torch.zeros(8, dtype=torch.float64), FS, frame, 0.3)

    def apply(al):
        y = tbf.apply_weights(wr, wi, tbf.stft_analysis(al, frame, hop))
        return tbf.wola_synthesis(y, frame, hop, s_only.shape[-1])

    so, io = apply(s_al), apply(i_al)
    das_db = 10 * np.log10(float(torch.var(ds) / torch.var(di)))
    mvdr_db = 10 * np.log10(float(torch.var(so) / torch.var(io)))
    gain = float(torch.var(so) / torch.var(ds))
    assert mvdr_db > das_db + 10.0, (das_db, mvdr_db)
    assert gain > 0.8, gain

"""The port's IIR filters (ops/filters.py) against the JAX package's on the
same inputs, float64, within 1e-10 of the output's peak: the direct-form
``butter_bandpass`` design, ``lfilter`` by the doubling scan ('prefix') and
in sample order ('scan'), with and without initial conditions, the IIR
``filtfilt``, ``sosfilt`` with its step start, ``filtfilt_sos`` by its
three methods and ``noise_reduction`` with each ``lfilter_method``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu.ops import filters as jfilt
from pyaudiolocalization_tpu_torch.ops import filters as tfilt

TOL = 1e-10
FS = 8000.0


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * float(np.max(np.abs(want))))


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("order,low,high", [(2, 0.1, 0.4), (3, 0.05, 0.5),
                                            (5, 300 / 4000, 3400 / 4000)])
def test_butter_bandpass_matches_jax(order, low, high):
    assert tfilt.butter_bandpass(order, low, high) == \
        jfilt.butter_bandpass(order, low, high)


@pytest.mark.parametrize("method", ["prefix", "scan"])
@pytest.mark.parametrize("with_zi", [False, True])
@pytest.mark.parametrize("length", [1, 7, 600])
def test_lfilter_matches_jax(method, with_zi, length):
    """A batch of rows, lengths that are not powers of two (the doubling
    scan's ragged last step) and a single sample."""
    b, a = jfilt.butter_bandpass(2, 0.1, 0.4)
    x = _signal((3, length))
    zi = _signal((3, len(a) - 1), 1) if with_zi else None
    want = jfilt.lfilter(b, a, jnp.asarray(x),
                         None if zi is None else jnp.asarray(zi),
                         method=method)
    got = tfilt.lfilter(b, a, torch.tensor(x),
                        None if zi is None else torch.tensor(zi),
                        method=method)
    _close(got, want)


def test_lfilter_fir_and_scipy():
    """A FIR ``a`` is a convolution whatever the method; the IIR doubling
    scan against scipy's sequential lfilter."""
    signal = pytest.importorskip("scipy.signal")
    x = _signal(500, 2)
    taps = jfilt.firwin_bandpass(31, 0.1, 0.6)
    zi = _signal(30, 3)
    for method in ("prefix", "scan", "conv"):
        _close(tfilt.lfilter(taps, (1.0,), torch.tensor(x), torch.tensor(zi),
                             method=method),
               jfilt.lfilter(taps, (1.0,), jnp.asarray(x), jnp.asarray(zi)))
    b, a = jfilt.butter_bandpass(3, 0.05, 0.5)
    zi = _signal(len(a) - 1, 4)
    _close(tfilt.lfilter(b, a, torch.tensor(x), torch.tensor(zi)),
           signal.lfilter(b, a, x, zi=zi)[0])


@pytest.mark.parametrize("method", ["prefix", "scan"])
def test_filtfilt_iir_matches_jax(method):
    b, a = jfilt.butter_bandpass(2, 0.1, 0.4)
    x = _signal((2, 400), 5)
    _close(tfilt.filtfilt(b, a, torch.tensor(x), method=method),
           jfilt.filtfilt(b, a, jnp.asarray(x), method=method))
    with pytest.raises(ValueError, match="padlen"):
        tfilt.filtfilt(b, a, torch.tensor(x[:, :15]), method=method)


@pytest.mark.parametrize("method", ["prefix", "scan"])
def test_sosfilt_with_a_step_start_matches_jax(method):
    sos = jfilt.butter_bandpass_sos(5, 300 / 4000, 3400 / 4000)
    x = _signal((3, 500), 6)
    for x0 in (None, x[:, :1]):
        want = jfilt.sosfilt(sos, jnp.asarray(x),
                             None if x0 is None else jnp.asarray(x0),
                             method=method)
        got = tfilt.sosfilt(sos, torch.tensor(x),
                            None if x0 is None else torch.tensor(x0),
                            method=method)
        _close(got, want)


@pytest.mark.parametrize("method", ["conv", "prefix", "scan"])
def test_filtfilt_sos_matches_jax(method):
    sos = jfilt.butter_bandpass_sos(5, 300 / 4000, 3400 / 4000)
    x = _signal((2, 800), 7)
    _close(tfilt.filtfilt_sos(sos, torch.tensor(x), method=method),
           jfilt.filtfilt_sos(sos, jnp.asarray(x), method=method))


@pytest.mark.parametrize("method", ["butterworth", "fir"])
@pytest.mark.parametrize("lfilter_method", ["conv", "prefix", "scan"])
def test_noise_reduction_lfilter_methods_match_jax(method, lfilter_method):
    x = _signal((2, 700), 8)
    _close(tfilt.noise_reduction(torch.tensor(x), FS, method=method,
                                 lfilter_method=lfilter_method),
           jfilt.noise_reduction(jnp.asarray(x), FS, method=method,
                                 lfilter_method=lfilter_method))


@pytest.mark.parametrize("method,length", [("prefix", 44100),
                                           ("scan", 4410)])
def test_float32_recurrences_are_the_float64_ones_rounded(method, length):
    """The reference's Butterworth cascade on a 44.1 kHz noise row in
    float32: the JAX package's recurrence in float32 departs from its
    float64 answer (by more than 1e-4 for the doubling scan over 1 s, by
    more than 1e-5 sample by sample); the port's float32 output is the
    float64 recurrence rounded, within 2e-6, and stays float32."""
    x = _signal(length, 10)
    exact = np.asarray(jfilt.noise_reduction(jnp.asarray(x), 44100.0,
                                             lfilter_method=method))
    jax32 = np.asarray(jfilt.noise_reduction(jnp.asarray(x, jnp.float32),
                                             44100.0,
                                             lfilter_method=method))
    port32 = tfilt.noise_reduction(torch.tensor(x, dtype=torch.float32),
                                   44100.0, lfilter_method=method)
    assert np.max(np.abs(jax32 - exact)) > (1e-4 if method == "prefix"
                                             else 1e-5)
    assert port32.dtype == torch.float32
    assert np.max(np.abs(port32.numpy() - exact)) < 2e-6

"""The CUDA kernels against their plain PyTorch twins on the card, and the
port's paths on the card against the CPU.

Marked ``cuda``: without a card every test here skips (decided inside the
``cuda`` fixture).  The file imports no jax, so it also runs on a machine
with only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

The cases above 2^20 run from ``test_torch_cuda_long.py``, a file of
their own: in one process after them, late profiler traces here lost
each call's first kernel.

Tolerances are float32's: transforms of log2(nfft) stages in the kernel
and in cuFFT, compared on values bounded by 1 (correlations, finalized
renders) or relative to the spectrum's peak (``fft_real``).  Noisy renders
add the Philox normals (same integers in kernel and twin, float32
log/cos/sqrt within a few units in the last place) times sigma <= 0.1.
"""

import copy
import json
import time

import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG, localize_sound_source
from pyaudiolocalization_tpu_torch.models import tdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
from pyaudiolocalization_tpu_torch.ops import gccphat
from pyaudiolocalization_tpu_torch.ops import noise as noise_ops
from pyaudiolocalization_tpu_torch.ops.delay import fade_window
from pyaudiolocalization_tpu_torch.parallel import (SweepSpec, localize_batch,
                                                    monte_carlo_sweep,
                                                    run_scene, sweep)


# Idle host time inside each edge of a ``_device_kernels`` trace, as
# ``tools/torch_rowdft_bench.TRACE_EDGE_S``.
TRACE_EDGE_S = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _pairs(m):
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.cuda
@pytest.mark.parametrize("m,length,nfft", [(4, 3000, 4096), (3, 1500, 2048),
                                           (5, 44100, 65536), (2, 16, 16)])
def test_gcc_all_pairs_kernel_matches_plain(cuda, m, length, nfft):
    g = _gen(cuda)
    sig = torch.randn((m, length), generator=g, device=cuda)
    pi, pj = _pairs(m)
    for band in ((300.0, 3400.0), None):
        mask = cf.band_mask(nfft, band, 8000.0, device=cuda)
        before = cf.LAUNCHES["gcc_all_pairs"]
        got = cf.gcc_all_pairs(sig, pi, pj, nfft, mask)
        assert cf.LAUNCHES["gcc_all_pairs"] == before + 1
        want = cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask)
        torch.cuda.synchronize()
        assert got.shape == (len(pi), nfft)
        assert float((got - want).abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,nfft", [
    (1, 3000, 4096), (3, 4096, 4096), (1000, 44100, 65536),
    (1, 44100, 131072), (2, 44100, 65536), (5, 100, 128), (1, 3, 4),
    (3, 600000, 1 << 20)])
def test_fft_real_kernel_matches_plain(cuda, rows, length, nfft):
    """One block (nfft <= 4096) and the four-step split up to 1024 x 1024;
    odd row counts leave the last packed row's second half zero."""
    x = torch.randn((rows, length), generator=_gen(cuda), device=cuda)
    got = cf.fft_real(x, nfft)
    want = cf.fft_real_plain(x, nfft)
    torch.cuda.synchronize()
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert float((got - want).abs().max()) < 5e-6 * float(want.abs().max())


def _device_kernels(fn, path, cycles=6):
    """Names of the device kernels that one warm call of ``fn`` runs, from
    ``torch.profiler`` traces of CUDA activity: of the traces from the
    third on, the one that records the most kernels (a process's first
    traces may miss kernels, and now and then a later trace records none
    or only some of a call's; a trace never records a kernel that did not
    run).  Each trace holds ``TRACE_EDGE_S`` of idle host time inside both
    of its edges, where a kernel can be lost (the A/B tool's
    ``TRACE_EDGE_S``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = []
    for cycle in range(cycles):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_EDGE_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_EDGE_S)
        if cycle < 2:
            continue
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        got = [e["name"] for e in events if e.get("cat") == "kernel"]
        if len(got) > len(names):
            names = got
    return names


@pytest.mark.cuda
def test_device_kernels_per_call(cuda, tmp_path):
    """The design, not just the answer: K4a runs two kernels at 65,536 (the
    four-step passes) and one at 4,096; K4b three at 65,536 (K4a's column
    pass, the row pass with the whitening, the column pass with the
    maxima, which it combines with atomics: no separate reduction) and one
    at 4,096; K6 the same with its draws made by the column pass; K3 four
    at 65,536 (the column pass over the bases, the row pass with the mixes,
    the inverse column pass, the finalize), K2 three (the column pass, the
    row pass with the cross-spectra, the column pass with the window and
    the statistics) and K5 seven (K3's and K2's without K2's separate
    signals); K10a and K10b one kernel per transform, K10c one a call.
    (Above 2^20: ``test_torch_cuda_long.py``.)"""
    from pyaudiolocalization_tpu_torch.ops import rowdft as rd
    x = torch.randn((2, 44100), generator=_gen(cuda), device=cuda)
    names = _device_kernels(lambda: cf.fft_real(x, 65536),
                            tmp_path / "k4a.json")
    assert len(names) == 2, names
    assert "fft_real_cols" in names[0] and "fft_real_rows" in names[1]
    short = x[:, :4000].contiguous()
    names = _device_kernels(lambda: cf.fft_real(short, 4096),
                            tmp_path / "small.json")
    assert len(names) == 1 and "fft_real_block" in names[0], names
    s1 = cf.fft_real(x[:1], 65536)[0].contiguous()
    names = _device_kernels(lambda: cf.bootstrap_peaks(s1, x, 65536),
                            tmp_path / "k4b.json")
    assert len(names) == 3, names
    assert ("fft_real_cols" in names[0] and "boot_rows" in names[1]
            and "boot_cols" in names[2]), names
    s1 = cf.fft_real(short[:1], 4096)[0].contiguous()
    names = _device_kernels(lambda: cf.bootstrap_peaks(s1, short, 4096),
                            tmp_path / "k4b_small.json")
    assert len(names) == 1 and "boot_block" in names[0], names
    seeds = torch.randint(-2 ** 31, 2 ** 31, (1000, 2), generator=_gen(cuda),
                          dtype=torch.int32, device=cuda)
    s1 = cf.fft_real(x[:1], 65536)[0].contiguous()
    names = _device_kernels(
        lambda: cf.noise_bootstrap_peaks(s1, seeds, 44100, 65536),
        tmp_path / "k6.json")
    assert len(names) == 3, names
    assert ("fft_real_cols" in names[0] and "NoiseLoad" in names[0]
            and "boot_rows" in names[1] and "boot_cols" in names[2]), names
    s1 = cf.fft_real(short[:1], 4096)[0].contiguous()
    names = _device_kernels(
        lambda: cf.noise_bootstrap_peaks(s1, seeds[:999], 1500, 4096),
        tmp_path / "k6_small.json")
    assert len(names) == 1 and "boot_block" in names[0], names
    base, tau, gains, snr, sd, fade = _scene_inputs(cuda, 4, 4, 1, 44356,
                                                    44100)
    pi, pj = _pairs(4)
    mask = cf.band_mask(65536, (300.0, 3400.0), 44100.0, device=cuda)
    names = _device_kernels(
        lambda: cf.delay_sum(base, tau, gains, 65536, 44100, fade, True,
                             snr, sd), tmp_path / "k3.json")
    assert len(names) == 4, names
    assert ("fft_real_cols" in names[0] and "render_rows" in names[1]
            and "render_cols" in names[2]
            and "render_finalize" in names[3]), names
    sigs = cf.delay_sum(base, tau, gains, 65536, 44100, fade, True, snr, sd)
    names = _device_kernels(
        lambda: cf.gcc_windowed(sigs, pi, pj, 65536, 6, mask),
        tmp_path / "k2.json")
    assert len(names) == 3, names
    assert ("fft_real_cols" in names[0] and "gcc_rows" in names[1]
            and "window_cols" in names[2]), names
    names = _device_kernels(
        lambda: cf.scene_windowed(base, tau, gains, pi, pj, 65536, 44100, 6,
                                  fade, mask, snr, sd), tmp_path / "k5.json")
    assert len(names) == 7, names
    assert ("render_finalize" in names[3] and "PackedLoad" in names[4]
            and "window_cols" in names[6]), names
    for n2 in (512, 1024):
        xr, xi = _planes(cuda, 8, n2)
        for kind, kernel in (("row_stages", "row_fft_kernel"),
                             ("row_dft", "row_dft_kernel")):
            for rep in (1, 3):
                names = _device_kernels(
                    lambda: getattr(rd, kind)(xr, xi, rep=rep),
                    tmp_path / f"{kind}_{n2}_{rep}.json")
                assert len(names) == rep, (kind, n2, names)
                assert all(kernel in n for n in names), names
        for kw in ({"twiddle": True}, {"conj": True, "twiddle": True,
                                       "cross": (xi, xr)}):
            names = _device_kernels(lambda: rd.lane_dft(xr, xi, **kw),
                                    tmp_path / f"lane_{n2}.json")
            assert len(names) == 1 and "lane_dft_kernel" in names[0], names
        names = _device_kernels(lambda: rd.fft_four_step(xr, "mxu"),
                                tmp_path / f"fwd_{n2}.json")
        assert len(names) == 2, names
        assert "row_dft_kernel" in names[0] and "lane_dft_kernel" in names[1]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,nfft", [
    (999, 3000, 4096), (1, 100, 128), (64, 44100, 65536), (2, 44100, 65536),
    (1000, 44100, 131072), (1, 3, 4), (3, 200000, 1 << 18),
    (3, 600000, 1 << 20)])
def test_bootstrap_peaks_kernel_matches_plain(cuda, rows, length, nfft):
    """One block (nfft <= 4096), the three launches of the split (n2 =
    256 at 65,536 and 131,072 with 2 and 1000 rows, n2 = 512 at 2^18 and
    1024 x 1024 at 2^20, whose row pass runs 512 and 1024 threads; at 2^21
    strips of 8 columns, at 2^22 8 columns and 8 rows, at 2^23 8 columns
    and 4 rows of 4,096, at 2^24 4 and 4) and, from
    ``test_torch_cuda_long.py``, 2^25 to 2^27."""
    g = _gen(cuda)
    s1 = cf.fft_real_plain(torch.randn((1, length), generator=g,
                                       device=cuda), nfft)[0].contiguous()
    x = torch.randn((rows, length), generator=g, device=cuda)
    got = cf.bootstrap_peaks(s1, x, nfft)
    want = cf.bootstrap_peaks_plain(s1, x, nfft)
    torch.cuda.synchronize()
    assert got.shape == (rows,)
    assert float((got - want).abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_samp,nfft", [(1000, 44100, 65536),
                                              (999, 1500, 4096),
                                              (3, 100, 128)])
def test_noise_bootstrap_peaks_kernel_matches_plain(cuda, rows, n_samp, nfft):
    """K6: the twin's integers are the same on the card and the CPU, and the
    kernel's peaks equal the twin's (odd draw counts; n_samp <= nfft/2 is
    the TPU kernel's pruned shape)."""
    g = _gen(cuda)
    s1 = cf.fft_real_plain(torch.randn((1, n_samp), generator=g,
                                       device=cuda), nfft)[0].contiguous()
    seeds = torch.randint(-2 ** 31, 2 ** 31, (rows, 2), generator=g,
                          dtype=torch.int32, device=cuda)
    head = seeds[:4]
    assert torch.equal(noise_ops.uniform(head, 1000).cpu(),
                       noise_ops.uniform(head.cpu(), 1000))
    before = cf.LAUNCHES["noise_bootstrap_peaks"]
    got = cf.noise_bootstrap_peaks(s1, seeds, n_samp, nfft)
    assert cf.LAUNCHES["noise_bootstrap_peaks"] == before + 1
    want = cf.noise_bootstrap_peaks_plain(s1, seeds, n_samp, nfft)
    torch.cuda.synchronize()
    assert got.shape == (rows,)
    assert float((got - want).abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_samp,nfft", [(1000, 44100, 65536),
                                              (999, 1500, 4096),
                                              (3, 100000, 131072),
                                              (2, 6000, 8192), (3, 100, 128)])
def test_noise_bootstrap_equals_bootstrap_on_its_draws(cuda, rows, n_samp,
                                                       nfft):
    """K6 runs K4b's schedules (one block up to 4096, the split above) with
    the draws made where they are read: on the same draws, made by the
    twin (``noise_ops.uniform``), its peaks are K4b's element for
    element."""
    g = _gen(cuda, 7)
    s1 = cf.fft_real_plain(torch.randn((1, n_samp), generator=g,
                                       device=cuda), nfft)[0].contiguous()
    seeds = torch.randint(-2 ** 31, 2 ** 31, (rows, 2), generator=g,
                          dtype=torch.int32, device=cuda)
    got = cf.noise_bootstrap_peaks(s1, seeds, n_samp, nfft)
    want = cf.bootstrap_peaks(s1, noise_ops.uniform(seeds, n_samp), nfft)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 44100), (3, 1025), (6, 32769), (7,)])
def test_whiten_kernel_matches_plain(cuda, shape):
    """K7 rounds as the plain float32 expression does: equal to 1e-6
    relative (the operations are the same, correctly rounded)."""
    g = _gen(cuda)
    spec = torch.complex(torch.randn(shape, generator=g, device=cuda),
                         torch.randn(shape, generator=g, device=cuda))
    spec[..., 0] = 0.0                       # a silent bin stays silent
    want = cf.whiten_plain(spec)
    got = cf.whiten(spec)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert bool((got[..., 0] == 0).all())
    own = spec.clone()
    assert cf.whiten(own, inplace=True).data_ptr() == own.data_ptr()
    assert torch.equal(own, got)


@pytest.mark.cuda
@pytest.mark.parametrize("bins", [44100, 44101, 1, 2, 3])
def test_whiten_kernel_takes_misaligned_views(cuda, bins):
    """A view that starts between two 16-byte words (``spec[..., 1:]``),
    into a new, aligned output (two 8-byte stores a pair) and in place
    (16-byte stores), and odd counts: the first bin alone, then pairs,
    then the last bin alone."""
    g = _gen(cuda, 3)
    base = torch.complex(torch.randn((1, bins + 1), generator=g, device=cuda),
                         torch.randn((1, bins + 1), generator=g, device=cuda))
    view = base[..., 1:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    want = cf.whiten_plain(view)
    got = cf.whiten(view)
    torch.cuda.synchronize()
    assert got.data_ptr() % 16 == 0
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    own = base.clone()
    cf.whiten(own[..., 1:], inplace=True)
    torch.cuda.synchronize()
    assert torch.equal(own[..., 1:], got)
    assert torch.equal(own[..., 0], base[..., 0])   # the bin before the view


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,nfft,schedule", [
    (1, 44100, 65536, 256), (3, 3000, 4096, 1), (5, 100, 128, 1),
    (2, 44100, 131072, 512), (3, 6000, 8192, 128), (4, 100, 128, 1),
    (1, 600000, 1 << 20, 1024)])
def test_whitened_corr_kernel_matches_plain(cuda, rows, length, nfft,
                                            schedule):
    """K9 on each of its schedules (``corr_schedule``): one block a packed
    row, the two launches of the split (up to 4096 x 4096, strips of 8 at
    2,048 and 4 at 4,096; to 2^26 in ``test_torch_cuda_long.py``) and the
    three-pass split's three above 2^26; odd and even row counts."""
    assert cf.corr_schedule(nfft) == schedule
    g = _gen(cuda)
    x = torch.randn((2 * rows, length), generator=g, device=cuda)
    spec = cf.fft_real(x, nfft) if nfft <= cf.FFT_SPLIT_MAX else \
        cf.fft_real_plain(x, nfft)
    a, b = spec[:rows].contiguous(), spec[rows:].contiguous()
    for band in ((300.0, 3400.0), None):
        mask = cf.band_mask(nfft, band, 8000.0, device=cuda)
        before = cf.LAUNCHES["whitened_corr"]
        got = cf.whitened_corr(a, b, mask, nfft)
        assert cf.LAUNCHES["whitened_corr"] == before + 1
        want = cf.whitened_corr_plain(a, b, mask, nfft)
        torch.cuda.synchronize()
        assert got.shape == (rows, nfft)
        assert float((got - want).abs().max()) < 1e-6


@pytest.mark.cuda
def test_options_path_on_the_card_matches_the_cpu_path(cuda):
    """Small scenes: the options (noise null, SCOT + median + FIR + DBSCAN
    + robust LM, no lag gate + adaptive + Wiener) and the single-pair
    correlation run their kernels on the card and find the CPU's TDOAs."""
    base = copy.deepcopy(DEFAULT_CONFIG)
    base.update(fs=8000, duration=0.25, source_position=[0.2, 0.6, 0.4],
                signal_type="chirp")
    base["localization"].update(lag_mode="physical", sync_mode="none",
                                max_reflections=1, num_bootstrap=64)
    options = [
        (dict(bootstrap_mode="noise"), "noise_bootstrap_peaks"),
        (dict(gcc_weighting="scot", threshold_method="median",
              filter_method="fir", clustering_method="dbscan",
              solver="lm-robust", analyze_correlation=False), "delay_sum"),
        (dict(max_expected_delay=None, threshold_method="adaptive",
              filter_method="wiener"), "gcc_all_pairs")]
    for change, kernel in options:
        cfg = copy.deepcopy(base)
        cfg["localization"].update(change)
        cpu = localize_sound_source(cfg, device="cpu", dtype=torch.float64)
        cf.reset_launches()
        card = localize_sound_source(cfg, device=cuda, dtype=torch.float32)
        assert cf.LAUNCHES[kernel] > 0, (change, cf.LAUNCHES)
        np.testing.assert_allclose(card["tdoas"], cpu["tdoas"], atol=1e-6)
    sig = torch.randn((2, 2000), generator=_gen(cuda), device=cuda)
    shifted = torch.roll(sig[0], 7)
    cf.reset_launches()
    exact = tdoa.get_time_delays_phat(sig[0], shifted, 8000.0,
                                      lag_mode="physical")
    assert cf.LAUNCHES["whiten"] == 1
    pow2 = tdoa.get_time_delays_phat(sig[0], shifted, 8000.0,
                                     lag_mode="physical", nfft=4096)
    assert cf.LAUNCHES["fft_real"] == 1 and cf.LAUNCHES["whitened_corr"] == 1
    for res in (exact, pow2):
        assert abs(float(res.delays[0]) * 8000.0 + 7) < 1e-3


@pytest.mark.cuda
def test_parity_path_on_the_card_launches_k7_and_matches_the_cpu(
        cuda, tmp_path, monkeypatch):
    """Parity mode (lag_mode='reference': the exact-length render, the
    pre-sync, the 2n - 1 transform, the exact-length bootstrap) with
    calibration delays on a small off-centre scene whose peaks are clear of
    their runners-up: on the card it launches K7 and no other kernel, and
    finds the CPU's TDOAs (1e-6 s) and position (1 mm, float32 LM)."""
    monkeypatch.chdir(tmp_path)
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25, source_position=[0.2, 0.6, 0.4])
    cfg["localization"].update(lag_mode="reference", num_bootstrap=64,
                               visualize_correlation=False)
    calibration = [{"delay": d, "amplitude": 1.0, "snr": 6.0}
                   for d in (0.001, -0.002, 0.0005, 0.0)]
    cpu = localize_sound_source(cfg, calibration_data=calibration,
                                device="cpu", dtype=torch.float64)
    cf.reset_launches()
    card = localize_sound_source(cfg, calibration_data=calibration,
                                 device=cuda, dtype=torch.float32)
    assert cf.LAUNCHES["whiten"] == 7
    assert sum(cf.LAUNCHES.values()) == 7, cf.LAUNCHES
    np.testing.assert_allclose(card["tdoas"], cpu["tdoas"], atol=1e-6)
    np.testing.assert_allclose(card["estimated_position"],
                               cpu["estimated_position"], atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,paths,total,out,nfft", [
    (4, 22, 50292, 44100, 65536), (3, 5, 3500, 3000, 4096),
    (1, 1, 100, 100, 128)])
def test_delay_sum_kernel_matches_plain(cuda, m, paths, total, out, nfft):
    g = _gen(cuda)
    base = torch.zeros(total, device=cuda)
    base[:out] = torch.randn(out, generator=g, device=cuda)
    tau = torch.rand((m, paths), generator=g, device=cuda) * (total - out)
    gains = torch.rand((m, paths), generator=g, device=cuda)
    fade = fade_window(total, dtype=torch.float32, device=cuda)[:out]
    for finalize in (True, False):
        got = cf.delay_sum(base, tau, gains, nfft, out, fade.contiguous(),
                           finalize)
        want = cf.delay_sum_plain(base, tau, gains, nfft, out, fade, finalize)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) < 1e-5 * max(scale, 1.0)


@pytest.mark.cuda
def test_delay_sum_kernel_passes_silent_rows(cuda):
    base = torch.zeros(300, device=cuda)
    tau = torch.zeros((2, 3), device=cuda)
    gains = torch.zeros((2, 3), device=cuda)
    got = cf.delay_sum(base, tau, gains, 512, 300, torch.ones(300,
                                                               device=cuda),
                       True)
    assert bool((got == 0).all())


@pytest.mark.cuda
def test_wrappers_validate_cuda_inputs(cuda):
    x = torch.randn((2, 100), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        cf.fft_real(x.double(), 128)
    with pytest.raises(ValueError, match="contiguous"):
        cf.fft_real(x.t(), 128)
    with pytest.raises(ValueError, match="power of two"):
        cf.fft_real(x, 100)
    with pytest.raises(ValueError):
        cf.gcc_all_pairs(x, [0], [2], 128, cf.band_mask(128, None, None,
                                                        device=cuda))
    with pytest.raises(ValueError, match="all on CUDA"):
        cf.bootstrap_peaks(cf.fft_real(x, 128)[0].cpu(), x, 128)


@pytest.mark.cuda
def test_gcc_leading_axes_run_k1_on_the_card(cuda):
    """PHAT at a length K1 takes, over leading axes, launches K1 once over
    every scene and equals the per-scene calls; the other weightings and
    use_pallas='never' take the unfused branch."""
    x = torch.randn((2, 3, 4, 1500), device=cuda)
    pi, pj = _pairs(4)
    before = cf.LAUNCHES["gcc_all_pairs"]
    got = gccphat.gcc_phat_all_pairs(x, pi, pj, nfft=2048)
    torch.cuda.synchronize()
    assert cf.LAUNCHES["gcc_all_pairs"] == before + 1
    assert got.shape == (2, 3, 6, 2048)
    for a in range(2):
        for b in range(3):
            one = gccphat.gcc_phat_all_pairs(x[a, b], pi, pj, nfft=2048)
            assert float((got[a, b] - one).abs().max()) < 1e-6
    for kw in (dict(weighting="scot"), dict(use_pallas="never")):
        got = gccphat.gcc_phat_all_pairs(x, pi, pj, nfft=2048, **kw)
        want = gccphat.gcc_phat_all_pairs(x.cpu(), pi, pj, nfft=2048, **kw)
        assert float((got.cpu() - want).abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,length,nfft", [
    (3, 3, 1500, 2048), (2, 5, 1000, 2048), (5, 2, 300, 512),
    (64, 8, 4000, 4096)])
def test_gcc_all_pairs_scene_axis_matches_plain(cuda, b, m, length, nfft):
    """Odd mic and pair counts (pairs packed per scene, mics across
    scenes), and 64 scenes of 8 mics (28 pairs)."""
    sig = torch.randn((b, m, length), generator=_gen(cuda), device=cuda)
    pi, pj = _pairs(m)
    mask = cf.band_mask(nfft, (300.0, 3400.0), 16000.0, device=cuda)
    got = cf.gcc_all_pairs(sig, pi, pj, nfft, mask)
    want = cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask)
    torch.cuda.synchronize()
    assert got.shape == (b, len(pi), nfft)
    assert float((got - want).abs().max()) < 1e-6


@pytest.mark.cuda
def test_gcc_all_pairs_launches_over_scene_chunks(cuda, monkeypatch):
    """A batch beyond the grid limit is launched in scene chunks (the
    limit lowered here so a small batch crosses it) on the split, whose
    grids count packed rows along y; one block a scene
    (nfft <= 4,096) has no such limit and launches once."""
    monkeypatch.setattr(cf, "_MAX_GRID_Y", 7)
    sig = torch.randn((5, 3, 200), generator=_gen(cuda), device=cuda)
    pi, pj = _pairs(3)
    for nfft, launches in ((8192, 3), (256, 1)):   # 2 + 2 + 1 scenes; one
        mask = cf.band_mask(nfft, None, None, device=cuda)
        before = cf.LAUNCHES["gcc_all_pairs"]
        got = cf.gcc_all_pairs(sig, pi, pj, nfft, mask)
        torch.cuda.synchronize()
        assert cf.LAUNCHES["gcc_all_pairs"] - before == launches
        want = cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask)
        assert float((got - want).abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,length,nfft,schedule", [
    (5, 3, 1500, 2048, 1), (512, 4, 4000, 4096, 1), (1, 8, 4000, 4096, 1),
    (3, 10, 3000, 4096, 1), (2, 12, 3000, 4096, 1), (None, 4, 44100, 65536,
                                                      256),
    (None, 4, 44100, 131072, 512), (3, 3, 6000, 8192, 128),
    (2, 8, 44100, 65536, 256), (1, 11, 44100, 65536, 256),
    (1, 3, 600000, 1 << 20, 1024)])
def test_gcc_all_pairs_schedules_match_plain(cuda, b, m, length, nfft,
                                             schedule):
    """K1 on each of its schedules (``gcc_route``'s n1): one block a
    scene (the reverberant sweep's 512 scenes, one scene of 8 mics whose
    couples spread over blocks, the odd edge of 5 scenes x 3 mics, 10
    mics), the three launches of the split (the api's one scene, whose row pass
    spreads its couples over ``gridDim.z``, no_gate's 131,072, an odd mic
    count at 8,192, 8 mics), the four through the mic rows' spectra on the
    split (11 mics at 65,536, past ``gcc_rows``; 3 mics at 2^20; a 23.7 s
    recording's 4 mics at 2^21, 2 scenes of 3 mics, 4 mics at 2^22) and
    the two through them in one block (12 mics at 4,096)."""
    assert cf.gcc_route(nfft, m).n1 == schedule
    g = _gen(cuda, 5)
    sig = torch.randn((m, length) if b is None else (b, m, length),
                      generator=g, device=cuda)
    pi, pj = _pairs(m)
    for band in ((300.0, 3400.0), None):
        mask = cf.band_mask(nfft, band, 44100.0, device=cuda)
        before = cf.LAUNCHES["gcc_all_pairs"]
        got = cf.gcc_all_pairs(sig, pi, pj, nfft, mask)
        assert cf.LAUNCHES["gcc_all_pairs"] == before + 1
        want = cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask)
        torch.cuda.synchronize()
        assert got.shape == sig.shape[:-2] + (len(pi), nfft)
        assert float((got - want).abs().max()) < 1e-6


@pytest.mark.cuda
def test_gcc_and_corr_device_kernels_per_call(cuda, tmp_path):
    """K1 runs three device kernels on the split at 65,536 and 131,072 (K4a's
    column pass, K2's row pass, the column pass that writes the
    correlations) and one in one block (4,096, up to 8 mics here); K9
    two on the split (its row pass and K1's column pass) and one in one
    block.  (2^21 and 2^22: ``test_torch_cuda_long.py``.)"""
    g = _gen(cuda, 8)
    pi, pj = _pairs(4)
    for shape, nfft in (((4, 44100), 65536), ((4, 44100), 131072),
                        ((256, 4, 44100), 65536)):
        sig = torch.randn(shape, generator=g, device=cuda)
        mask = cf.band_mask(nfft, None, None, device=cuda)
        names = _device_kernels(
            lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
            tmp_path / f"k1_{nfft}.json")
        assert len(names) == 3, names
        assert ("fft_real_cols" in names[0] and "gcc_rows" in names[1]
                and "corr_cols" in names[2]), names
    for m in (4, 8):
        sig = torch.randn((128, m, 4000), generator=g, device=cuda)
        qi, qj = _pairs(m)
        mask = cf.band_mask(4096, (300.0, 3400.0), 16000.0, device=cuda)
        names = _device_kernels(
            lambda: cf.gcc_all_pairs(sig, qi, qj, 4096, mask),
            tmp_path / f"k1_block_{m}.json")
        assert len(names) == 1 and "gcc_block" in names[0], names
    for nfft, want in ((65536, ("corr_rows", "corr_cols")),
                       (131072, ("corr_rows", "corr_cols")),
                       (4096, ("corr_block",))):
        spec = cf.fft_real(torch.randn((2, 4000), generator=g, device=cuda),
                           nfft)
        a, b = spec[:1].contiguous(), spec[1:].contiguous()
        mask = cf.band_mask(nfft, None, None, device=cuda)
        names = _device_kernels(lambda: cf.whitened_corr(a, b, mask, nfft),
                                tmp_path / f"k9_{nfft}.json")
        assert len(names) == len(want), names
        assert all(w in n for w, n in zip(want, names)), names


# K1 and K2 through the mic rows' spectra (``cuda_fft.gcc_route``):
# (scenes, mics, samples, nfft): on the split the api's 4 mics at 2^20
# (a 18 s recording at 44.1 kHz), 8 mics and 2 scenes of 6 at 2^18 (past
# ``gcc_rows``' 4) and 11 mics at 65,536; in one block 16 scenes of 16
# mics and 4 of 12 at 4,096 (the fast path's 2^21 and 2^22:
# ``test_torch_cuda_long.py``).
SPECTRA_SHAPES = [(1, 4, 800000, 1 << 20), (1, 8, 200000, 1 << 18),
                  (2, 6, 200000, 1 << 18), (1, 11, 44100, 65536),
                  (16, 16, 4000, 4096), (4, 12, 3000, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,length,nfft", SPECTRA_SHAPES)
def test_gcc_spectra_routes_match_plain(cuda, b, m, length, nfft):
    """K1 and K2 on the spectra routes, one launch each, against their
    twins: K1's correlations within 1e-6, K2's windows and statistics
    within 1e-6 with the argmax equal, with and without the band."""
    route = cf.gcc_route(nfft, m)
    assert route.kind == (cf.ROUTE_SPECTRA_BLOCK if nfft <= 4096
                          else cf.ROUTE_LONG if nfft > cf.FFT_SPLIT_MAX
                          else cf.ROUTE_SPECTRA)
    g = _gen(cuda, 20)
    sig = torch.randn((b, m, length), generator=g, device=cuda)
    pi, pj = _pairs(m)
    wq = min(21, nfft // 256)
    for band in ((300.0, 3400.0), None):
        mask = cf.band_mask(nfft, band, 44100.0, device=cuda)
        cf.reset_launches()
        got = cf.gcc_all_pairs(sig, pi, pj, nfft, mask)
        win, stats = cf.gcc_windowed(sig, pi, pj, nfft, wq, mask)
        assert cf.LAUNCHES["gcc_all_pairs"] == cf.LAUNCHES["gcc_windowed"] == 1
        want = cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask)
        assert float((got - want).abs().max()) < 1e-6
        del got, want
        w2, s2 = cf.gcc_windowed_plain(sig, pi, pj, nfft, wq, mask)
        torch.cuda.synchronize()
        assert float((win - w2).abs().max()) < 1e-6
        assert torch.equal(stats[..., 2], s2[..., 2])
        assert float((stats[..., :2] - s2[..., :2]).abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,paths,total,out,nfft,wq", [
    (3, 12, 2, 3500, 3000, 4096, 2), (1, 6, 1, 250000, 200000, 1 << 18, 8),
    (1, 4, 1, 900000, 800000, 1 << 20, 21)])
def test_scene_windowed_on_the_spectra_routes_is_k3_then_k2(
        cuda, scenes, m, paths, total, out, nfft, wq):
    """K5 where its GCC stage goes through the mic rows' spectra (12 mics
    at 4,096 in one block, 6 mics at 2^18 and 4 at 2^20 on the split,
    with the render on the split at 2^18 and through the base rows'
    spectra at 2^20): against its twin within 2e-5, and equal to K3 then
    K2 to the bit."""
    assert cf.gcc_route(nfft, m).kind in (cf.ROUTE_SPECTRA,
                                          cf.ROUTE_SPECTRA_BLOCK)
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, scenes, m,
                                                       paths, total, out)
    pi, pj = _pairs(m)
    mask = cf.band_mask(nfft, (300.0, 3400.0), 16000.0, device=cuda)
    win, stats = cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq,
                                   fade, mask, snr, seeds)
    sigs = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    w3, s3 = cf.gcc_windowed(sigs, pi, pj, nfft, wq, mask)
    w2, s2 = cf.scene_windowed_plain(base, tau, gains, pi, pj, nfft, out,
                                     wq, fade, mask, snr, seeds)
    torch.cuda.synchronize()
    assert torch.equal(win, w3) and torch.equal(stats, s3)
    assert float((win - w2).abs().max()) < 2e-5


@pytest.mark.cuda
def test_gcc_spectra_routes_device_kernels_per_call(cuda, tmp_path):
    """Through the mic rows' spectra K1 runs four device kernels on the
    split at 2^20 (K4a's two passes, ``corr_rows``, ``corr_cols``) and two
    in one block at 4,096 with 12 mics (``fft_real_block``, ``corr_block``
    with ``CorrOut``); K2 four at 2^20 (``window_cols`` last) and two at
    4,096 (``corr_block`` with ``WindowOut``); no kernel outside the
    route's (2^21: ``test_torch_cuda_long.py``)."""
    g = _gen(cuda, 21)
    for shape, nfft, wq in (((1, 4, 800000), 1 << 20, 21),
                            ((4, 12, 3000), 4096, 2)):
        sig = torch.randn(shape, generator=g, device=cuda)
        pi, pj = _pairs(shape[1])
        mask = cf.band_mask(nfft, (300.0, 3400.0), 44100.0, device=cuda)
        k1 = _device_kernels(lambda: cf.gcc_all_pairs(sig, pi, pj, nfft,
                                                      mask),
                             tmp_path / f"k1_{nfft}.json")
        k2 = _device_kernels(lambda: cf.gcc_windowed(sig, pi, pj, nfft, wq,
                                                     mask),
                             tmp_path / f"k2_{nfft}.json")
        if nfft > 4096:
            want = ("fft_real_cols", "fft_real_rows", "corr_rows")
            assert len(k1) == len(k2) == 4, (k1, k2)
            assert all(w in a and w in b for w, a, b in zip(want, k1, k2))
            assert "corr_cols" in k1[3] and "window_cols" in k2[3], (k1, k2)
            route = want + ("corr_cols", "window_cols")
        else:
            assert len(k1) == len(k2) == 2, (k1, k2)
            assert "fft_real_block" in k1[0] and "fft_real_block" in k2[0]
            assert "CorrOut" in k1[1] and "WindowOut" in k2[1], (k1, k2)
            route = ("fft_real_block", "corr_block")
        for name in k1 + k2:
            assert any(r in name for r in route), name


# K3 and K5 where the render goes through the base rows' spectra
# (``render_route``): (scenes, mics, paths, total, out, nfft, wq) of the
# fast path's one scene of 4 mics at 2^20 (chip_smoke.py's FAST_SAMPLES;
# the finish spread over the card) and 64 scenes of 4 mics at 2^20 (rows
# that fill the card: the finish one block a mic row); 2^21 and 2^22:
# ``test_torch_cuda_long.py``.
RENDER_SPECTRA = [(1, 4, 1, 900000, 800000, 1 << 20, 21),
                  (64, 4, 1, 900000, 800000, 1 << 20, 21)]


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,paths,total,out,nfft,wq", RENDER_SPECTRA)
def test_render_spectra_route_matches_plain(cuda, scenes, m, paths, total,
                                            out, nfft, wq):
    """K3 through the base rows' spectra, with the finalize and the noise
    and with neither, one launch a call: within the A/B tool's
    ``SCENE_TOL`` (2e-5; raw renders relative to their peak) of its twin;
    K2 on its signals within 1e-6 with equal argmaxes; K5 within 1e-5 of
    its twin and equal to K3 then K2 to the bit."""
    assert cf.render_route(nfft).kind == (
        cf.ROUTE_LONG if nfft > cf.FFT_SPLIT_MAX else cf.ROUTE_SPECTRA)
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, scenes, m,
                                                       paths, total, out, 21)
    pi, pj = _pairs(m)
    mask = cf.band_mask(nfft, (300.0, 3400.0), 44100.0, device=cuda)
    cf.reset_launches()
    raw = cf.delay_sum(base, tau, gains, nfft, out, fade, False)
    want = cf.delay_sum_plain(base, tau, gains, nfft, out, fade, False)
    torch.cuda.synchronize()
    assert float((raw - want).abs().max()) < 2e-5 * float(want.abs().max())
    del raw, want
    sigs = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    want = cf.delay_sum_plain(base, tau, gains, nfft, out, fade, True, snr,
                              seeds)
    torch.cuda.synchronize()
    assert sigs.shape == (scenes, m, out)
    assert float((sigs - want).abs().max()) < 2e-5
    del want
    win, stats = cf.gcc_windowed(sigs, pi, pj, nfft, wq, mask)
    w2, s2 = cf.gcc_windowed_plain(sigs, pi, pj, nfft, wq, mask)
    fused = cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq, fade,
                              mask, snr, seeds)
    torch.cuda.synchronize()
    assert (cf.LAUNCHES["delay_sum"], cf.LAUNCHES["gcc_windowed"],
            cf.LAUNCHES["scene_windowed"]) == (2, 1, 1)
    assert float((win - w2).abs().max()) < 1e-6
    assert torch.equal(stats[..., 2], s2[..., 2])
    assert torch.equal(fused[0], win) and torch.equal(fused[1], stats)
    del sigs, w2, s2
    w5, _ = cf.scene_windowed_plain(base, tau, gains, pi, pj, nfft, out, wq,
                                    fade, mask, snr, seeds)
    torch.cuda.synchronize()
    assert float((fused[0] - w5).abs().max()) < 1e-5


@pytest.mark.cuda
def test_render_spectra_route_device_kernels_per_call(cuda, tmp_path):
    """Through the base rows' spectra K3 runs K4a's two passes into the
    spectra, ``render_spec_rows`` and ``render_cols``, then the finish:
    for one scene of 4 mics spread over the card, ``finish_spread`` 4
    times with the finalize and the noise, 3 with the finalize, 2 with the
    noise, once with neither; for 64 scenes one ``render_finalize``.  K5
    runs K3's kernels, then its GCC's four.  No kernel outside the
    routes'."""
    render = ["fft_real_cols", "fft_real_rows", "render_spec_rows",
              "render_cols"]
    cases = [(1, True, True, ["finish_spread"] * 4),
             (1, True, False, ["finish_spread"] * 3),
             (1, False, True, ["finish_spread"] * 2),
             (1, False, False, ["finish_spread"]),
             (64, True, True, ["render_finalize"])]
    for scenes, finalize, noise, finish in cases:
        base, tau, gains, snr, seeds, fade = _scene_inputs(
            cuda, scenes, 4, 1, 900000, 800000)
        nz = (snr, seeds) if noise else (None, None)
        names = _device_kernels(
            lambda: cf.delay_sum(base, tau, gains, 1 << 20, 800000, fade,
                                 finalize, *nz),
            tmp_path / f"k3_{scenes}_{finalize}_{noise}.json")
        want = render + finish
        assert len(names) == len(want), names
        assert all(w in n for w, n in zip(want, names)), names
    pi, pj = _pairs(4)
    mask = cf.band_mask(1 << 20, (300.0, 3400.0), 44100.0, device=cuda)
    names = _device_kernels(
        lambda: cf.scene_windowed(base, tau, gains, pi, pj, 1 << 20, 800000,
                                  21, fade, mask, snr, seeds),
        tmp_path / "k5.json")
    want = render + ["render_finalize", "fft_real_cols", "fft_real_rows",
                     "corr_rows", "window_cols"]
    assert len(names) == len(want), names
    assert all(w in n for w, n in zip(want, names)), names
    for name in names:
        assert any(r in name for r in render + want), name


def test_wrappers_refuse_devices_other_than_cpu_and_cuda():
    x = torch.empty((2, 100), device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        cf.fft_real(x, 128)
    with pytest.raises(ValueError, match=r"\['cpu', 'meta'\]"):
        cf.whitened_corr(torch.zeros(3, dtype=torch.complex64),
                         torch.empty(3, dtype=torch.complex64,
                                     device="meta"), torch.ones(3), 4)


def test_launch_helper_guards_only_another_device(monkeypatch):
    """``_launch`` counts the launch, passes the current stream's raw
    pointer last, enters the device guard only for a device that is not
    the current one, and raises on the CUDA error the entry returns (the
    CUDA calls stubbed)."""
    entered = []

    class Guard:
        def __init__(self, index):
            entered.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "card")
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setitem(cf.LAUNCHES, "whiten", 0)
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    cf._launch("whiten", torch.device("cuda", 0), entry, 7, 8)
    assert calls == [(7, 8, 1000)] and entered == []
    cf._launch("whiten", torch.device("cuda", 1), entry, 7)
    assert calls[-1] == (7, 1001) and entered == [1]
    assert cf.LAUNCHES["whiten"] == 2
    with pytest.raises(RuntimeError, match="whiten: CUDA error 2"):
        cf._launch("whiten", torch.device("cuda", 0), lambda *args: 2)


@pytest.mark.cuda
def test_main_path_on_the_card_matches_the_cpu_path(cuda):
    """Small scene: the kernels' path (f32, cuda) and the plain path (f64,
    cpu) on the same injected signals find the same TDOAs, and every kernel
    runs."""
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25, source_position=[0.2, 0.6, 0.4],
               signal_type="chirp")
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               max_reflections=1, num_bootstrap=64)
    cpu = localize_sound_source(cfg, device="cpu", dtype=torch.float64)
    cf.reset_launches()
    card = localize_sound_source(cfg, device=cuda, dtype=torch.float32)
    path = ("fft_real", "gcc_all_pairs", "bootstrap_peaks", "delay_sum")
    assert all(cf.LAUNCHES[k] > 0 for k in path), cf.LAUNCHES
    np.testing.assert_allclose(card["tdoas"], cpu["tdoas"], atol=1e-6)
    np.testing.assert_allclose(card["estimated_position"],
                               cpu["estimated_position"], atol=1e-3)


def _scene_inputs(dev, scenes, m, paths, total, out, seed=0):
    g = _gen(dev, seed)
    base = torch.zeros((scenes, total), device=dev)
    base[:, :out] = torch.randn((scenes, out), generator=g, device=dev)
    tau = torch.rand((scenes, m, paths), generator=g, device=dev) * (
        total - out + 1)
    gains = torch.rand((scenes, m, paths), generator=g, device=dev)
    gains[..., 0] = 1.0  # the strongest path has gain 1, as in scene_paths
    snr = 20.0 + 20.0 * torch.rand(scenes, generator=g, device=dev)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (scenes, 2), generator=g,
                          dtype=torch.int32, device=dev)
    fade = fade_window(total, dtype=torch.float32, device=dev)[:out]
    return base, tau.contiguous(), gains.contiguous(), snr, seeds, \
        fade.contiguous()


@pytest.mark.cuda
def test_philox_bits_match_on_the_card(cuda):
    """The twin's integers are the same on the card and on the CPU; its
    float32 normals differ by the two libraries' last places only."""
    seeds = torch.tensor([[5, -7], [2 ** 31 - 1, -2 ** 31]],
                         dtype=torch.int32)
    k0, k1 = noise_ops.mic_keys(seeds, 3)
    t = torch.arange(1000)
    cpu = noise_ops.philox_bits(k0, k1, t)
    card = noise_ops.philox_bits(k0.to(cuda), k1.to(cuda), t.to(cuda))
    assert all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card))
    z = noise_ops.normal(seeds, 3, 1000)
    zc = noise_ops.normal(seeds.to(cuda), 3, 1000)
    assert float((z - zc.cpu()).abs().max()) < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,length,nfft,wq", [
    (1, 4, 44100, 65536, 21), (512, 4, 44100, 65536, 6),
    (2, 3, 3000, 4096, 2), (3, 5, 1500, 2048, 4), (3, 3, 6000, 8192, 2),
    (2, 5, 7000, 8192, 16), (1, 8, 44100, 65536, 6),
    (2, 4, 200000, 1 << 18, 3), (1, 4, 300000, 1 << 19, 21),
    (1, 3, 600000, 1 << 20, 4)])
def test_gcc_windowed_kernel_matches_plain(cuda, scenes, m, length, nfft,
                                           wq):
    sig = torch.randn((scenes, m, length), generator=_gen(cuda), device=cuda)
    pi, pj = _pairs(m)
    for band in ((300.0, 3400.0), None):
        mask = cf.band_mask(nfft, band, 44100.0, device=cuda)
        before = cf.LAUNCHES["gcc_windowed"]
        win, stats = cf.gcc_windowed(sig, pi, pj, nfft, wq, mask)
        assert cf.LAUNCHES["gcc_windowed"] == before + 1
        w2, s2 = cf.gcc_windowed_plain(sig, pi, pj, nfft, wq, mask)
        torch.cuda.synchronize()
        assert win.shape == (scenes, len(pi), 2 * wq * 128)
        assert float((win - w2).abs().max()) < 1e-6
        assert torch.equal(stats[..., 2], s2[..., 2])
        assert float((stats[..., :2] - s2[..., :2]).abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,paths,total,out,nfft", [
    (512, 4, 1, 44356, 44100, 65536), (1, 4, 22, 50292, 44100, 65536),
    (3, 3, 5, 3500, 3000, 4096), (512, 4, 37, 4400, 4000, 8192),
    (3, 3, 5, 7000, 6000, 8192), (2, 8, 3, 40000, 30000, 1 << 19),
    (1, 2, 2, 600000, 500000, 1 << 20)])
def test_delay_sum_noise_kernel_matches_plain(cuda, scenes, m, paths, total,
                                              out, nfft):
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, scenes, m,
                                                       paths, total, out)
    got = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    want = cf.delay_sum_plain(base, tau, gains, nfft, out, fade, True, snr,
                              seeds)
    torch.cuda.synchronize()
    assert got.shape == (scenes, m, out)
    assert float((got - want).abs().max()) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,paths,total,out,nfft,wq", [
    (64, 4, 1, 44356, 44100, 65536, 6), (2, 3, 2, 1800, 1500, 2048, 3),
    (2, 2, 2, 1024, 1024, 1024, 2)])
def test_scene_windowed_kernel_matches_plain_and_split(cuda, scenes, m,
                                                       paths, total, out,
                                                       nfft, wq):
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, scenes, m,
                                                       paths, total, out)
    pi, pj = _pairs(m)
    mask = cf.band_mask(nfft, (300.0, 3400.0), 8000.0, device=cuda)
    win, stats = cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq,
                                   fade, mask, snr, seeds)
    w2, s2 = cf.scene_windowed_plain(base, tau, gains, pi, pj, nfft, out,
                                     wq, fade, mask, snr, seeds)
    sigs = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    w3, s3 = cf.gcc_windowed(sigs, pi, pj, nfft, wq, mask)
    torch.cuda.synchronize()
    # Against the twin: float32 transforms plus the noise's last-place
    # differences, whitened (PHAT divides by small bin magnitudes).
    assert float((win - w2).abs().max()) < 2e-5
    # Against the split kernels: the same arithmetic in the same order.
    assert float((win - w3).abs().max()) < 1e-6
    assert torch.equal(stats[..., 2], s3[..., 2])


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,paths,total,out,nfft,wq", [
    (3, 3, 2, 7000, 6000, 8192, 2), (1, 4, 22, 50292, 44100, 65536, 21),
    (3, 5, 1, 8192, 8192, 8192, 4), (2, 11, 1, 44356, 44100, 65536, 6)])
def test_scene_windowed_split_shapes(cuda, scenes, m, paths, total, out,
                                     nfft, wq):
    """K5 on the split at odd mic counts (packed rows across scenes) and
    the api's single scene, and with 11 mics, whose GCC stage goes
    through the mic rows' spectra while the render stays on the split:
    against the twin and, bit for bit where it matters, against K3 then
    K2."""
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, scenes, m,
                                                       paths, total, out)
    pi, pj = _pairs(m)
    mask = cf.band_mask(nfft, (300.0, 3400.0), 16000.0, device=cuda)
    win, stats = cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq,
                                   fade, mask, snr, seeds)
    w2, s2 = cf.scene_windowed_plain(base, tau, gains, pi, pj, nfft, out,
                                     wq, fade, mask, snr, seeds)
    sigs = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    w3, s3 = cf.gcc_windowed(sigs, pi, pj, nfft, wq, mask)
    torch.cuda.synchronize()
    assert float((win - w2).abs().max()) < 2e-5
    assert float((win - w3).abs().max()) < 1e-6
    assert torch.equal(stats[..., 2], s3[..., 2])
    assert float((stats - s3).abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("m,paths,total,out,nfft,wq", [
    (4, 2, 1800, 1500, 2048, 3), (3, 2, 7000, 6000, 8192, 2),
    (4, 1, 44356, 44100, 65536, 6)])
def test_scene_kernels_across_scene_chunks(cuda, monkeypatch, m, paths,
                                           total, out, nfft, wq):
    """K3, K2 and K5 with the grid limit lowered so that 5 scenes cross
    it (chunks of 2, 2 and 1 at 3 and 4 mics): each launches once a chunk,
    against its twin, and K5 equals K3 then K2 to the bit; the chunks
    equal one launch over every scene (even chunks pack rows as one launch
    does)."""
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, 5, m, paths,
                                                       total, out)
    pi, pj = _pairs(m)
    mask = cf.band_mask(nfft, (300.0, 3400.0), 16000.0, device=cuda)

    def run():
        sigs = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr,
                            seeds)
        return (sigs, cf.gcc_windowed(sigs, pi, pj, nfft, wq, mask),
                cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq,
                                  fade, mask, snr, seeds))

    whole = run()
    monkeypatch.setattr(cf, "_MAX_GRID_Y", 7)
    assert cf.scene_chunk(5, m, len(pi), nfft) == 2
    cf.reset_launches()
    sigs, split, fused = run()
    assert cf.LAUNCHES["delay_sum"] == 3 and cf.LAUNCHES["gcc_windowed"] == 3
    assert cf.LAUNCHES["scene_windowed"] == 3
    want_sigs = cf.delay_sum_plain(base, tau, gains, nfft, out, fade, True,
                                   snr, seeds)
    want_win, want_stats = cf.gcc_windowed_plain(sigs, pi, pj, nfft, wq, mask)
    torch.cuda.synchronize()
    assert float((sigs - want_sigs).abs().max()) < 2e-5
    assert float((split[0] - want_win).abs().max()) < 1e-6
    assert torch.equal(split[1][..., 2], want_stats[..., 2])
    assert all(torch.equal(a, b) for a, b in zip(fused, split))
    assert torch.equal(sigs, whole[0])
    assert all(torch.equal(a, b) for a, b in zip(split, whole[1]))
    assert all(torch.equal(a, b) for a, b in zip(fused, whole[2]))


# One block up to 4,096 points: (scenes, mics, paths, padded length,
# samples, nfft, wq): one scene at 512 with 3 mics, 7 scenes of 5, the
# short sweep's 512 x 4 at 2,048, the trio's 8 mics at 4,096, 9 mics (the
# GCC block's widest span but one), and the GCC through the mic rows'
# spectra, a block a packed cross row, where a scene's rows do not fit (11
# mics at 4,096, 25 at 2,048).
ONE_BLOCK = [(1, 3, 2, 500, 450, 512, 2), (7, 5, 3, 1000, 900, 1024, 4),
             (512, 4, 1, 1694, 1600, 2048, 3), (64, 8, 1, 4094, 4000, 4096, 6),
             (3, 9, 2, 3500, 3000, 4096, 2), (2, 11, 1, 3500, 3000, 4096, 2),
             (3, 25, 1, 1800, 1600, 2048, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,paths,total,out,nfft,wq", ONE_BLOCK)
def test_scene_kernels_in_one_block_match_plain(cuda, scenes, m, paths,
                                                total, out, nfft, wq):
    """K3 (``render_block``), K2 (``window_block``) and K5 (the two in
    turn) at nfft <= 4,096, odd mic counts, one scene and many: each one
    launch of its wrapper, against its twin within the A/B tool's
    ``SCENE_TOL`` (2e-5, 1e-6, 1e-5) with equal argmaxes, and K5 equal to
    K3 then K2 to the bit (the GCC through the spectra where a scene does
    not fit)."""
    assert cf.render_route(nfft).n1 == cf.gcc_route(nfft, m).n1 == 1
    assert cf.gcc_route(nfft, m).kind == (
        cf.ROUTE_BLOCK if m <= (24 if nfft == 2048 else 10)
        else cf.ROUTE_SPECTRA_BLOCK)
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, scenes, m,
                                                       paths, total, out)
    pi, pj = _pairs(m)
    mask = cf.band_mask(nfft, (300.0, 3400.0), 16000.0, device=cuda)
    cf.reset_launches()
    sigs = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    win, stats = cf.gcc_windowed(sigs, pi, pj, nfft, wq, mask)
    fused = cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq, fade,
                              mask, snr, seeds)
    assert (cf.LAUNCHES["delay_sum"], cf.LAUNCHES["gcc_windowed"],
            cf.LAUNCHES["scene_windowed"]) == (1, 1, 1)
    want_sigs = cf.delay_sum_plain(base, tau, gains, nfft, out, fade, True,
                                   snr, seeds)
    w2, s2 = cf.gcc_windowed_plain(sigs, pi, pj, nfft, wq, mask)
    w5, s5 = cf.scene_windowed_plain(base, tau, gains, pi, pj, nfft, out, wq,
                                     fade, mask, snr, seeds)
    torch.cuda.synchronize()
    assert float((sigs - want_sigs).abs().max()) < 2e-5
    assert float((win - w2).abs().max()) < 1e-6
    assert torch.equal(stats[..., 2], s2[..., 2])
    assert float((stats[..., :2] - s2[..., :2]).abs().max()) < 1e-6
    assert float((fused[0] - w5).abs().max()) < 1e-5
    assert torch.equal(fused[0], win) and torch.equal(fused[1], stats)


@pytest.mark.cuda
@pytest.mark.parametrize("finalize,noise", [(True, False), (False, True),
                                            (False, False)])
@pytest.mark.parametrize("scenes,m,paths,total,nfft", [
    (3, 3, 2, 1000, 1024), (1, 4, 22, 4094, 4096), (132, 4, 1, 788, 1024)])
def test_render_block_finish_options(cuda, finalize, noise, scenes, m,
                                     paths, total, nfft):
    """K3 in one block with the finalize or the noise off (the moving
    render's frames take neither, at out == the padded length): against the
    twin, raw renders relative to their peak."""
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, scenes, m,
                                                       paths, total, total)
    nz = (snr, seeds) if noise else (None, None)
    got = cf.delay_sum(base, tau, gains, nfft, total, fade, finalize, *nz)
    want = cf.delay_sum_plain(base, tau, gains, nfft, total, fade, finalize,
                              *nz)
    torch.cuda.synchronize()
    scale = 1.0 if finalize else float(want.abs().max())
    assert float((got - want).abs().max()) < 2e-5 * max(scale, 1.0)


@pytest.mark.cuda
def test_one_block_device_kernels_per_call(cuda, tmp_path, monkeypatch):
    """At 4,096 points K3 runs one device kernel (``render_block``), K2 one
    (``window_block`` over its rows) and K5 two (``render_block``, then
    ``window_block`` over the packed finished signals); with 11 mics K5's
    GCC stage goes through the mic rows' spectra after the same
    ``render_block`` (K4a's ``fft_real_block`` over the packed finished
    signals, then ``corr_block``, a block a packed cross row); a chunked
    call runs its kernels once a chunk."""
    base, tau, gains, snr, sd, fade = _scene_inputs(cuda, 64, 4, 1, 4094,
                                                    4000)
    pi, pj = _pairs(4)
    mask = cf.band_mask(4096, (300.0, 3400.0), 16000.0, device=cuda)
    names = _device_kernels(
        lambda: cf.delay_sum(base, tau, gains, 4096, 4000, fade, True, snr,
                             sd), tmp_path / "k3.json")
    assert len(names) == 1 and "render_block" in names[0], names
    sigs = cf.delay_sum(base, tau, gains, 4096, 4000, fade, True, snr, sd)
    names = _device_kernels(
        lambda: cf.gcc_windowed(sigs, pi, pj, 4096, 6, mask),
        tmp_path / "k2.json")
    assert len(names) == 1, names
    assert "window_block" in names[0] and "RowLoad" in names[0], names
    names = _device_kernels(
        lambda: cf.scene_windowed(base, tau, gains, pi, pj, 4096, 4000, 6,
                                  fade, mask, snr, sd), tmp_path / "k5.json")
    assert len(names) == 2, names
    assert "render_block" in names[0] and "window_block" in names[1]
    assert "PackedLoad" in names[1], names
    base, tau, gains, snr, sd, fade = _scene_inputs(cuda, 2, 11, 1, 4094,
                                                    4000)
    qi, qj = _pairs(11)
    names = _device_kernels(
        lambda: cf.scene_windowed(base, tau, gains, qi, qj, 4096, 4000, 2,
                                  fade, mask, snr, sd), tmp_path / "k5p.json")
    assert len(names) == 3, names
    assert "render_block" in names[0] and "fft_real_block" in names[1]
    assert "PackedLoad" in names[1] and "corr_block" in names[2], names
    assert "WindowOut" in names[2], names
    monkeypatch.setattr(cf, "_MAX_GRID_Y", 7)
    base, tau, gains, snr, sd, fade = _scene_inputs(cuda, 5, 4, 1, 1800,
                                                    1500)
    mask = cf.band_mask(2048, (300.0, 3400.0), 16000.0, device=cuda)
    names = _device_kernels(
        lambda: cf.scene_windowed(base, tau, gains, pi, pj, 2048, 1500, 3,
                                  fade, mask, snr, sd), tmp_path / "k5c.json")
    assert len(names) == 6, names     # chunks of 2, 2 and 1 scenes


@pytest.mark.cuda
def test_sweep_across_the_chunk_boundary_on_the_card(cuda):
    """21,846 scenes at 4 mics (nfft 512): one past the 65,535 / 3 couples
    of one launch.  The fused path launches K5 twice, the split path K3
    and K2 twice each, over the same chunks, and the two agree to the bit
    scene by scene."""
    spec = SweepSpec(fs=8000.0, duration=0.05)
    scenes = 21_846
    cf.reset_launches()
    fused = run_scene(spec, 9, scenes, device=cuda)
    assert cf.LAUNCHES["scene_windowed"] == 2
    split = sweep._run_scenes(spec, _gen(cuda, 9), scenes, torch.float32,
                              False)
    assert cf.LAUNCHES["delay_sum"] == 2 and cf.LAUNCHES["gcc_windowed"] == 2
    assert torch.equal(fused.tdoas, split.tdoas)
    assert torch.equal(fused.estimate, split.estimate)
    assert bool(torch.isfinite(fused.estimate).all())


_SPEC = SweepSpec(fs=16000.0, duration=0.1, signal_type="noise",
                  source_box_lo=(0.2, 0.2, 0.2),
                  source_box_hi=(0.8, 0.8, 0.8), snr_db=(25.0, 35.0))


@pytest.mark.cuda
def test_fused_and_split_sweep_paths_agree_on_the_card(cuda):
    cf.reset_launches()
    fused = run_scene(_SPEC, 5, 16, device=cuda)
    split = sweep._run_scenes(_SPEC, _gen(cuda, 5), 16, torch.float32,
                              False)
    assert cf.LAUNCHES["scene_windowed"] == 1
    assert cf.LAUNCHES["delay_sum"] == 1 and cf.LAUNCHES["gcc_windowed"] == 1
    assert float((fused.tdoas - split.tdoas).abs().max()) * _SPEC.fs < 0.5
    assert float((fused.estimate - split.estimate).abs().max()) < 1e-3


@pytest.mark.cuda
def test_sweep_on_the_card_matches_cpu_statistics(cuda):
    """Different generators draw different scenes; the statistics agree."""
    card = monte_carlo_sweep(_SPEC, 0, 32, device=cuda)
    cpu = monte_carlo_sweep(_SPEC, 0, 32, device="cpu")
    for s in (card, cpu):
        assert float(s.rmse) < 0.5 and float(s.hit_rate) > 0.8
    est, _, td = localize_batch(_SPEC, np.zeros((2, 4, 1600)),
                                _SPEC.mic_positions, 0, device=cuda)
    assert est.shape == (2, 3) and td.shape == (2, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("change", [
    dict(solver="srp"), dict(solver="srp+lm"),
    dict(threshold_method="median", gcc_weighting="scot"),
    dict(solver="srp", num_sources=2, source_min_separation=0.4,
         mic_positions=((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                        (0.0, 0.0, 1.0), (1.0, 1.0, 0.0), (1.0, 0.0, 1.0),
                        (0.0, 1.0, 1.0), (1.0, 1.0, 1.0)))])
def test_full_correlation_sweep_on_the_card(cuda, change):
    """The full-correlation branch on the card: K3 then K1 over every
    scene (the unfused GCC for SCOT), no windowed kernel; the statistics
    agree with the CPU's."""
    import dataclasses
    spec = dataclasses.replace(_SPEC, **change)
    cf.reset_launches()
    card = monte_carlo_sweep(spec, 0, 16, device=cuda)
    assert cf.LAUNCHES["delay_sum"] == 1
    assert cf.LAUNCHES["gcc_all_pairs"] == (spec.gcc_weighting == "phat")
    assert cf.LAUNCHES["gcc_windowed"] == cf.LAUNCHES["scene_windowed"] == 0
    cpu = monte_carlo_sweep(spec, 0, 16, device="cpu")
    for s in (card, cpu):
        assert float(s.hit_rate) > 0.8


_TRIO = SweepSpec(fs=16000.0, duration=0.25, signal_type="sine", freq=800.0,
                  mic_positions=tuple((x, y, z) for x in (0.0, 1.0)
                                      for y in (0.0, 1.0)
                                      for z in (0.0, 1.0)),
                  source_box_lo=(0.2, 0.2, 0.2),
                  source_box_hi=(0.8, 0.8, 0.8), snr_db=(25.0, 35.0))


def _tone_scenes(num, seed):
    """tools/torch_narrowband_golden.tone_scenes (numpy only)."""
    import importlib.util
    from pathlib import Path
    path = (Path(__file__).resolve().parents[1] / "tools"
            / "torch_narrowband_golden.py")
    spec = importlib.util.spec_from_file_location("nb_golden", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.tone_scenes(seed, num, _TRIO.fs, _TRIO.duration,
                              _TRIO.mic_positions, _TRIO.speed_of_sound,
                              _TRIO.source_box_lo, _TRIO.source_box_hi,
                              _TRIO.freq)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["beam", "music", "capon"])
def test_narrowband_localize_batch_on_the_card(cuda, solver):
    """The narrowband trio's localize_batch on 8 tone scenes: no kernel
    (the estimators read the signals, as the JAX package's XLA path), the
    fixes within 15 mm of the CPU's float64 answers (float32 eigh bounds
    MUSIC's fine stage near 1 cm) and near the sources."""
    import dataclasses
    spec = dataclasses.replace(_TRIO, solver=solver)
    sigs, sources = _tone_scenes(8, 3)
    cf.reset_launches()
    est, cost, td = localize_batch(spec, sigs, spec.mic_positions, 0,
                                   device=cuda)
    assert sum(cf.LAUNCHES.values()) == 0
    want, _, _ = localize_batch(spec, sigs, spec.mic_positions, 0,
                                dtype=torch.float64, device="cpu")
    assert bool(torch.all(td == 0)) and bool(torch.isfinite(cost).all())
    gap = (est.double().cpu() - want).norm(dim=-1)
    assert float(gap.max()) < (15e-3 if solver == "music" else 2e-3)
    err = np.linalg.norm(est.double().cpu().numpy() - sources, axis=-1)
    assert float(np.median(err)) < 0.02


@pytest.mark.cuda
def test_narrowband_sweep_on_the_card_launches_k3_only(cuda):
    import dataclasses
    spec = dataclasses.replace(_TRIO, solver="capon")
    cf.reset_launches()
    s = monte_carlo_sweep(spec, 0, 16, device=cuda)
    assert cf.LAUNCHES["delay_sum"] == 1
    assert sum(cf.LAUNCHES.values()) == 1
    assert float(s.hit_rate) > 0.8


@pytest.mark.cuda
def test_batched_de_on_the_card(cuda):
    """The sweep's DE tail over 64 scenes on the card: K5 (fused), every
    fix near its source, statistics as the CPU's; and the batched DE
    freezes a converged scene (its best seeded member comes back)."""
    import dataclasses
    spec = dataclasses.replace(_SPEC, solver="de")
    cf.reset_launches()
    card = monte_carlo_sweep(spec, 0, 64, device=cuda)
    assert cf.LAUNCHES["scene_windowed"] == 1
    assert float(card.hit_rate) > 0.9
    from pyaudiolocalization_tpu_torch.models import solver
    f64 = dict(dtype=torch.float64, device=cuda)
    target = torch.tensor([[0.0, 0.0, 0.0], [0.7, -0.3, 1.1]], **f64)

    def objective(x):
        sq = torch.sum((x - target[:, None]) ** 2, -1)
        return torch.stack([1.0 + 1e-12 * sq[0], sq[1]])

    lower = torch.full((2, 3), -2.0, **f64)
    init = torch.rand((2, 45, 3), generator=_gen(cuda, 3), **f64) * 4.0 - 2.0
    res = solver.differential_evolution_batched(
        objective, lower, -lower, _gen(cuda), maxiter=300, init=init)
    best0 = init[0, torch.argmin(torch.sum(init[0] ** 2, -1))]
    assert torch.equal(res.x[0], best0)
    assert float(torch.linalg.norm(res.x[1] - target[1])) < 1e-2


# ---------------------------------------------------------------------------
# K10: the four-step row DFT (ops/rowdft.py).  Limits: rowdft.TRANSFORM_TOL
# (5e-5) of max|plain| for transforms, rowdft.CHAIN_TOL (2e-3) for the
# chain.
# ---------------------------------------------------------------------------

_K10_SHAPES = [(64, 33), (128, 16), (256, 8), (512, 8), (1024, 4)]


def _rel_err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    scale = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) for g, w in zip(got, want)) / scale


def _planes(cuda, b, n2, seed=0):
    g = _gen(cuda, seed)
    return (torch.randn((b, n2, 128), generator=g, device=cuda),
            torch.randn((b, n2, 128), generator=g, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n2,b", _K10_SHAPES)
@pytest.mark.parametrize("kind", ["row_dft", "row_stages"])
def test_row_kernels_match_plain(cuda, kind, n2, b):
    """Forward, the unscaled inverse, rep 8, real input, zero_top, and the
    chain's real-part epilogues (mode 1 stores, mode 2 adds)."""
    from pyaudiolocalization_tpu_torch.ops import rowdft as rd
    fn = getattr(rd, kind)
    xr, xi = _planes(cuda, b, n2)
    half = xr[:, :n2 // 2].contiguous()
    for args, kw in (((xr, xi), {}), ((xr, xi), {"inverse": True}),
                     ((xr, xi), {"rep": 8}), ((xr,), {}),
                     ((half,), {"zero_top": True})):
        cf.reset_launches()
        got = fn(*args, **kw)
        assert cf.LAUNCHES[kind] == 1
        want = rd.row_dft_plain(*args, **kw)
        torch.cuda.synchronize()
        assert _rel_err(got, want) < rd.TRANSFORM_TOL, (kw, len(args))
    inv = rd.row_dft_plain(xr, xi, inverse=True)[0]
    out = torch.randn((b, n2, 128), generator=_gen(cuda, 5), device=cuda)
    acc = out.clone()
    for mode, want in ((2, acc + inv), (1, inv)):
        rd._row_launch(kind, xr, xi, n2, True, 1, 1.0, out_r=out, mode=mode)
        torch.cuda.synchronize()
        assert _rel_err(out, want) < rd.TRANSFORM_TOL, mode


@pytest.mark.cuda
@pytest.mark.parametrize("n2", [64, 512, 1024])
def test_row_kernels_round_trip(cuda, n2):
    from pyaudiolocalization_tpu_torch.ops import rowdft as rd
    xr, xi = _planes(cuda, 4, n2, 1)
    for fn in (rd.row_dft, rd.row_stages):
        yr, yi = fn(*fn(xr, xi), inverse=True)
        assert _rel_err((yr / n2, yi / n2), (xr, xi)) < rd.TRANSFORM_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n2,b", _K10_SHAPES)
def test_lane_kernel_matches_plain(cuda, n2, b):
    """Every prologue and epilogue; the whitened cross spectrum on two
    independent spectra; the natural-order store (bin s * n2 + t), with the
    forward twiddle and with the conjugate one."""
    from pyaudiolocalization_tpu_torch.ops import rowdft as rd
    xr, xi = _planes(cuda, b, n2, 2)
    yr, yi = _planes(cuda, b, n2, 12)
    for kw in ({}, {"twiddle": True}, {"conj": True},
               {"conj": True, "twiddle": True},
               {"conj": True, "twiddle": True, "cross": (yr, yi)},
               {"cross": (yr, yi)}):
        cf.reset_launches()
        got = rd.lane_dft(xr, xi, **kw)
        assert cf.LAUNCHES["lane_dft"] == 1
        want = rd.lane_dft_plain(xr, xi, **kw)
        torch.cuda.synchronize()
        assert _rel_err(got, want) < rd.TRANSFORM_TOL, sorted(kw)
    for conj in (False, True):
        got = rd._lane_launch(xr, xi, conj=conj, twiddle=True, natural=True)
        want = torch.complex(*rd.lane_dft_plain(xr, xi, conj, True))
        want = want.transpose(1, 2).reshape(b, n2 * 128)
        torch.cuda.synchronize()
        assert _rel_err(got, want) < rd.TRANSFORM_TOL, conj


@pytest.mark.cuda
@pytest.mark.parametrize("n2", [64, 512, 1024])
@pytest.mark.parametrize("schedule", ["mxu", "stages"])
def test_four_step_and_chain_on_the_card(cuda, schedule, n2):
    """The full forward, and the chain on four planes of their own (whose
    output is not ~0 away from lag 0, so the whitening prologue and the
    real-part store and add epilogues show) and on the tool's four scaled
    copies of one plane."""
    from pyaudiolocalization_tpu_torch.ops import rowdft as rd
    row = "row_dft" if schedule == "mxu" else "row_stages"
    other = "row_stages" if schedule == "mxu" else "row_dft"
    x, _ = _planes(cuda, 3, n2, 3)
    for zero_top in (False, True):
        xin = x[:, :n2 // 2].contiguous() if zero_top else x
        cf.reset_launches()
        got = rd.fft_four_step(xin, schedule, zero_top)
        assert cf.LAUNCHES[row] == 1 and cf.LAUNCHES["lane_dft"] == 1
        assert got.shape == (3, n2 * 128) and got.dtype == torch.complex64
        want = rd.fft_four_step_plain(xin, zero_top)
        torch.cuda.synchronize()
        assert _rel_err(got, want) < rd.TRANSFORM_TOL
    x4 = torch.randn((4, 3, n2, 128), generator=_gen(cuda, 13), device=cuda)
    for xin in (x4, x):
        cf.reset_launches()
        got = rd.chain(xin, schedule)
        assert cf.LAUNCHES[row] == 7 and cf.LAUNCHES["lane_dft"] == 7
        assert cf.LAUNCHES[other] == 0
        assert got.shape == (3, n2, 128)
        want = rd.chain_plain(xin)
        torch.cuda.synchronize()
        assert _rel_err(got, want) < rd.CHAIN_TOL
        if xin is x4:  # no single lag dominates what is compared
            assert float(want.abs().max()) < 100 * float(want.abs().median())


@pytest.mark.cuda
@pytest.mark.parametrize("n2", [64, 1024])
def test_precision_controls_miss_the_limit(cuda, n2):
    """K10a with one or two of the three TF32 products misses the limit
    that the 3xTF32 kernel meets, so the limit sees the split."""
    from pyaudiolocalization_tpu_torch.ops import rowdft as rd
    xr, xi = _planes(cuda, 8, n2, 4)
    want_row = rd.row_dft_plain(xr, xi)
    for terms in (3, 2, 1):
        row = _rel_err(rd._row_launch("row_dft", xr, xi, n2, False, 1, 1.0,
                                      terms=terms), want_row)
        if terms == 3:
            assert row < rd.TRANSFORM_TOL
        else:
            assert row > rd.TRANSFORM_TOL, terms


@pytest.mark.cuda
def test_rowdft_wrappers_raise_on_the_card(cuda):
    from pyaudiolocalization_tpu_torch.ops import rowdft as rd
    xr, xi = _planes(cuda, 2, 64)
    shifted = torch.zeros(xr.numel() + 1, device=cuda)[1:].view(xr.shape)
    for call in (lambda: rd.row_dft(xr.double(), xi.double()),
                 lambda: rd.lane_dft(shifted, xi),
                 lambda: rd.row_stages(xr.transpose(0, 1).contiguous()
                                       .transpose(0, 1)),
                 lambda: rd.lane_dft(xr, xi.double()),
                 lambda: rd.lane_dft(xr, xi, cross=(xr, xi.cpu())),
                 lambda: rd.fft_four_step(xr[:, :32].contiguous()),
                 lambda: rd.chain(torch.stack([xr] * 3)),
                 lambda: rd.row_dft(xr, xi.cpu())):
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# Recorded audio, the compat layer and the checkpointed sweep on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("sr_orig,sr_new", [(48000.0, 44100.0),
                                            (16000.0, 48000.0)])
def test_resample_on_the_card_matches_the_cpu(cuda, sr_orig, sr_new):
    """The chunked Kaiser-sinc resampler on the card against the same code
    on the CPU, float32, within 1e-5 of the row's peak."""
    from pyaudiolocalization_tpu_torch.ops.resample import resample
    x = torch.randn((2, 48000), generator=_gen(cuda, 5), device=cuda)
    got = resample(x, sr_orig, sr_new)
    want = resample(x.cpu(), sr_orig, sr_new)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert float((got.cpu() - want).abs().max()) < 1e-5 * float(
        want.abs().max())


@pytest.mark.cuda
def test_recorded_api_on_the_card(cuda, tmp_path):
    """Four 48 kHz WAV files of a delayed noise source through
    localize_sound_source(use_simulation=False) on the card: K1, K4a and
    K4b launch, and the TDOAs equal the CPU run's within 0.05 samples."""
    from pyaudiolocalization_tpu_torch.utils.audio_io import write_wav
    rng = np.random.default_rng(0)
    base = rng.uniform(-0.5, 0.5, 48000)
    paths = []
    for k, shift in enumerate((0, 12, 30, 57)):
        paths.append(str(tmp_path / f"mic{k}.wav"))
        write_wav(paths[-1], np.roll(base, shift), 48000)
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               num_bootstrap=64)
    cf.reset_launches()
    got = localize_sound_source(cfg, audio_files=paths, use_simulation=False,
                                device=cuda, dtype=torch.float32)
    for name in ("gcc_all_pairs", "fft_real", "bootstrap_peaks"):
        assert cf.LAUNCHES[name] > 0, name
    assert cf.LAUNCHES["delay_sum"] == 0
    want = localize_sound_source(cfg, audio_files=paths,
                                 use_simulation=False, device="cpu",
                                 dtype=torch.float32)
    assert np.max(np.abs(got["tdoas"] - want["tdoas"])) * 44100 < 0.05


@pytest.mark.cuda
def test_compat_pow2_pair_on_the_card(cuda):
    """compat.get_time_delays_phat at n1 + n2 - 1 = 2^15 launches K4a and
    K9 on the card and recovers an injected fractional delay."""
    from pyaudiolocalization_tpu_torch import compat
    fs = 44100.0
    compat.seed(1)
    sig = compat.generate_signal("noise", fs, 16384 / fs, 500.0)
    delayed = compat.fractional_delay(sig, 0.30 / 343.0, fs)
    cf.reset_launches()
    delays, corr, _ = compat.get_time_delays_phat(
        sig, np.append(delayed, 0.0), fs, lag_mode="physical")
    assert cf.LAUNCHES["fft_real"] == 1 and cf.LAUNCHES["whitened_corr"] == 1
    assert corr.shape == (32768,)
    assert abs(-delays[0] - 0.30 / 343.0) * fs < 1.0


@pytest.mark.cuda
def test_checkpointed_sweep_resumes_to_the_bit_on_the_card(cuda, tmp_path):
    """3 chunks of 64 scenes at the sweep's full-width spec; an interrupted
    run resumed equals the uninterrupted one to the bit, and K5 launches
    once a chunk."""
    from pyaudiolocalization_tpu_torch.parallel import run_sweep_checkpointed
    spec = SweepSpec()
    cf.reset_launches()
    full = run_sweep_checkpointed(spec, 4, 192, 64, str(tmp_path / "f.npz"),
                                  device=cuda)
    assert cf.LAUNCHES["scene_windowed"] == 3

    def stop(msg):
        if msg.startswith("chunk 1/"):
            raise KeyboardInterrupt

    part = str(tmp_path / "p.npz")
    with pytest.raises(KeyboardInterrupt):
        run_sweep_checkpointed(spec, 4, 192, 64, part, log_fn=stop,
                               device=cuda)
    resumed = run_sweep_checkpointed(spec, 4, 192, 64, part, device=cuda)
    for a, b in zip(resumed.results, full.results):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The serving path's shapes: K1 over segments x subframes, K3 over the
# moving render's frames, K7 on the stream's EMA cross-spectra
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("lead,m,length,nfft", [
    ((15, 8), 4, 512, 1024),      # tracking subframes (segment 4096)
    ((12, 8), 8, 256, 512),       # crossing walkers' subframes, 8 mics
    ((15,), 4, 4096, 4096),       # tracking segments
    ((1, 8), 4, 256, 512)])       # the stream's live frame
def test_gcc_all_pairs_over_two_leading_axes(cuda, lead, m, length, nfft):
    g = _gen(cuda, 14)
    sig = torch.randn(lead + (m, length), generator=g, device=cuda)
    pi, pj = _pairs(m)
    mask = cf.band_mask(nfft, None, 16000.0, device=cuda)
    got = cf.gcc_all_pairs(sig, pi, pj, nfft, mask)
    want = cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask)
    torch.cuda.synchronize()
    assert got.shape == lead + (len(pi), nfft)
    assert float((got - want).abs().max()) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("frames,m,total,nfft", [(130, 4, 650, 1024),
                                                 (700, 8, 4200, 8192)])
def test_delay_sum_over_moving_render_frames(cuda, frames, m, total, nfft):
    """K3 with the frames of a moving render as scenes: one path a mic,
    no finalize, the faded circular render at next_pow2(frame + budget)."""
    g = _gen(cuda, 15)
    base = torch.zeros((frames, total), device=cuda)
    base[:, :total // 2] = torch.randn((frames, total // 2), generator=g,
                                       device=cuda)
    tau = torch.rand((frames, m, 1), generator=g, device=cuda) * total / 2
    gains = torch.rand((frames, m, 1), generator=g, device=cuda)
    fade = fade_window(total, dtype=torch.float32, device=cuda)
    got = cf.delay_sum(base, tau, gains, nfft, total, fade, False)
    want = cf.delay_sum_plain(base, tau, gains, nfft, total, fade, False)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) < 2e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(6, 4097), (28, 2049)])
def test_whiten_at_the_stream_shapes(cuda, shape):
    g = _gen(cuda, 16)
    spec = torch.complex(torch.randn(shape, generator=g, device=cuda),
                         torch.randn(shape, generator=g, device=cuda))
    got = cf.whiten(spec)
    want = cf.whiten_plain(spec)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_serving_paths_on_the_card_match_the_cpu(cuda):
    """The moving render (K3) of one noise base, streaming GCC (K7),
    localize_trajectory (K1) and a stream's run (K7) on the card against
    the same calls on the CPU, float32."""
    from pyaudiolocalization_tpu_torch.models import online, simulator
    from pyaudiolocalization_tpu_torch.models import tracking
    mics = np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [1.5, 3.0, 0.0],
                     [1.5, 1.5, 2.0]])
    fs, c, start, vel = 16000.0, 343.0, [0.8, 1.2, 0.7], [1.5, 0.4, 0.0]
    budget, lead = simulator._moving_margins(start, vel, mics, fs, c, 1.0,
                                             512)
    base = simulator._moving_base("noise", 1000.0, fs, 1.0, lead,
                                  torch.Generator().manual_seed(0),
                                  torch.float32, "cpu")
    args = (start, vel, mics, fs, c, 512, budget, lead, 1000.0, 0.01, 1e-6)
    cf.reset_launches()
    card = simulator._render_moving(base.to(cuda), *args)
    cpu = simulator._render_moving(base, *args)
    assert cf.LAUNCHES["delay_sum"] == 1
    assert float((card.cpu() - cpu).abs().max()) < 1e-4 * float(
        cpu.abs().max())
    pi, pj = _pairs(4)
    corr, lags = gccphat.gcc_phat_streaming(card, pi, pj, frame=2048)
    want, _ = gccphat.gcc_phat_streaming(cpu, pi, pj, frame=2048,
                                         device="cpu")
    assert cf.LAUNCHES["whiten"] == 1
    assert float((corr.cpu() - want).abs().max()) < 1e-4
    track = tracking.localize_trajectory(card, mics, fs, c, [0, 0, 0],
                                         [3.2, 3.2, 2.2], segment=4096,
                                         coarse_n=32, fine_n=12,
                                         smoother="kalman")
    assert cf.LAUNCHES["gcc_all_pairs"] == 1
    truth = np.asarray(start) + track.times.cpu().numpy()[:, None] * vel
    err = np.linalg.norm(track.positions.cpu().numpy() - truth, axis=-1)
    assert np.median(err) < 0.1, err
    loc = online.StreamingLocalizer(mics, fs, c, [0, 0, 0], [3.2, 3.2, 2.2],
                                    frame=4096, hop=1024)
    pos, _ = loc.run(cpu.numpy())
    assert cf.LAUNCHES["whiten"] == 1 + cpu.shape[1] // 1024
    assert np.isfinite(pos).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(8, 4), (12, 6)])
def test_gcc_all_pairs_at_the_calibration_shapes(cuda, b, m):
    """K1 over array calibration's events: 48 kHz x 0.1 s (4,800 samples)
    at nfft 16,384, no band, 8 events of the tetrahedron and 12 of the
    6-mic array."""
    sig = torch.randn((b, m, 4800), generator=_gen(cuda, 15), device=cuda)
    pi, pj = _pairs(m)
    mask = cf.band_mask(16384, None, 48000.0, device=cuda)
    got = cf.gcc_all_pairs(sig, pi, pj, 16384, mask)
    want = cf.gcc_all_pairs_plain(sig, pi, pj, 16384, mask)
    torch.cuda.synchronize()
    assert got.shape == (b, len(pi), 16384)
    assert float((got - want).abs().max()) < 1e-6


def _events(mics, sources, fs, n, seed):
    """Free-field noise events (K, M, n) float32: each mic hears the base
    delayed by its distance / 343 m/s (phase ramp) and scaled by 1/d."""
    rng = np.random.default_rng(seed)
    nfft = 4 * n
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    out = []
    for src in sources:
        spec = np.fft.rfft(rng.standard_normal(n), nfft)
        d = np.linalg.norm(mics - src, axis=-1)
        sig = np.fft.irfft(spec * np.exp(-2j * np.pi * freqs
                                         * (d[:, None] / 343.0)), nfft)
        out.append(sig[:, :n] / d[:, None])
    return np.asarray(out, np.float32)


@pytest.mark.cuda
def test_extraction_calibration_and_mesh_on_the_card_match_the_cpu(
        cuda, tmp_path):
    """Extraction (no kernel), calibration at nfft 16,384 (one K1 launch
    over the events) and a one-rank mesh sweep on the card, against the
    same calls on the CPU (float32)."""
    from pyaudiolocalization_tpu_torch.models import arraycal, beamformer
    from pyaudiolocalization_tpu_torch.parallel import (
        make_mesh, run_sweep_checkpointed)
    cube = np.array([[x, y, z] for x in (0.0, 1.0) for y in (0.0, 1.0)
                     for z in (0.0, 1.0)])
    sigs = _events(cube, [np.array([0.3, 0.6, 0.4])], 16000.0, 4000, 1)[0]
    cf.reset_launches()
    for fn, kw in ((beamformer.extract_source, {}),
                   (beamformer.extract_source_mvdr, dict(taps=3))):
        got = fn(sigs, cube, [0.3, 0.6, 0.4], 16000.0, 343.0, **kw)
        want = fn(sigs, cube, [0.3, 0.6, 0.4], 16000.0, 343.0, device="cpu",
                  **kw)
        assert got.is_cuda and got.shape == want.shape
        assert float((got.cpu() - want).abs().max()) < 1e-3 * float(
            want.abs().max())
    assert sum(cf.LAUNCHES.values()) == 0
    tetra = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.5, 1.0, 0.0],
                      [0.5, 0.5, 1.0]])
    sources = np.array([[0.2, 0.3, 0.6], [0.9, 0.8, 0.4], [0.1, 0.9, 0.9],
                        [0.8, 0.1, 0.8], [0.5, 0.6, 0.2], [0.3, 0.2, 1.1],
                        [1.1, 0.5, 0.7], [0.6, 1.0, 1.0]])
    true = tetra + np.random.default_rng(11).uniform(-0.03, 0.03, (4, 3))
    events = _events(true, sources, 48000.0, 4800, 2)
    got = arraycal.calibrate_array_geometry(events, sources, tetra, 48000.0,
                                            343.0, nfft=16384,
                                            max_expected_delay=0.02)
    assert cf.LAUNCHES["gcc_all_pairs"] == 1
    want = arraycal.calibrate_array_geometry(events, sources, tetra, 48000.0,
                                             343.0, nfft=16384,
                                             max_expected_delay=0.02,
                                             device="cpu")
    np.testing.assert_allclose(got.tdoas.cpu().numpy(), want.tdoas.numpy(),
                               atol=1e-3 / 48000.0)
    np.testing.assert_allclose(got.mic_positions.cpu().numpy(),
                               want.mic_positions.numpy(), atol=1e-4)
    assert np.linalg.norm(got.mic_positions.cpu().numpy() - true,
                          axis=-1).max() < 0.008
    spec = SweepSpec(fs=16000.0, duration=0.1, signal_type="noise",
                     source_box_lo=(0.2,) * 3, source_box_hi=(0.8,) * 3)
    out = monte_carlo_sweep(spec, 3, 16, mesh=make_mesh())
    ck = run_sweep_checkpointed(spec, 3, 16, 16, str(tmp_path / "c.npz"))
    for a, b in zip(out.results, ck.results):
        np.testing.assert_array_equal(a.cpu().numpy(), b)

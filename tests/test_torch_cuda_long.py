"""The CUDA kernels against their plain PyTorch twins on the card above
2^20 points: the split of every transforming kernel to 2^24, above it
(2^25 to 2^30) the three-pass split of all eight, K4a's one-row
half-length transform, K9's, K1's, K2's, K3's and K5's shapes from 2^21
through the spectra, and the device kernels a call runs there.

A file of its own, run in its own process: in one process after these
cases, late profiler traces in ``test_torch_cuda_kernels.py`` lost each
call's first kernel.  Marked ``cuda``: without a card every test here
skips (decided inside the ``cuda`` fixture).  The file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_long.py

Each parametrized test named as one of ``test_torch_cuda_kernels.py``
runs that test's body at its shapes above 2^20; the tolerances are its.
"""

import pytest
import torch

from pyaudiolocalization_tpu_torch.models import tdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
from pyaudiolocalization_tpu_torch.ops import noise as noise_ops
from test_torch_cuda_kernels import (  # noqa: F401 (cuda: the fixture)
    _device_kernels, _gen, _pairs, _scene_inputs, cuda)
from test_torch_cuda_kernels import \
    test_bootstrap_peaks_kernel_matches_plain as _bootstrap_peaks
from test_torch_cuda_kernels import \
    test_gcc_all_pairs_schedules_match_plain as _gcc_schedules
from test_torch_cuda_kernels import \
    test_gcc_spectra_routes_match_plain as _gcc_spectra
from test_torch_cuda_kernels import \
    test_noise_bootstrap_equals_bootstrap_on_its_draws as _noise_equals
from test_torch_cuda_kernels import \
    test_noise_bootstrap_peaks_kernel_matches_plain as _noise_peaks
from test_torch_cuda_kernels import \
    test_render_spectra_route_matches_plain as _render_spectra
from test_torch_cuda_kernels import \
    test_whitened_corr_kernel_matches_plain as _whitened_corr

# K4a's, K4b's and K6's n1 above 2^20: the split to 2^24 (the long side in
# the rows above 2^22), the three-pass split of 2,048-point rows above (n1
# = 256 x 256 at 2^27).
LONG_N1 = {1 << 21: 2048, 1 << 22: 2048, 1 << 23: 2048, 1 << 24: 4096,
           1 << 25: 16384, 1 << 26: 32768, 1 << 27: 65536, 1 << 30: 524288}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,nfft", [
    (2, 1_046_019, 1 << 21), (3, 1_046_019, 1 << 21), (1, 2_000_000, 1 << 22),
    (3, 4_000_000, 1 << 23), (1, 8_400_000, 1 << 24), (2, 600_000, 1 << 25),
    (1, 16_800_000, 1 << 25), (1, 33_000_000, 1 << 26),
    (2, 600_000, 1 << 27), (1, 67_000_000, 1 << 27),
    (1, 400_000_000, 1 << 30)])
def test_fft_real_runs_the_passes_above_2_20(cuda, rows, length, nfft):
    """Above 2^20 K4a runs the four-step split with strips of 8 columns
    (``split_strips``) at 2^21 (a 23.7 s recording at 44.1 kHz, the
    bootstrap's spectrum; 2,048 x 1,024) and 2^22 (2,048 x 2,048, pass 2's
    strips 8 rows), with the long side in the rows at 2^23 (2,048 x 4,096,
    pass 2's strips 4 rows) and 2^24 (4,096 x 4,096, 4 columns, 4 rows),
    and above it the three-pass split of 2,048-point rows (2^25 to 2^30;
    a 380 s to a 9,070 s recording); an odd last row (one row: one
    launch; three: one launch more) as its half-length transform: each
    against its twin, relative to the spectrum's peak."""
    assert cf._split_n1(nfft) == LONG_N1[nfft]
    x = torch.randn((rows, length), generator=_gen(cuda), device=cuda)
    before = cf.LAUNCHES["fft_real"]
    got = cf.fft_real(x, nfft)
    assert cf.LAUNCHES["fft_real"] == before + (2 if rows == 3 else 1)
    want = cf.fft_real_plain(x, nfft)
    torch.cuda.synchronize()
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert float((got - want).abs().max()) < 5e-6 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["permutation", "noise"])
def test_bootstrap_significance_at_2_21_on_the_card(cuda, mode):
    """The api's bootstrap of a 600,000-sample pair at nfft 2^21 (K4a and
    K4b or K6 on the split, 2,048 x 1,024) against the twins on the same
    draws: the permuted rows, or the noise draws' seeds."""
    g = _gen(cuda, 3)
    sig1 = torch.randn(600_000, generator=g, device=cuda)
    sig2 = torch.randn(600_000, generator=g, device=cuda)
    nfft = 1 << 21
    cf.reset_launches()
    got = tdoa.bootstrap_significance(sig1, sig2, _gen(cuda, 4), 16,
                                      bootstrap_mode=mode, nfft=nfft)
    kernel = "bootstrap_peaks" if mode == "permutation" else \
        "noise_bootstrap_peaks"
    assert cf.LAUNCHES["fft_real"] == 1 and cf.LAUNCHES[kernel] == 1
    s1 = cf.fft_real_plain(sig1[None], nfft)[0]
    if mode == "permutation":
        rows = tdoa.permuted_rows(sig2, 16, _gen(cuda, 4))
        peaks = cf.bootstrap_peaks_plain(s1, rows, nfft)
    else:
        seeds = torch.randint(-2 ** 31, 2 ** 31, (16, 2),
                              generator=_gen(cuda, 4), dtype=torch.int32,
                              device=cuda)
        peaks = cf.noise_bootstrap_peaks_plain(s1, seeds, 600_000, nfft)
    want = torch.quantile(peaks, 0.95)
    torch.cuda.synchronize()
    assert abs(float(got) - float(want)) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,nfft", [
    (3, 100000, 1 << 21), (64, 1_046_019, 1 << 21), (3, 2_000_000, 1 << 22),
    (3, 100000, 1 << 23), (3, 100000, 1 << 24), (3, 100000, 1 << 25),
    (3, 16_800_000, 1 << 25), (3, 100000, 1 << 26), (3, 100000, 1 << 27)])
def test_bootstrap_peaks_kernel_matches_plain(cuda, rows, length, nfft):
    """K4b above 2^20: at 2^21 strips of 8 columns and 8 rows, at 2^22 8
    columns and 4 rows, at 2^23 8 columns and 2 rows of 4,096, at 2^24 4
    and 2 (``boot_strip``), and the three-pass split above 2^24."""
    _bootstrap_peaks(cuda, rows, length, nfft)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_samp,nfft", [
    (3, 100000, 1 << 21), (3, 2_000_000, 1 << 22), (3, 100000, 1 << 23),
    (3, 100000, 1 << 24), (3, 100000, 1 << 25), (3, 16_800_000, 1 << 25),
    (3, 100000, 1 << 26), (3, 100000, 1 << 27), (3, 67_000_000, 1 << 27)])
def test_noise_bootstrap_peaks_kernel_matches_plain(cuda, rows, n_samp, nfft):
    """K6 above 2^20 against its twin (the split to 2^24, the three-pass
    split above; 3 draws of a 1,520 s recording's length at 2^27)."""
    _noise_peaks(cuda, rows, n_samp, nfft)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_samp,nfft", [(3, 100000, 1 << 23),
                                              (3, 100000, 1 << 24),
                                              (3, 100000, 1 << 25),
                                              (3, 100000, 1 << 26),
                                              (3, 100000, 1 << 27)])
def test_noise_bootstrap_equals_bootstrap_on_its_draws(cuda, rows, n_samp,
                                                       nfft):
    """K6's peaks are K4b's element for element on the same draws, on the
    split past 2^22 and on the three-pass split from 2^25."""
    _noise_equals(cuda, rows, n_samp, nfft)


@pytest.mark.cuda
def test_bootstrap_chunks_by_bytes_keep_one_launch_bits(cuda, monkeypatch):
    """K6 at the default 1,000 draws of 2^23 takes two launches (512 and
    488 draws) whose scratch stays within ``SPLIT_SCRATCH_BYTES``; with the
    cap lowered to 8 rows a launch, K6, K4b and K4a at 2^23 give one
    launch's bits (each packed row pair on its own, each draw keyed by
    its own seed words), and K6 stays bit-equal to K4b on the same
    draws."""
    nfft, n_samp = 1 << 23, 4_200_000
    g = _gen(cuda, 5)
    s1 = cf.fft_real_plain(torch.randn((1, n_samp), generator=g,
                                       device=cuda), nfft)[0].contiguous()
    seeds = torch.randint(-2 ** 31, 2 ** 31, (1000, 2), generator=g,
                          dtype=torch.int32, device=cuda)
    cf.fft_real(s1.real[:32].reshape(2, 16).contiguous(), nfft)  # tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = cf.LAUNCHES["noise_bootstrap_peaks"]
    full = cf.noise_bootstrap_peaks(s1, seeds, n_samp, nfft)
    torch.cuda.synchronize()
    assert cf.LAUNCHES["noise_bootstrap_peaks"] == before + 2
    assert torch.cuda.max_memory_allocated() - base <= (
        cf.SPLIT_SCRATCH_BYTES + (1 << 20))
    assert bool(torch.isfinite(full).all())
    draws = noise_ops.uniform(seeds[:20], n_samp)
    x = torch.randn((11, n_samp), generator=g, device=cuda)
    boot = cf.bootstrap_peaks(s1, draws, nfft)
    spec = cf.fft_real(x, nfft)
    monkeypatch.setattr(cf, "SPLIT_SCRATCH_BYTES", 4 * nfft * 8)
    before = dict(cf.LAUNCHES)
    assert torch.equal(cf.noise_bootstrap_peaks(s1, seeds[:20], n_samp,
                                                nfft), full[:20])
    assert torch.equal(cf.bootstrap_peaks(s1, draws, nfft), boot)
    assert torch.equal(boot, full[:20])
    assert torch.equal(cf.fft_real(x, nfft), spec)
    for name, launches in (("noise_bootstrap_peaks", 3),
                           ("bootstrap_peaks", 3), ("fft_real", 3)):
        assert cf.LAUNCHES[name] == before[name] + launches, name


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,nfft,schedule", [
    (1, 600000, 1 << 21, 2048), (1, 2000000, 1 << 22, 2048),
    (1, 600000, 1 << 23, 2048), (1, 8400000, 1 << 24, 4096),
    (1, 600000, 1 << 25, 16384), (1, 16_800_000, 1 << 25, 16384),
    (1, 600000, 1 << 26, 32768), (1, 600000, 1 << 27, 65536),
    (3, 67000000, 1 << 27, 65536)])
def test_whitened_corr_kernel_matches_plain(cuda, rows, length, nfft,
                                            schedule):
    """K9 on the split at 2^21 and 2^22 (strips of 8 at 2,048), at 2^23
    (2,048 x 4,096: 8 columns, 4 rows) and 2^24 (4,096 x 4,096: 4 and
    4), and on the three-pass split above 2^24 (2^25 and 2^26; one and
    three row pairs of a 1,520 s recording's length at 2^27: 256 x 256 x
    2,048)."""
    _whitened_corr(cuda, rows, length, nfft, schedule)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,length,nfft,schedule", [
    (None, 4, 1046019, 1 << 21, 2048), (2, 3, 600000, 1 << 21, 2048),
    (None, 4, 2000000, 1 << 22, 2048), (None, 4, 4200000, 1 << 23, 2048),
    (None, 8, 4200000, 1 << 23, 2048), (None, 4, 8400000, 1 << 24, 4096),
    (None, 4, 16800000, 1 << 25, 16384),
    (None, 8, 16800000, 1 << 25, 16384), (2, 3, 600000, 1 << 25, 16384),
    (None, 4, 33000000, 1 << 26, 32768),
    (None, 4, 67000000, 1 << 27, 65536), (2, 3, 600000, 1 << 27, 65536)])
def test_gcc_all_pairs_schedules_match_plain(cuda, b, m, length, nfft,
                                             schedule):
    """K1 through the mic rows' spectra at 2^21 (a 23.7 s recording's 4
    mics, 2 scenes of 3 mics), 2^22, 2^23 (a 95 s recording's 4 and 8
    mics under ``max_expected_delay=None``) and 2^24 (190 s), and on the
    three-pass split at 2^25 (380 s: 4 and 8 mics; 2 scenes of 3 mics),
    2^26 (750 s) and 2^27 (1,520 s: 4 mics; 2 scenes of 3 mics, an odd
    pair count, mic rows packed across scenes)."""
    _gcc_schedules(cuda, b, m, length, nfft, schedule)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,length,nfft", [(1, 4, 1500000, 1 << 21),
                                             (1, 4, 3000000, 1 << 22),
                                             (1, 4, 6000000, 1 << 23),
                                             (1, 4, 12000000, 1 << 24),
                                             (1, 4, 24000000, 1 << 25),
                                             (1, 4, 48000000, 1 << 26)])
def test_gcc_spectra_routes_match_plain(cuda, b, m, length, nfft):
    """K1 and K2 through the mic rows' spectra at the fast path's 2^21 to
    2^26 recording lengths (34 s to 1,088 s at 44.1 kHz): on the split to
    2^24, on the three-pass split from 2^25."""
    _gcc_spectra(cuda, b, m, length, nfft)


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,paths,total,out,nfft,wq", [
    (1, 4, 1, 1600000, 1500000, 1 << 21, 21),
    (1, 4, 1, 3100000, 3000000, 1 << 22, 21),
    (2, 3, 3, 1600000, 1500000, 1 << 21, 21),
    (1, 4, 1, 6200000, 6000000, 1 << 23, 21),
    (1, 4, 1, 12400000, 12000000, 1 << 24, 21),
    (2, 3, 3, 6200000, 6000000, 1 << 23, 21),
    (2, 3, 3, 12400000, 12000000, 1 << 24, 21),
    (1, 4, 1, 24800000, 24000000, 1 << 25, 21),
    (2, 3, 3, 24800000, 24000000, 1 << 25, 21),
    (1, 4, 1, 49600000, 48000000, 1 << 26, 21)])
def test_render_spectra_route_matches_plain(cuda, scenes, m, paths, total,
                                            out, nfft, wq):
    """K3 through the base rows' spectra at the fast path's 2^21 to 2^26
    (the finish spread over the card; on the split to 2^24, on the
    three-pass split from 2^25) and 2 scenes of 3 mics and 3 paths at
    2^21, 2^23, 2^24 and 2^25 (mic rows packed across scenes, an odd pair
    count); K2 on its signals and K5, equal to K3 then K2 to the bit."""
    _render_spectra(cuda, scenes, m, paths, total, out, nfft, wq)


@pytest.mark.cuda
def test_device_kernels_per_call_above_2_20(cuda, tmp_path):
    """The design, not just the answer, above 2^20: K4a runs its two
    kernels on pairs of rows (strips of 8 columns, 4 at 2^24) to 2^24 and
    three on the three-pass split at 2^25 and 2^26, one row its
    half-length transform's (two on the split to 2^22 points, three on the
    three-pass split from 2^23), and K4b and K6 their three on the split to
    2^24 (``boot_rows``) and five from 2^25, not the radix-2 passes; K1
    four to 2^24 (K4a's two passes, K9's row pass, the column pass) and six
    from 2^25, K9 two and three; K1 and K2 four at 2^21, 2^23 and 2^24
    through the mic rows' spectra (``window_cols`` last for K2) and six at
    2^25 and 2^26; K3 eight with the finalize and the noise at 2^22 to
    2^24 (K4a's two passes into the base rows' spectra,
    ``render_spec_rows``, ``render_cols``, four steps of
    ``finish_spread``), ten at 2^25 and 2^26, and K5 K3's, then K2's;
    each kernel at its place in the call."""
    seeds = torch.randint(-2 ** 31, 2 ** 31, (3, 2), generator=_gen(cuda),
                          dtype=torch.int32, device=cuda)
    long_cols = ("long_cols_a", "long_cols_b", "fft_real_rows")
    for rows, length, nfft in ((2, 1_046_019, 1 << 21),
                               (2, 2_000_000, 1 << 22),
                               (2, 4_200_000, 1 << 23),
                               (2, 8_400_000, 1 << 24),
                               (2, 16_800_000, 1 << 25),
                               (2, 33_000_000, 1 << 26)):
        long = nfft > cf.FFT_SPLIT_MAX
        xl = torch.randn((rows, length), generator=_gen(cuda),
                         device=cuda)
        names = _device_kernels(lambda: cf.fft_real(xl, nfft),
                                tmp_path / "k4a_long.json")
        want = long_cols if long else ("fft_real_cols", "fft_real_rows")
        assert len(names) == len(want), (nfft, names)
        assert all(w in n for w, n in zip(want, names)), names
        names = _device_kernels(lambda: cf.fft_real(xl[:1], nfft),
                                tmp_path / "k4a_half.json")
        want = (long_cols if nfft >= 2 * cf.HALF_LONG_MIN
                else ("fft_real_cols", "fft_real_rows"))
        assert len(names) == len(want), (nfft, names)
        assert all(w in n for w, n in zip(want, names)), names
        assert "HalfLoad" in names[0], names
        s1 = cf.fft_real(xl[:1], nfft)[0].contiguous()
        names = _device_kernels(lambda: cf.bootstrap_peaks(s1, xl, nfft),
                                tmp_path / "k4b_long.json")
        want = (("long_cols_a", "long_cols_b", "boot_rows_long",
                 "long_cols_b", "long_cols_max") if long else
                ("fft_real_cols", "boot_rows", "boot_cols"))
        assert len(names) == len(want), (nfft, names)
        assert all(w in n for w, n in zip(want, names)), names
        names = _device_kernels(
            lambda: cf.noise_bootstrap_peaks(s1, seeds[:rows], length, nfft),
            tmp_path / "k6_long.json")
        assert len(names) == len(want), (nfft, names)
        assert "NoiseLoad" in names[0] and want[-1] in names[-1], names
        del xl
    g = _gen(cuda, 8)
    pi, pj = _pairs(4)
    for length, nfft in ((1046019, 1 << 21), (2000000, 1 << 22),
                         (4200000, 1 << 23), (8400000, 1 << 24),
                         (16800000, 1 << 25), (33000000, 1 << 26)):
        long = nfft > cf.FFT_SPLIT_MAX
        sig = torch.randn((4, length), generator=g, device=cuda)
        mask = cf.band_mask(nfft, None, None, device=cuda)
        names = _device_kernels(
            lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
            tmp_path / f"k1_{nfft}.json")
        want = (long_cols + ("corr_rows_long", "long_cols_b",
                             "long_cols_corr") if long else
                ("fft_real_cols", "fft_real_rows", "corr_rows", "corr_cols"))
        assert len(names) == len(want), names
        assert all(w in n for w, n in zip(want, names)), names
        spec = cf.fft_real(torch.randn((2, 4000), generator=g, device=cuda),
                           nfft)
        a, b = spec[:1].contiguous(), spec[1:].contiguous()
        names = _device_kernels(lambda: cf.whitened_corr(a, b, mask, nfft),
                                tmp_path / f"k9_{nfft}.json")
        want = (("corr_rows_long", "long_cols_b", "long_cols_corr") if long
                else ("corr_rows", "corr_cols"))
        assert len(names) == len(want), names
        assert all(w in n for w, n in zip(want, names)), names
    g = _gen(cuda, 21)
    for length, nfft in ((1500000, 1 << 21), (6000000, 1 << 23),
                         (12000000, 1 << 24), (24000000, 1 << 25),
                         (48000000, 1 << 26)):
        long = nfft > cf.FFT_SPLIT_MAX
        sig = torch.randn((1, 4, length), generator=g, device=cuda)
        mask = cf.band_mask(nfft, (300.0, 3400.0), 44100.0, device=cuda)
        k1 = _device_kernels(lambda: cf.gcc_all_pairs(sig, pi, pj, nfft,
                                                      mask),
                             tmp_path / "k1_spectra.json")
        k2 = _device_kernels(lambda: cf.gcc_windowed(sig, pi, pj, nfft, 21,
                                                     mask),
                             tmp_path / "k2_spectra.json")
        want = (long_cols + ("corr_rows_long", "long_cols_b") if long
                else ("fft_real_cols", "fft_real_rows", "corr_rows"))
        assert len(k1) == len(k2) == len(want) + 1, (nfft, k1, k2)
        assert all(w in a and w in b for w, a, b in zip(want, k1, k2))
        last = ("long_cols_corr", "long_cols_window") if long else (
            "corr_cols", "window_cols")
        assert last[0] in k1[-1] and last[1] in k2[-1], (k1, k2)
        del sig
    for total, out, nfft in ((3100000, 3000000, 1 << 22),
                             (6200000, 6000000, 1 << 23),
                             (12400000, 12000000, 1 << 24),
                             (24800000, 24000000, 1 << 25),
                             (49600000, 48000000, 1 << 26)):
        if nfft > cf.FFT_SPLIT_MAX:
            render = list(long_cols) + ["render_spec_rows_long",
                                        "long_cols_b", "long_cols_render"]
            gcc = list(long_cols) + ["corr_rows_long", "long_cols_b",
                                     "long_cols_window"]
        else:
            render = ["fft_real_cols", "fft_real_rows", "render_spec_rows",
                      "render_cols"]
            gcc = ["fft_real_cols", "fft_real_rows", "corr_rows",
                   "window_cols"]
        render += ["finish_spread"] * 4
        base, tau, gains, snr, seeds3, fade = _scene_inputs(
            cuda, 1, 4, 1, total, out, 21)
        mask = cf.band_mask(nfft, (300.0, 3400.0), 44100.0, device=cuda)
        k3 = _device_kernels(
            lambda: cf.delay_sum(base, tau, gains, nfft, out, fade, True,
                                 snr, seeds3), tmp_path / "k3_long.json")
        k5 = _device_kernels(
            lambda: cf.scene_windowed(base, tau, gains, pi, pj, nfft, out,
                                      21, fade, mask, snr, seeds3),
            tmp_path / "k5_long.json")
        assert len(k3) == len(render), (nfft, k3)
        assert all(w in n for w, n in zip(render, k3)), k3
        assert len(k5) == len(render + gcc), (nfft, k5)
        assert all(w in n for w, n in zip(render + gcc, k5)), k5
        del base


@pytest.mark.cuda
def test_device_kernels_per_call_above_2_26(cuda, tmp_path):
    """The three-pass split at 2^27 (a 1,520 s recording): K4a runs three
    kernels (passes A and B, ``long_cols_a`` and ``long_cols_b``, then
    ``fft_real_rows``; one row's half-length transform of 2^26 points,
    ``HalfLoad``), K4b and K6 five (A, B, ``boot_rows_long``, B' and
    A' with the maxima, ``long_cols_max``; K6's first with its
    ``NoiseLoad``), K9 three (``corr_rows_long``, B', A' with the
    correlations, ``long_cols_corr``) and K1 six (K4a's three into the
    mic rows' spectra, then K9's three with the pair-indexed loader), each
    kernel at its place in the call; each against its twin and K6 equal
    to K4b on the same draws."""
    nfft, length = 1 << 27, 67_000_000
    g = _gen(cuda, 27)
    x = torch.randn((3, length), generator=g, device=cuda)
    names = _device_kernels(lambda: cf.fft_real(x[:1], nfft),
                            tmp_path / "k4a_27.json")
    assert len(names) == 3, names
    assert all(w in n for w, n in zip(
        ("long_cols_a", "long_cols_b", "fft_real_rows"), names)), names
    assert "HalfLoad" in names[0], names
    got = cf.fft_real(x[:1], nfft)
    want = cf.fft_real_plain(x[:1], nfft)
    assert float((got - want).abs().max()) < 5e-6 * float(want.abs().max())
    s1 = want[0].contiguous()
    boot = ("long_cols_a", "long_cols_b", "boot_rows_long", "long_cols_b",
            "long_cols_max")
    names = _device_kernels(lambda: cf.bootstrap_peaks(s1, x, nfft),
                            tmp_path / "k4b_27.json")
    assert len(names) == 5 and all(w in n for w, n in zip(boot, names)), \
        names
    seeds = torch.randint(-2 ** 31, 2 ** 31, (3, 2), generator=g,
                          dtype=torch.int32, device=cuda)
    names = _device_kernels(
        lambda: cf.noise_bootstrap_peaks(s1, seeds, length, nfft),
        tmp_path / "k6_27.json")
    assert len(names) == 5 and all(w in n for w, n in zip(boot, names)), \
        names
    assert "NoiseLoad" in names[0], names
    del x
    draws = noise_ops.uniform(seeds, length)
    assert torch.equal(cf.noise_bootstrap_peaks(s1, seeds, length, nfft),
                       cf.bootstrap_peaks(s1, draws, nfft))
    del draws
    mask = cf.band_mask(nfft, None, None, device=cuda)
    a, b = s1[None], cf.fft_real_plain(
        torch.randn((1, length), generator=g, device=cuda), nfft)
    corr = ("corr_rows_long", "long_cols_b", "long_cols_corr")
    names = _device_kernels(lambda: cf.whitened_corr(a, b, mask, nfft),
                            tmp_path / "k9_27.json")
    assert len(names) == 3 and all(w in n for w, n in zip(corr, names)), \
        names
    del a, b
    sig = torch.randn((4, length), generator=g, device=cuda)
    pi, pj = _pairs(4)
    names = _device_kernels(lambda: cf.gcc_all_pairs(sig, pi, pj, nfft,
                                                     mask),
                            tmp_path / "k1_27.json")
    k1 = ("long_cols_a", "long_cols_b", "fft_real_rows") + corr
    assert len(names) == 6 and all(w in n for w, n in zip(k1, names)), \
        names
    assert "PairIndexLoad" in names[3], names


# K3, K2 and K5 on the three-pass split: (scenes, mics, paths, padded
# length, samples, nfft, wq) of the fast path's one scene of 4 mics at
# 2^27 (chip_smoke.py's FAST_SAMPLES: 2,177 s at 44.1 kHz) and 2 scenes of
# 3 mics and 3 paths at 2^27 (mic rows packed across scenes, an odd pair
# count).
THREE_PASS_SCENES = [(1, 4, 1, 99200000, 96000000, 1 << 27, 21),
                     (2, 3, 3, 6200000, 6000000, 1 << 27, 21)]


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,paths,total,out,nfft,wq",
                         THREE_PASS_SCENES)
def test_three_pass_scene_kernels_match_plain(cuda, scenes, m, paths, total,
                                              out, nfft, wq):
    """K3 on the three-pass split (K4a's three passes into the base rows'
    spectra, ``render_spec_rows_long``, B', ``long_cols_render`` and the
    finish spread over the card) with the finalize and the noise within
    2e-5 of its twin, raw within 2e-5 of the peak; K2 on its signals (the
    three-pass split through the mic rows' spectra, ``long_cols_window``)
    within 1e-6 plus its float32 twin's distance from its float64 run,
    pair by pair, with equal argmaxes; K5 within 1e-5 of its twin and
    equal to K3 then K2 to the bit; one launch a call each."""
    assert cf.render_route(nfft).kind == cf.gcc_route(nfft, m).kind == (
        cf.ROUTE_LONG)
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, scenes, m,
                                                       paths, total, out, 27)
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
    gap = max(float((w2[..., p, :].double() - cf.gcc_windowed_plain(
        sigs.double(), pi[p:p + 1], pj[p:p + 1], nfft, wq,
        mask.double())[0][..., 0, :]).abs().max()) for p in range(len(pi)))
    torch.cuda.synchronize()
    assert float((win - w2).abs().max()) < 1e-6 + gap
    assert torch.equal(stats[..., 2], s2[..., 2])
    assert float((stats[..., :2] - s2[..., :2]).abs().max()) < 1e-6 + gap
    del w2, s2
    fused = cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq, fade,
                              mask, snr, seeds)
    torch.cuda.synchronize()
    assert (cf.LAUNCHES["delay_sum"], cf.LAUNCHES["gcc_windowed"],
            cf.LAUNCHES["scene_windowed"]) == (2, 1, 1)
    assert torch.equal(fused[0], win) and torch.equal(fused[1], stats)
    del sigs
    w5, _ = cf.scene_windowed_plain(base, tau, gains, pi, pj, nfft, out, wq,
                                    fade, mask, snr, seeds)
    torch.cuda.synchronize()
    assert float((fused[0] - w5).abs().max()) < 1e-5


@pytest.mark.cuda
def test_three_pass_scene_device_kernels_per_call(cuda, tmp_path):
    """The design at 2^27 (one scene of 4 mics): K3 runs K4a's three
    passes into the base rows' spectra, ``render_spec_rows_long``, B' and
    ``long_cols_render``, then four steps of ``finish_spread``; K2 K4a's
    three into the mic rows' spectra, ``corr_rows_long`` with the
    pair-indexed loader, B' and ``long_cols_window``; K5 K3's ten, then
    K2's six over the finished signals (``PackedLoad``): each kernel at
    its place in the call, and none outside the route's."""
    nfft, total, out = 1 << 27, 99200000, 96000000
    base, tau, gains, snr, seeds, fade = _scene_inputs(cuda, 1, 4, 1, total,
                                                       out, 28)
    pi, pj = _pairs(4)
    mask = cf.band_mask(nfft, (300.0, 3400.0), 44100.0, device=cuda)
    render = ["long_cols_a", "long_cols_b", "fft_real_rows",
              "render_spec_rows_long", "long_cols_b", "long_cols_render"]
    render += ["finish_spread"] * 4
    gcc = ["long_cols_a", "long_cols_b", "fft_real_rows", "corr_rows_long",
           "long_cols_b", "long_cols_window"]
    k3 = _device_kernels(
        lambda: cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr,
                             seeds), tmp_path / "k3_27.json")
    assert len(k3) == len(render), k3
    assert all(w in n for w, n in zip(render, k3)), k3
    sigs = cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    k2 = _device_kernels(
        lambda: cf.gcc_windowed(sigs, pi, pj, nfft, 21, mask),
        tmp_path / "k2_27.json")
    assert len(k2) == len(gcc), k2
    assert all(w in n for w, n in zip(gcc, k2)), k2
    assert "PairIndexLoad" in k2[3], k2
    del sigs
    k5 = _device_kernels(
        lambda: cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, 21,
                                  fade, mask, snr, seeds),
        tmp_path / "k5_27.json")
    assert len(k5) == len(render + gcc), k5
    assert all(w in n for w, n in zip(render + gcc, k5)), k5
    assert "PackedLoad" in k5[len(render)], k5
    for name in k3 + k2 + k5:
        assert any(w in name for w in render + gcc), name

"""The CUDA kernels against their plain PyTorch twins on the card above
2^20 points: K4a's, K4b's and K6's split to 2^24 and their radix-2 passes
above, K9's, K1's, K2's, K3's and K5's shapes from 2^21 to 2^22, and
the device kernels a call runs there.

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
    _device_kernels, _gen, _pairs, cuda)
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
# the rows above 2^22), the radix-2 passes above.
LONG_N1 = {1 << 21: 2048, 1 << 22: 2048, 1 << 23: 2048, 1 << 24: 4096,
           1 << 25: 0}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,nfft", [
    (2, 1_046_019, 1 << 21), (3, 1_046_019, 1 << 21), (1, 2_000_000, 1 << 22),
    (3, 4_000_000, 1 << 23), (1, 8_400_000, 1 << 24), (2, 600_000, 1 << 25)])
def test_fft_real_runs_the_passes_above_2_20(cuda, rows, length, nfft):
    """Above 2^20 K4a runs the four-step split with strips of 8 columns
    (``split_strips``) at 2^21 (a 23.7 s recording at 44.1 kHz, the
    bootstrap's spectrum; 2,048 x 1,024) and 2^22 (2,048 x 2,048, pass 2's
    strips 8 rows), with the long side in the rows at 2^23 (2,048 x 4,096,
    pass 2's strips 4 rows) and 2^24 (4,096 x 4,096, 4 columns, 4 rows),
    and above its largest split (2^24) packs the rows, runs the radix-2
    passes (one launch a pass) and splits the two spectra (2^25): each
    against its twin, relative to the spectrum's peak."""
    assert cf._split_n1(nfft) == LONG_N1[nfft]
    x = torch.randn((rows, length), generator=_gen(cuda), device=cuda)
    before = cf.LAUNCHES["fft_real"]
    got = cf.fft_real(x, nfft)
    assert cf.LAUNCHES["fft_real"] == before + 1
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
    (3, 100000, 1 << 23), (3, 100000, 1 << 24), (3, 100000, 1 << 25)])
def test_bootstrap_peaks_kernel_matches_plain(cuda, rows, length, nfft):
    """K4b above 2^20: at 2^21 strips of 8 columns, at 2^22 8 columns and
    8 rows, at 2^23 8 columns and 4 rows of 4,096, at 2^24 4 and 4, and the
    radix-2 passes above 2^24."""
    _bootstrap_peaks(cuda, rows, length, nfft)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_samp,nfft", [
    (3, 100000, 1 << 21), (3, 2_000_000, 1 << 22), (3, 100000, 1 << 23),
    (3, 100000, 1 << 24), (3, 100000, 1 << 25)])
def test_noise_bootstrap_peaks_kernel_matches_plain(cuda, rows, n_samp, nfft):
    """K6 above 2^20 against its twin (the split to 2^24, the passes
    above)."""
    _noise_peaks(cuda, rows, n_samp, nfft)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_samp,nfft", [(3, 100000, 1 << 23),
                                              (3, 100000, 1 << 24)])
def test_noise_bootstrap_equals_bootstrap_on_its_draws(cuda, rows, n_samp,
                                                       nfft):
    """K6's peaks are K4b's element for element on the same draws, on the
    split past 2^22."""
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
    cf.fft_real(s1.real[None, :16].contiguous(), nfft)   # twiddles cached
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
                           ("bootstrap_peaks", 3), ("fft_real", 2)):
        assert cf.LAUNCHES[name] == before[name] + launches, name


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,nfft,schedule", [
    (1, 600000, 1 << 21, 2048), (1, 2000000, 1 << 22, 2048),
    (1, 600000, 1 << 23, 0)])
def test_whitened_corr_kernel_matches_plain(cuda, rows, length, nfft,
                                            schedule):
    """K9 on the split at 2^21 and 2^22 (strips of 8 at 2,048) and on the
    passes above 2^22."""
    _whitened_corr(cuda, rows, length, nfft, schedule)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,length,nfft,schedule", [
    (None, 4, 1046019, 1 << 21, 2048), (2, 3, 600000, 1 << 21, 2048),
    (None, 4, 2000000, 1 << 22, 2048)])
def test_gcc_all_pairs_schedules_match_plain(cuda, b, m, length, nfft,
                                             schedule):
    """K1 through the mic rows' spectra at 2^21 (a 23.7 s recording's 4
    mics, 2 scenes of 3 mics) and 2^22."""
    _gcc_schedules(cuda, b, m, length, nfft, schedule)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,length,nfft", [(1, 4, 1500000, 1 << 21),
                                             (1, 4, 3000000, 1 << 22)])
def test_gcc_spectra_routes_match_plain(cuda, b, m, length, nfft):
    """K1 and K2 through the mic rows' spectra at the fast path's 2^21 and
    2^22 recording lengths."""
    _gcc_spectra(cuda, b, m, length, nfft)


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,m,paths,total,out,nfft,wq", [
    (1, 4, 1, 1600000, 1500000, 1 << 21, 21),
    (1, 4, 1, 3100000, 3000000, 1 << 22, 21),
    (2, 3, 3, 1600000, 1500000, 1 << 21, 21)])
def test_render_spectra_route_matches_plain(cuda, scenes, m, paths, total,
                                            out, nfft, wq):
    """K3 through the base rows' spectra at the fast path's 2^21 and 2^22
    (the finish spread over the card) and 2 scenes of 3 mics and 3 paths
    at 2^21 (mic rows packed across scenes, an odd pair count)."""
    _render_spectra(cuda, scenes, m, paths, total, out, nfft, wq)


@pytest.mark.cuda
def test_device_kernels_per_call_above_2_20(cuda, tmp_path):
    """The design, not just the answer, above 2^20: K4a runs its two
    kernels (two rows of a 23.7 s pair at 2^21, three at 2^22 and 2^23,
    one at 2^24: strips of 8 columns, 4 at 2^24) and K4b and K6 their
    three, not the radix-2 passes; K1 four at 2^21 and 2^22 (K4a's two
    passes, K9's row pass, the column pass), K9 two there; K1 and K2 four
    at 2^21 through the mic rows' spectra (``window_cols`` last for K2),
    no radix-2 pass."""
    seeds = torch.randint(-2 ** 31, 2 ** 31, (3, 2), generator=_gen(cuda),
                          dtype=torch.int32, device=cuda)
    for rows, length, nfft in ((2, 1_046_019, 1 << 21),
                               (3, 2_000_000, 1 << 22),
                               (3, 4_200_000, 1 << 23),
                               (1, 8_400_000, 1 << 24)):
        xl = torch.randn((rows, length), generator=_gen(cuda),
                         device=cuda)
        names = _device_kernels(lambda: cf.fft_real(xl, nfft),
                                tmp_path / "k4a_long.json")
        assert len(names) == 2, (nfft, names)
        assert "fft_real_cols" in names[0] and "fft_real_rows" in names[1]
        s1 = cf.fft_real(xl[:1], nfft)[0].contiguous()
        names = _device_kernels(lambda: cf.bootstrap_peaks(s1, xl, nfft),
                                tmp_path / "k4b_long.json")
        assert len(names) == 3, (nfft, names)
        assert ("fft_real_cols" in names[0] and "boot_rows" in names[1]
                and "boot_cols" in names[2]), names
        names = _device_kernels(
            lambda: cf.noise_bootstrap_peaks(s1, seeds[:rows], length, nfft),
            tmp_path / "k6_long.json")
        assert len(names) == 3, (nfft, names)
        assert "NoiseLoad" in names[0] and "boot_cols" in names[2], names
        del xl
    g = _gen(cuda, 8)
    pi, pj = _pairs(4)
    for length, nfft in ((1046019, 1 << 21), (2000000, 1 << 22)):
        sig = torch.randn((4, length), generator=g, device=cuda)
        mask = cf.band_mask(nfft, None, None, device=cuda)
        names = _device_kernels(
            lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
            tmp_path / f"k1_{nfft}.json")
        want = ("fft_real_cols", "fft_real_rows", "corr_rows", "corr_cols")
        assert len(names) == 4, names
        assert all(w in n for w, n in zip(want, names)), names
        spec = cf.fft_real(torch.randn((2, 4000), generator=g, device=cuda),
                           nfft)
        a, b = spec[:1].contiguous(), spec[1:].contiguous()
        names = _device_kernels(lambda: cf.whitened_corr(a, b, mask, nfft),
                                tmp_path / f"k9_{nfft}.json")
        assert len(names) == 2, names
        assert "corr_rows" in names[0] and "corr_cols" in names[1], names
    g = _gen(cuda, 21)
    sig = torch.randn((1, 4, 1500000), generator=g, device=cuda)
    nfft = 1 << 21
    mask = cf.band_mask(nfft, (300.0, 3400.0), 44100.0, device=cuda)
    k1 = _device_kernels(lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
                         tmp_path / "k1_spectra.json")
    k2 = _device_kernels(lambda: cf.gcc_windowed(sig, pi, pj, nfft, 21,
                                                 mask),
                         tmp_path / "k2_spectra.json")
    want = ("fft_real_cols", "fft_real_rows", "corr_rows")
    assert len(k1) == len(k2) == 4, (k1, k2)
    assert all(w in a and w in b for w, a, b in zip(want, k1, k2))
    assert "corr_cols" in k1[3] and "window_cols" in k2[3], (k1, k2)
    for name in k1 + k2:
        assert not any(p in name for p in (
            "stockham_pass", "pack_rows", "gcc_cross", "last_pass_window",
            "split_pairs")), name

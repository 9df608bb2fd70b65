"""The three-pass split of every transforming kernel above the split's
one limit ``FFT_SPLIT_MAX`` (2^24), from 2^25 to 2^30, checked on the
CPU: the rules that pick its shapes, strips, shared memory and launches
(``cuda_fft.fft_real_split``, ``three_pass_shape``, ``long_plan``,
``_split_n1``, ``_launch_rows``), the limit of K4a, K4b, K6 and the
spectra routes of K9, K1, K2, K3 and K5 (``gcc_route``,
``render_route``, ``corr_schedule``), its twiddle tables (the half
tables and pass B's three, ``_twiddle_lengths``, ``tw3_sizes``), its
plan and limits at 2^25 to 2^30, one block's maps at 2^25 to 2^27 by
index arithmetic, and a float64 numpy model of its passes (A and B, K4a's
row pass, ``boot_rows_long``, B' and A' with the maxima; K9's and the
GCCs' ``corr_rows_long`` and A' with the correlations or with K2's window
and statistics; K3's ``render_spec_rows_long``, A' into the render's
second buffer and the finish) whose factors n1a x n1b x n2 are the
model's arguments, small, against ``np.fft``, the float64 twins and the
JAX package.  No n-point table above 2^20 is built here: at 2^27 it
holds 2^26 entries.
"""

import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
import test_torch_fft_schedule as fs

# The three-pass split at 2^25 and 2^26: (n1a, n1b), rows a launch
# (``_launch_rows``) and the column passes' bytes (pass A, pass B).
LONG = {25: ((128, 128), 128, (16_896, 26_112)),
        26: ((256, 128), 64, (33_792, 27_136))}


def pass_b_twiddle(n, e):
    """Pass B's W_n^e (``Tw3`` in ``csrc/kernels.cu``): the product of
    three full-circle tables of ``cuda_fft.tw3_sizes(n)`` (in float64),
    T2[e >> 2b] * T1[(e >> b) mod 2^b] * T0[e mod 2^b], b = ceil(log2(n) /
    3), every index within its table."""
    (c0, _), (c1, s1), (c2, s2) = cf.tw3_sizes(n)
    b = s1.bit_length() - 1
    i2, i1, i0 = e >> (2 * b), (e >> b) & (c1 - 1), e & (c0 - 1)
    assert s2 == 1 << (2 * b) and i2.max() < c2
    tab = [np.exp(-2j * np.pi * np.arange(c) * s / n)
           for c, s in cf.tw3_sizes(n)]
    return tab[2][i2] * tab[1][i1] * tab[0][i0]


@pytest.mark.parametrize("bits", [25, 26])
def test_long_split_plan(bits):
    """At 2^25 and 2^26, past ``FFT_SPLIT_MAX`` (2^24), K4a, K4b and K6
    run the three-pass split: rows of 2,048 points, n1 = 16,384 = 128 x
    128 and 32,768 = 256 x 128, both column passes in strips of 16 columns
    (whole 32-byte sectors of each row, where the split would take 4 and 2
    columns with its n2-point table in device memory), K4a's row pass in
    strips of 8 rows at any batch (runs of 4 bins), ``boot_rows_long``'s
    of 2 rows; 128 and 64 rows a launch under the 16 GiB scratch cap; the
    half tables of n1, n2, n1a and n1b after the n-point one.  Every block
    holds at most ``BLOCK_POINTS`` points in at most ``SMEM_OPTIN``
    bytes."""
    n = 1 << bits
    (n1a, n1b), rows, (a_smem, b_smem) = LONG[bits]
    n1 = n1a * n1b
    assert cf.fft_real_split(n) == (n1, 2048)
    assert cf.three_pass_shape(n) == (n1a, n1b, 2048)
    assert cf._split_n1(n) == n1 and cf._split_strips(n1, n) == (16, 2)
    assert cf._long_n1a(n) == n1a
    assert cf._launch_rows(n1, n) == rows
    assert rows * n * 8 // 2 <= cf.SPLIT_SCRATCH_BYTES
    for packed in (1, 2, 64):
        plan = cf.long_plan(n, packed)
        assert (plan.n1a, plan.n1b) == (n1a, n1b)
        assert plan.cols_a == (16, a_smem) and plan.cols_b == (16, b_smem)
        assert plan.rows == (8, 139_392)
        assert plan.boot_rows == plan.corr_rows == (2, 41_088)
        for step, length in ((plan.cols_a, n1a), (plan.cols_b, n1b),
                             (plan.rows, 2048), (plan.boot_rows, 2048)):
            assert step.strip * length <= cf.BLOCK_POINTS
            assert step.smem <= cf.SMEM_OPTIN
    with pytest.raises(ValueError):
        cf.split_plan(n)
    assert cf._twiddle_lengths(n) == [n, n1, 2048, n1a, n1b]


def test_passes_above_2_26(monkeypatch):
    """Above ``FFT_SPLIT_MAX`` no kernel runs radix-2 passes.  At 2^27
    K4a, K4b and K6 take the three-pass split (``long_plan``): n1 = 256 x
    256 with n2 = 2,048, column strips of 16, row strips of 2, one copy of
    the packed rows' scratch (32 rows a launch under the 16 GiB cap), the
    n1a- and n1b-point half tables after the n-, n1- and n2-point ones;
    ``split_plan`` still plans the two-pass split alone.  From 2^9 to 2^30
    every route of K1, K2, K3 and K5 (``gcc_route`` at 2 to 16 mics,
    ``render_route``) is one of the split kinds — one block, ``gcc_rows``
    / ``render_rows``, the spectra on the split or in one block, the
    three-pass split above 2^24 — with an n1 > 0; past
    ``FFT_LONG_MAX`` the routes and every wrapper raise (the CUDA branch
    forced on CPU tensors, nothing launched)."""
    n = 1 << 27
    assert cf.FFT_SPLIT_MAX == 1 << 24 < n
    assert cf._split_n1(n) == 65536 and cf._long_n1a(n) == 256
    assert cf._split_strips(65536, n) == (16, 2)
    with pytest.raises(ValueError):
        cf.split_plan(n)
    assert cf._launch_rows(65536, n) == 32
    assert (32 // 2) * n * 8 <= cf.SPLIT_SCRATCH_BYTES
    assert cf._twiddle_lengths(n) == [n, 65536, 2048, 256, 256]
    assert cf.corr_schedule(n) == 65536 and cf._corr_strips(n) == (16, 2)
    kinds = {cf.ROUTE_BLOCK, cf.ROUTE_ROWS, cf.ROUTE_SPECTRA,
             cf.ROUTE_SPECTRA_BLOCK, cf.ROUTE_LONG}
    assert set(cf.ROUTE_NAMES) == kinds and not hasattr(cf, "ROUTE_PASSES")
    for bits in range(9, 31):
        nfft = 1 << bits
        routes = [cf.render_route(nfft)] + [cf.gcc_route(nfft, m)
                                            for m in range(2, 17)]
        for route in routes:
            assert route.kind in kinds and route.n1 > 0
            assert (route.kind == cf.ROUTE_LONG) == (bits > 24)
    big = 2 * cf.FFT_LONG_MAX
    for rule in (cf.render_route, lambda x: cf.gcc_route(x, 4)):
        with pytest.raises(ValueError, match="FFT_LONG_MAX"):
            rule(big)
    launched = []
    monkeypatch.setattr(cf, "_use_plain", lambda *tensors: False)
    monkeypatch.setattr(cf, "_launch", lambda *a: launched.append(a))
    sig, mask = torch.zeros(1, 4, 100), torch.ones(8)
    base, fade = torch.zeros(1, 100), torch.ones(100)
    tau, gains = torch.zeros(1, 4, 1), torch.ones(1, 4, 1)
    pi, pj = fs._pairs(4)
    calls = (lambda: cf.gcc_all_pairs(sig, pi, pj, big, mask),
             lambda: cf.gcc_windowed(sig, pi, pj, big, 1, mask),
             lambda: cf.delay_sum(base, tau, gains, big, 100, fade, True),
             lambda: cf.scene_windowed(base, tau, gains, pi, pj, big, 100,
                                       1, fade, mask))
    for call in calls:
        with pytest.raises(ValueError, match="FFT_LONG_MAX"):
            call()
    assert not launched


# The three-pass split at 2^27 to 2^30: (n1a, n1b), rows a launch under
# the 16 GiB cap (``_launch_rows``) and the column passes' bytes (pass A,
# pass B with its three twiddle tables); K4a's row pass holds 139,392
# bytes, the other row passes 41,088.
THREE = {27: ((256, 256), 32, (33_792, 46_080)),
         28: ((512, 256), 16, (67_584, 52_224)),
         29: ((512, 512), 8, (67_584, 88_064)),
         30: ((1024, 512), 4, (135_168, 92_160))}


@pytest.mark.parametrize("bits", [27, 28, 29, 30])
def test_three_pass_plan(bits):
    """``long_plan`` at 2^27 to 2^30: n = n1 x 2,048 (``LONG_N2``) with
    n1 = n1a x n1b; both column passes in strips of 16 columns (128 bytes
    of each row a block reads or writes, whole 32-byte sectors), at most
    ``BLOCK_POINTS`` points and ``SMEM_OPTIN`` bytes a block
    (``long_cols_max`` 128 more; ``long_cols_corr`` pass A's; pass B its
    three twiddle tables, ``tw3_sizes``); K4a's row pass in strips of 8
    rows (4 rows k1 and their partners: runs of 4 bins), the other row
    passes in strips of 2 rows at any batch (row k1 and its partner),
    41,088 bytes in 256 threads; the launches' rows, grids within their
    limits and the int index products below 2^31; the entry points'
    arguments (n1, strips, n1a), K9's and those of the routes of K1, K2,
    K3 and K5 too."""
    n = 1 << bits
    (n1a, n1b), rows, (a_smem, b_smem) = THREE[bits]
    n1, n2 = cf.fft_real_split(n)
    assert (n1, n2) == (n1a * n1b, 2048)
    for packed in (1, 2, 64):
        plan = cf.long_plan(n, packed)
        assert (plan.n1a, plan.n1b) == (n1a, n1b)
        assert plan.cols_a == (16, a_smem) and plan.cols_b == (16, b_smem)
        assert plan.rows == (8, 139_392)
        assert plan.boot_rows == plan.corr_rows == (2, 41_088)
        assert plan.corr_cols == plan.cols_a
        assert plan.rows.strip == cf.fft_real_rows_strip(n2, packed)
        for step, length in ((plan.cols_a, n1a), (plan.cols_b, n1b),
                             (plan.rows, n2), (plan.boot_rows, n2),
                             (plan.corr_rows, n2), (plan.corr_cols, n1a)):
            assert step.strip * length <= cf.BLOCK_POINTS
            assert step.smem <= cf.SMEM_OPTIN
        assert plan.cols_a.smem + 128 <= cf.SMEM_OPTIN
        assert 8 * plan.cols_a.strip >= 128
    assert max(n1a, n1b) * 16 <= cf.BLOCK_POINTS
    assert cf.SPLIT_STRIPS[0] == 16
    assert cf._split_n1(n) == n1 and cf._long_n1a(n) == n1a
    assert cf._split_strips(n1, n) == (16, 2)
    assert cf._launch_rows(n1, n) == rows
    assert rows * n * 8 // 2 <= cf.SPLIT_SCRATCH_BYTES
    assert cf._twiddle_lengths(n) == [n, n1, n2, n1a, n1b]
    # Grids: pass A (n1b * n2/16, packed), pass B (n1a * n2/16, packed),
    # the row passes (n1/2, packed); every index product in int (n - 1,
    # j2 * k1, the spectra's 2 bins + k) below 2^31.
    assert n1b * n2 // 16 < 2 ** 31 and n1a * n2 // 16 < 2 ** 31
    assert (rows + 1) // 2 <= cf._MAX_GRID_Y
    assert n - 1 < 2 ** 31 and (n2 - 1) * (n1 - 1) < 2 ** 31
    assert (n // 2 + 1) + n // 2 < 2 ** 31
    # K9 and K1: n1, strips (16 columns, 2 rows) and n1a as K4a's;
    # ``corr_rows_long``'s 1,024 threads, ``long_cols_corr``'s n1a.
    assert cf.corr_schedule(n) == n1 and cf._corr_strips(n) == (16, 2)
    long = cf.GccRoute(cf.ROUTE_LONG, n1, 16, 2)
    assert cf.gcc_route(n, 4) == cf.render_route(n) == long
    assert n2 * plan.corr_rows.strip // 16 == 256 and n1a <= 1024


def test_long_limit():
    """The three-pass split ends at ``FFT_LONG_MAX`` = 2^30, the largest
    nfft whose int n the entry points take: past it every wrapper raises
    (``_check_pow2``; before, 2^31 wrapped to a negative int in ctypes),
    and so do the plans; ``long_plan`` plans only above ``FFT_SPLIT_MAX``."""
    assert cf.FFT_LONG_MAX == 1 << 30
    cf._check_pow2(cf.FFT_LONG_MAX)
    for bad in (2 * cf.FFT_LONG_MAX, 3, 100):
        with pytest.raises(ValueError):
            cf._check_pow2(bad)
    with pytest.raises(ValueError):
        cf.fft_real_split(2 * cf.FFT_LONG_MAX)
    for bad in (cf.FFT_SPLIT_MAX, 2 * cf.FFT_LONG_MAX):
        with pytest.raises(ValueError):
            cf.long_plan(bad)


# ---------------------------------------------------------------------------
# The three-pass split's float64 model (factors given to the model)
# ---------------------------------------------------------------------------

def _long_a_maps(n1a, n1b, n2, strip, blocks=None):
    """Pass A's (and A''s) maps, (blocks, n1a * strip) each (every block,
    or the blocks given): the point t
    that block (j1b, strip c0) loads into slot idx = j1a * strip + s (and
    where A' leaves sample t), the position r n2 + j2 of slot idx = k1a *
    strip + s in the packed row's buffer (row k1a + n1a j1b), j1b and
    k1a."""
    strips = n2 // strip
    blk = np.arange(n1b * strips) if blocks is None else np.array(blocks)
    j1b, c0 = blk[:, None] // strips, blk[:, None] % strips * strip
    idx = np.arange(n1a * strip)[None, :]
    j, s = idx // strip, idx % strip
    return ((n1b * j + j1b) * n2 + c0 + s, (j + n1a * j1b) * n2 + c0 + s,
            j1b, j)


def _long_b_maps(n1a, n1b, n2, strip, blocks=None):
    """Pass B's (and B''s) maps, (blocks, n1b * strip) each (every block,
    or the blocks given): the position
    r n2 + j2 of slot idx = q * strip + s of block (k1a, strip c0) in the
    buffer, read (q = j1b) and written (q = k1b; B' the other way), its
    row r = k1a + n1a q and column j2."""
    strips = n2 // strip
    blk = np.arange(n1a * strips) if blocks is None else np.array(blocks)
    k1a, c0 = blk[:, None] // strips, blk[:, None] % strips * strip
    idx = np.arange(n1b * strip)[None, :]
    row, j2 = k1a + n1a * (idx // strip), c0 + idx % strip
    return row * n2 + j2, row, j2


def long_forward_model(z, n1a, n1b, n2, strip=fs.S):
    """Passes A and B (``long_cols_a``, ``long_cols_b``) on packed rows z
    (packed, n) -> Y (packed, n1, n2), Y[k1, j2] as ``fft_real_cols``
    writes it (pass B's twiddle from ``Tw3``'s three tables,
    ``pass_b_twiddle``); asserts that each pass reads and writes every
    point once and pass B the positions it read."""
    packed = z.shape[0]
    n1 = n1a * n1b
    n = n1 * n2
    t, dst, j1b, k1a = _long_a_maps(n1a, n1b, n2, strip)
    for m in (t, dst):
        assert np.array_equal(np.bincount(m.ravel(), minlength=n),
                              np.ones(n, int))
    cols = fs.block_fft(z[:, t].reshape(packed, -1, n1a, strip))
    y = np.full((packed, n), np.nan, complex)
    y[:, dst] = cols.reshape(packed, *t.shape) * fs._twiddle(
        fs._half_table(n1), j1b * k1a)
    pos, row, j2 = _long_b_maps(n1a, n1b, n2, strip)
    assert np.array_equal(np.bincount(pos.ravel(), minlength=n),
                          np.ones(n, int))
    cols = fs.block_fft(y[:, pos].reshape(packed, -1, n1b, strip))
    y[:, pos] = cols.reshape(packed, *pos.shape) * pass_b_twiddle(
        n, j2 * row)
    return y.reshape(packed, n1, n2)


def long_fft_real_model(x, n1a, n1b, n2):
    """K4a on the three-pass split n1a x n1b x n2: passes A and B, then
    K4a's pass 2 in ``fft_real_rows_strip``'s strips (8 rows at n2 =
    2,048) -> ((rows, n/2 + 1) spectra, writes to each bin)."""
    n = n1a * n1b * n2
    y = long_forward_model(fs._pack(x, n), n1a, n1b, n2)
    out, writes = fs.rows_pass_model(y, n1a * n1b, n2, min(
        cf.fft_real_rows_strip(n2, y.shape[0]), n1a * n1b))
    return out[:x.shape[0]], writes[:x.shape[0]]


def long_bootstrap_model(s1, x, n1a, n1b, n2, strip=fs.S):
    """K4b on the three-pass split n1a x n1b x n2: passes A and B,
    ``boot_rows_long`` (strips of 2 rows, no inverse twiddle), B' (the
    conjugate twiddle, the inverse n1b-point DFTs) and A' (the conjugate
    W_n1, the inverse n1a-point DFTs, each block's maxima) -> ((rows,)
    maxima, (rows, n) correlations in natural order)."""
    rows = x.shape[0]
    n1 = n1a * n1b
    n = n1 * n2
    y = long_forward_model(fs._pack(x, n), n1a, n1b, n2, strip)
    packed = y.shape[0]
    inv, slot_rows = fs.boot_rows_model(y, s1, n1, n2, 2)
    y[:, slot_rows, :] = inv.transpose(0, 1, 3, 2)
    y = y.reshape(packed, n)
    pos, row, j2 = _long_b_maps(n1a, n1b, n2, strip)
    w = np.conj(pass_b_twiddle(n, j2 * row))
    cols = fs.block_fft((y[:, pos] * w).reshape(packed, -1, n1b, strip),
                        -1.0)
    y[:, pos] = cols.reshape(packed, *pos.shape)
    t, dst, j1b, k1a = _long_a_maps(n1a, n1b, n2, strip)
    w1 = np.conj(fs._twiddle(fs._half_table(n1), j1b * k1a))
    cols = fs.block_fft((y[:, dst] * w1).reshape(packed, -1, n1a, strip),
                        -1.0)                     # (packed, blocks, n1a, S)
    maxima = np.stack([cols.real.max(axis=(2, 3)).max(-1),
                       cols.imag.max(axis=(2, 3)).max(-1)], -1)
    natural = np.empty((packed, n), complex)
    natural[:, t] = cols.reshape(packed, *t.shape)
    corr = np.stack([natural.real, natural.imag], 1).reshape(-1, n) / n
    return maxima.reshape(-1)[:rows] / n, corr[:rows]


# (n1a, n1b, n2): the model's factors, small, and with the program's row
# side (n2 = 2,048: K4a's row pass in strips of 8 rows, the others of 2).
FACTORS = [(8, 8, 64), (16, 8, 128), (8, 16, 2048)]


@pytest.mark.parametrize("factors", FACTORS)
def test_three_pass_fft_real_model(factors):
    """K4a on the three-pass split against np.fft.rfft, one, two and
    three rows: each bin written exactly once, DC and Nyquist exactly
    real."""
    n = int(np.prod(factors))
    rng = np.random.default_rng(n)
    for rows in (1, 2, 3):
        x = fs._rows(rng, rows, n - n // 4 - 1)
        got, writes = long_fft_real_model(x, *factors)
        want = np.fft.rfft(x, n=n)
        assert np.array_equal(writes, np.ones_like(writes))
        assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
        assert not got[:, 0].imag.any() and not got[:, -1].imag.any()


@pytest.mark.parametrize("factors", FACTORS)
def test_three_pass_bootstrap_model(factors):
    """K4b (and so K6, whose draws the same passes transform) on the
    three-pass split, one and three rows: the correlations and their
    maxima against irfft(whiten(s1 * conj(rfft(row)))) and
    ``bootstrap_peaks_plain``."""
    n = int(np.prod(factors))
    rng = np.random.default_rng(n + 1)
    for rows in (1, 3):
        s1, x = fs._boot_case(rng, rows, n)
        peaks, corr = long_bootstrap_model(s1, x, *factors)
        want = fs._boot_reference(s1, x, n)
        tol = 1e-9 * np.abs(want).max()
        assert np.abs(corr - want).max() < tol
        assert np.abs(peaks - want.max(-1)).max() < tol
        plain = cf.bootstrap_peaks_plain(torch.from_numpy(s1),
                                         torch.from_numpy(x), n).numpy()
        assert np.abs(peaks - plain).max() < tol


def rows_long_model(gathers, n1, n2):
    """A row pass of the three-pass split that gathers from natural-order
    spectra (``corr_rows_long``, ``render_spec_rows_long``) over packed
    rows, each given by a function of the lower bins q <= n/2 that returns
    its two Hermitian halves (ya, yb) there.  Blocks of 2 rows (row b and
    its partner n1 - b; block 0 rows 0 and n1/2): each mirror-pair task
    gathers bin q and stores the pair (``store_pair``), then the inverse
    row DFTs, written back without the conjugate twiddle -> yields each
    packed row (n1, n2).  Asserts that the tasks gather every bin q <= n/2
    once and that every row is written once."""
    n = n1 * n2
    nb = n1 // 2
    slot_rows = fs._slot_rows(n1, 2)
    assert np.array_equal(np.bincount(slot_rows.ravel(), minlength=n1),
                          np.ones(n1, int))
    tasks = fs._block_tasks(nb, 2, n1, n2)
    q = tasks[5]
    assert np.array_equal(np.bincount(q, minlength=n // 2 + 1),
                          np.ones(n // 2 + 1, int))
    for gather in gathers:
        ya, yb = gather(q)
        work = np.full((nb, n2, 2), np.nan, complex)
        fs._store_pairs(work, tasks, ya, yb, n)
        out = np.full((n1, n2), np.nan, complex)
        out[slot_rows, :] = fs.block_fft(work, -1.0).transpose(0, 2, 1)
        yield out


def corr_rows_long_model(pairs, mask, n1, n2):
    """``corr_rows_long`` (the row pass of K9's and the GCCs' three-pass
    split) over packed cross rows, each as its loader gives it: ``pairs``
    yields the spectra rows (a0, b0, a1, b1) (n/2 + 1,) of each packed
    cross row, a1 and b1 None without a second pair: whiten times the
    band (``rows_long_model``)."""
    def gather(a0, b0, a1, b1):
        def at(q):
            ya = fs._whiten(a0[q], b0[q]) * mask[q]
            yb = (np.zeros_like(ya) if a1 is None
                  else fs._whiten(a1[q], b1[q]) * mask[q])
            return ya, yb
        return at

    yield from rows_long_model((gather(*p) for p in pairs), n1, n2)


def long_cols_inverse_model(y, n1a, n1b, n2, strip=fs.S):
    """B' (the conjugate twiddle, the inverse n1b-point DFTs) and A' up to
    its epilogue (``long_cols_a_inverse``: the conjugate W_n1, the inverse
    n1a-point DFTs) on packed rows y (packed, n1, n2) -> ((packed, blocks,
    n1a, strip) the unscaled inverse of block (j1b, strip) in its slots
    (j1a, s), (blocks, n1a * strip) the sample n2 (n1b j1a + j1b) + j2 each
    slot holds); asserts that A' leaves every sample once."""
    packed = y.shape[0]
    n1 = n1a * n1b
    n = n1 * n2
    y = y.reshape(packed, n).copy()
    pos, row, j2 = _long_b_maps(n1a, n1b, n2, strip)
    w = np.conj(pass_b_twiddle(n, j2 * row))
    cols = fs.block_fft((y[:, pos] * w).reshape(packed, -1, n1b, strip),
                        -1.0)
    y[:, pos] = cols.reshape(packed, *pos.shape)
    t, dst, j1b, k1a = _long_a_maps(n1a, n1b, n2, strip)
    w1 = np.conj(fs._twiddle(fs._half_table(n1), j1b * k1a))
    cols = fs.block_fft((y[:, dst] * w1).reshape(packed, -1, n1a, strip),
                        -1.0)
    assert np.array_equal(np.bincount(t.ravel(), minlength=n),
                          np.ones(n, int))
    return cols, t


def long_corr_cols_model(y, n1a, n1b, n2, strip=fs.S):
    """B' and A' with the correlations (``long_cols_corr``, times 1/n) on
    packed cross rows y (packed, n1, n2) -> (2 * packed, n): the real part
    of packed row c to row 2c, the imaginary part to row 2c + 1, sample n2
    (n1b j1a + j1b) + j2 from slot (j1a, s) of block (j1b, strip)."""
    packed = y.shape[0]
    n = n1a * n1b * n2
    cols, t = long_cols_inverse_model(y, n1a, n1b, n2, strip)
    out = np.full((packed, 2, n), np.nan)
    vals = cols.reshape(packed, *t.shape)
    out[:, 0, t] = vals.real / n
    out[:, 1, t] = vals.imag / n
    return out.reshape(2 * packed, n)


def long_corr_model(a, b, mask, n1a, n1b, n2):
    """K9 on the three-pass split n1a x n1b x n2: ``corr_rows_long`` with
    ``RowPairLoad`` (rows 2c and 2c + 1 of a and b), B' and A' with the
    correlations -> (rows, n)."""
    rows = a.shape[0]
    loads = ((a[2 * c], b[2 * c]) + ((a[2 * c + 1], b[2 * c + 1])
                                     if 2 * c + 1 < rows else (None, None))
             for c in range((rows + 1) // 2))
    y = np.stack(list(corr_rows_long_model(loads, mask, n1a * n1b, n2)))
    return long_corr_cols_model(y, n1a, n1b, n2)[:rows]


def long_gcc_model(sig, pairs_i, pairs_j, mask, n1a, n1b, n2):
    """K1 on the three-pass split n1a x n1b x n2: K4a's passes A and B and
    pass 2 (``long_fft_real_model``) into the spectra of rows scene * mics
    + mic, ``corr_rows_long`` with ``PairIndexLoad`` (packed cross row
    scene * couples + c reads rows scene * mics + pairs_i[p] and +
    pairs_j[p], p = 2c, 2c + 1), B' and A' with the correlations ->
    (scenes, P, n)."""
    scenes, mics, length = sig.shape
    n = n1a * n1b * n2
    spec, writes = long_fft_real_model(sig.reshape(scenes * mics, length),
                                       n1a, n1b, n2)
    assert np.array_equal(writes, np.ones_like(writes))
    pairs = len(pairs_i)
    couples = (pairs + 1) // 2

    def load(rc):
        scene, c = divmod(rc, couples)
        m0 = scene * mics
        first = (spec[m0 + pairs_i[2 * c]], spec[m0 + pairs_j[2 * c]])
        if 2 * c + 1 < pairs:
            return first + (spec[m0 + pairs_i[2 * c + 1]],
                            spec[m0 + pairs_j[2 * c + 1]])
        return first + (None, None)

    y = np.stack(list(corr_rows_long_model(map(load, range(scenes * couples)),
                                           mask, n1a * n1b, n2)))
    out = long_corr_cols_model(y, n1a, n1b, n2)
    return out.reshape(scenes, 2 * couples, n)[:, :pairs]


def _corr_reference(a, b, mask, n):
    """irfft(whiten(a * conj(b)) * mask) by np.fft (which drops the
    imaginary parts of DC and Nyquist, as the kernels and the twin do)."""
    return np.fft.irfft(fs._whiten(a, b) * mask, n=n)


def _mask(n, band):
    return cf.band_mask(n, band, 16000.0, dtype=torch.float64).numpy()


@pytest.mark.parametrize("band", [None, (300.0, 3400.0)])
@pytest.mark.parametrize("factors", FACTORS)
def test_three_pass_corr_model(factors, band):
    """K9 on the three-pass split, one and three row pairs (an odd count:
    the last packed row's second slot empty), unbanded and band-limited:
    against irfft(whiten(a * conj(b)) * band) by ``np.fft`` and against
    ``whitened_corr_plain`` in float64, within 1e-9 of the peak; every
    bin gathered and every sample written once."""
    n = int(np.prod(factors))
    rng = np.random.default_rng(n + 2)
    mask = _mask(n, band)
    for rows in (1, 3):
        a, b = fs._spectra(rng, rows, n), fs._spectra(rng, rows, n)
        got = long_corr_model(a, b, mask, *factors)
        want = _corr_reference(a, b, mask, n)
        tol = 1e-9 * np.abs(want).max()
        assert np.abs(got - want).max() < tol
        t = torch.from_numpy
        plain = cf.whitened_corr_plain(t(a), t(b), t(mask), n).numpy()
        assert np.abs(got - plain).max() < tol


@pytest.mark.parametrize("band", [None, (300.0, 3400.0)])
@pytest.mark.parametrize("factors", FACTORS)
def test_three_pass_gcc_model(factors, band):
    """K1 on the three-pass split, one scene of 3 mics (an odd pair count)
    and of 4, unbanded and band-limited: K4a's three passes into the mic
    rows' spectra, the pair-indexed row pass, B' and A' with the
    correlations, against the pairs' irfft(whiten(rfft(x_i) *
    conj(rfft(x_j))) * band) by ``np.fft`` and against
    ``gcc_all_pairs_plain`` in float64, within 1e-9 of the peak."""
    n = int(np.prod(factors))
    rng = np.random.default_rng(n + 3)
    mask = _mask(n, band)
    for mics in (3, 4):
        sig = rng.standard_normal((1, mics, n - n // 3))
        pi, pj = fs._pairs(mics)
        got = long_gcc_model(sig, pi, pj, mask, *factors)
        spec = np.fft.rfft(sig, n=n)
        want = _corr_reference(spec[:, pi], spec[:, pj], mask, n)
        tol = 1e-9 * np.abs(want).max()
        assert got.shape == want.shape == (1, len(pi), n)
        assert np.abs(got - want).max() < tol
        plain = cf.gcc_all_pairs_plain(torch.from_numpy(sig), pi, pj, n,
                                       torch.from_numpy(mask)).numpy()
        assert np.abs(got - plain).max() < tol


def test_long_models_match_jax_package():
    """The three-pass models of K9 and K1 and the port's plain versions
    (the functions the card's kernels are held to), at the first of
    ``FACTORS`` (8 x 8 x 64 = 4,096 points), against the JAX package's
    ``phat_correlation`` (ops/gccphat.py:98) and ``gcc_phat_all_pairs``
    (:123) on the same seeded float64 rows, within 1e-9 of the peak: one
    pair unbanded, and 4 mics with the band (300, 3400) Hz at 16 kHz."""
    import jax.numpy as jnp

    from pyaudiolocalization_tpu.ops import gccphat as jgcc
    from pyaudiolocalization_tpu_torch.ops import gccphat as tgcc
    factors = FACTORS[0]
    n = int(np.prod(factors))
    rng = np.random.default_rng(4096)
    sig = rng.standard_normal((4, 3000))
    want = np.asarray(jgcc.phat_correlation(jnp.asarray(sig[0]),
                                            jnp.asarray(sig[1]), nfft=n))
    spec = np.fft.rfft(sig[:2], n=n)
    got = long_corr_model(spec[:1], spec[1:], _mask(n, None), *factors)[0]
    tol = 1e-9 * np.abs(want).max()
    assert np.abs(got - want).max() < tol
    plain = cf.whitened_corr_plain(
        torch.from_numpy(spec[:1]), torch.from_numpy(spec[1:]),
        torch.from_numpy(_mask(n, None)), n)[0].numpy()
    assert np.abs(plain - want).max() < tol
    pi, pj = fs._pairs(4)
    band = (300.0, 3400.0)
    want = np.asarray(jgcc.gcc_phat_all_pairs(
        jnp.asarray(sig), np.asarray(pi), np.asarray(pj), nfft=n, band=band,
        fs=16000.0))
    got = long_gcc_model(sig[None], pi, pj, _mask(n, band), *factors)[0]
    tol = 1e-9 * np.abs(want).max()
    assert got.shape == want.shape == (6, n)
    assert np.abs(got - want).max() < tol
    plain = tgcc.gcc_phat_all_pairs(torch.from_numpy(sig), pi, pj, nfft=n,
                                    band=band, fs=16000.0).numpy()
    assert np.abs(plain - want).max() < tol


def render_rows_long_model(spec, tau, gain, n1, n2):
    """``render_spec_rows_long`` (K3's and K5's mix row pass of the
    three-pass split) over the packed mic rows of tau / gain (scenes,
    mics, paths): packed row pm mixes mic rows 2pm and 2pm + 1 (row scene
    * mics + mic: an odd mic count packs across scenes) from the half
    spectra spec (scenes, n/2 + 1) of their scenes, times
    ``mic_response`` (``rows_long_model``)."""
    scenes, mics, paths = tau.shape
    rows = scenes * mics
    n = n1 * n2
    tau_r, gain_r = tau.reshape(rows, paths), gain.reshape(rows, paths)

    def gather(pm):
        ra, rb = 2 * pm, 2 * pm + 1

        def at(q):
            ya = spec[ra // mics][q] * fs._mic_response(tau_r[ra],
                                                        gain_r[ra], q, n)
            yb = np.zeros_like(ya)
            if rb < rows:
                yb = spec[rb // mics][q] * fs._mic_response(
                    tau_r[rb], gain_r[rb], q, n)
            return ya, yb
        return at

    yield from rows_long_model(
        (gather(pm) for pm in range((rows + 1) // 2)), n1, n2)


def long_render_model(base, tau, gain, n1a, n1b, n2):
    """K3's render stage on the three-pass split n1a x n1b x n2: K4a's
    three passes into the bases' half spectra (every bin written once),
    ``render_spec_rows_long``, B' and A' (``long_cols_render``: the
    unscaled inverse to its natural place, in a buffer of its own) ->
    (scenes, mics, n), the packed inverse's rows times 1/n (the finish's
    scale)."""
    scenes, mics, _ = tau.shape
    n1 = n1a * n1b
    n = n1 * n2
    spec, writes = long_fft_real_model(base, n1a, n1b, n2)
    assert np.array_equal(writes, np.ones_like(writes))
    y = np.stack(list(render_rows_long_model(spec, tau, gain, n1, n2)))
    cols, t = long_cols_inverse_model(y, n1a, n1b, n2)
    packed = y.shape[0]
    natural = np.full((packed, n), np.nan, complex)
    natural[:, t] = cols.reshape(packed, *t.shape)
    out = np.stack([natural.real, natural.imag], 1).reshape(-1, n)
    return out[:scenes * mics].reshape(scenes, mics, n) / n


def long_window_stats_model(cols, t, n, w, order, threads):
    """``long_cols_window`` on one packed cross row's A' output cols
    (blocks, n1a, strip), unscaled, slot (j1a, s) of block (j1b, strip)
    holding sample t[block, j1a * strip + s], the blocks taken in
    ``order``: each block's sum of |corr| into the partials and its (max,
    smallest index) as a 64-bit atomic maximum (``arg_key``); the window j
    < w or j >= n - w; the row's last block sums the partials in a fixed
    order, thread x of its ``threads`` those of blocks x, x + threads, ...
    in turn, then the threads' sums -> (win (2, 2w), stats (2, 3)) for the
    real and imaginary parts."""
    nb = cols.shape[0]
    j = t.reshape(nb, -1)
    win = np.full((2, 2 * w), np.nan)
    stats = np.zeros((2, 3))
    for h, part in enumerate((cols.real / n, cols.imag / n)):
        part = part.reshape(nb, -1)
        partials = np.abs(part).sum(axis=1)
        keys = np.zeros((), np.uint64)
        for b in order:
            top = part[b].max()
            keys = max(keys, fs.arg_key(np.float32(top),
                                        j[b][part[b] == top].min()))
        m, idx = fs.arg_unkey(np.array(keys))
        lanes = np.zeros(threads)
        for x in range(threads):
            for b in range(x, nb, threads):
                lanes[x] += partials[b]
        stats[h] = lanes.sum() / n, m, idx
        at = np.where(j < w, w + j, np.where(j >= n - w, j - (n - w), -1))
        assert np.array_equal(np.bincount(at[at >= 0], minlength=2 * w),
                              np.ones(2 * w, int))
        win[h, at[at >= 0]] = part[at >= 0]
    return win, stats


def long_gcc_window_model(sig, pairs_i, pairs_j, mask, wq, n1a, n1b, n2,
                          seed=0):
    """K2's GCC stage (K5's too) on the three-pass split n1a x n1b x n2:
    K4a's three passes into the mic rows' spectra, ``corr_rows_long`` with
    ``PairIndexLoad``, B' and A' with the window and the statistics
    (``long_cols_window``, its blocks in a shuffled order, the last
    block's n1a threads: ``fft_threads(n1a, 16)``) -> (win (scenes, P,
    2w), stats (scenes, P, 3))."""
    scenes, mics, length = sig.shape
    n1 = n1a * n1b
    n = n1 * n2
    w = wq * 128
    spec, writes = long_fft_real_model(sig.reshape(scenes * mics, length),
                                       n1a, n1b, n2)
    assert np.array_equal(writes, np.ones_like(writes))
    pairs = len(pairs_i)
    couples = (pairs + 1) // 2

    def load(rc):
        scene, c = divmod(rc, couples)
        m0 = scene * mics
        p1 = min(2 * c + 1, pairs - 1)
        return (spec[m0 + pairs_i[2 * c]], spec[m0 + pairs_j[2 * c]],
                spec[m0 + pairs_i[p1]] if 2 * c + 1 < pairs else None,
                spec[m0 + pairs_j[p1]] if 2 * c + 1 < pairs else None)

    rng = np.random.default_rng(seed)
    win = np.zeros((scenes * couples, 2, 2 * w))
    stats = np.zeros((scenes * couples, 2, 3))
    rows = corr_rows_long_model(map(load, range(scenes * couples)), mask,
                                n1, n2)
    for rc, y in enumerate(rows):
        cols, t = long_cols_inverse_model(y[None], n1a, n1b, n2)
        order = rng.permutation(cols.shape[1])
        win[rc], stats[rc] = long_window_stats_model(cols[0], t, n, w, order,
                                                     threads=n1a)
    win = win.reshape(scenes, 2 * couples, 2 * w)[:, :pairs]
    return win, stats.reshape(scenes, 2 * couples, 3)[:, :pairs]


def _render_reference(base, tau, gain, n):
    """The render's transform by ``np.fft``: irfft(rfft(base) * H_m) with
    H_m(k) = sum_p g_p exp(-2 pi i k tau_p / n) and a real Nyquist bin,
    (scenes, mics, n)."""
    spec = np.fft.rfft(base, n=n)[:, None, :]
    k = np.arange(n // 2 + 1)
    turns = k * tau[..., None] / n
    turns -= np.floor(turns)
    mixed = spec * (gain[..., None] * np.exp(-2j * np.pi * turns)).sum(-2)
    mixed[..., -1] = mixed[..., -1].real
    return np.fft.irfft(mixed, n=n)


def _window_reference(corr, wq):
    """The lag window and the statistics of correlations (..., n) by
    numpy: lags [-w, w), mean |corr|, the maximum and its first index."""
    w = wq * 128
    win = np.concatenate([corr[..., -w:], corr[..., :w]], -1)
    return win, np.stack([np.abs(corr).mean(-1), corr.max(-1),
                          corr.argmax(-1)], -1)


@pytest.mark.parametrize("factors", FACTORS)
def test_three_pass_render_model(factors):
    """K3's render (K5's too) on the three-pass split, one scene of 4 mics
    and one path and 2 scenes of 3 mics and 3 paths (an odd mic count: a
    packed mic row across two scenes): the mix row pass without the
    twiddle, B' and A' into the second buffer, against the transform by
    ``np.fft`` and ``delay_sum_plain``'s (no finalize, fade 1) within 1e-9
    of the max; then (at the two small factors: the finish does not
    depend on them) the finish spread over ``finish_groups``' 128 blocks
    a packed row of one 4-mic scene, 88 of the 2 x 3 mic rows
    (``finish_spread``, its partials in block order), with the
    finalize, the fade and the noise, against ``delay_sum_plain`` in
    float64 within 1e-9 of the max."""
    n = int(np.prod(factors))
    rng = np.random.default_rng(n + 5)
    t = torch.from_numpy
    for scenes, mics, paths in ((1, 4, 1), (2, 3, 3)):
        groups = cf.finish_groups(1 << 27, scenes * mics)
        assert groups == {4: 128, 6: 88}[scenes * mics]
        base, tau, gain = fs._render_case(rng, scenes, mics, paths, n)
        got = long_render_model(base, tau, gain, *factors)
        want = _render_reference(base, tau, gain, n)
        assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
        plain = cf.delay_sum_plain(t(base), t(tau), t(gain), n, n,
                                   torch.ones(n, dtype=torch.float64),
                                   False).numpy()
        assert np.abs(got - plain).max() < 1e-9 * np.abs(plain).max()
        if n > 1 << 14:
            continue
        out = n - n // 8
        fade = rng.uniform(0.5, 1.0, out)
        snr, seeds = fs._noise_inputs(rng, scenes)
        finished = np.stack([
            fs.finish_spread_model(got[s, m, :out] * fade, True, snr, seeds,
                                   s, m, groups)[0]
            for s in range(scenes) for m in range(mics)])
        want = cf.delay_sum_plain(t(base), t(tau), t(gain), n, out, t(fade),
                                  True, t(snr), t(seeds)).numpy()
        want = want.reshape(-1, out)
        assert np.abs(finished - want).max() < 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("band", [None, (300.0, 3400.0)])
@pytest.mark.parametrize("factors", FACTORS)
def test_three_pass_window_model(factors, band):
    """K2's GCC stage (K5's too) on the three-pass split, one scene of 3
    mics (an odd pair count) and of 4, unbanded and band-limited: K4a's
    three passes, the pair-indexed row pass, B' and A' with the window and
    the statistics (65,536 blocks a row at 2^27; here each row's blocks
    in a shuffled order), against the window and statistics of the
    pairs' correlations by ``np.fft`` and against ``gcc_windowed_plain``
    in float64: windows within 1e-9 of the peak, maxima within float32's
    rounding (the key holds them as float32), means within 1e-12, the
    argmax equal."""
    n = int(np.prod(factors))
    rng = np.random.default_rng(n + 6)
    mask = _mask(n, band)
    for mics in (3, 4):
        sig = rng.standard_normal((1, mics, n - n // 3))
        pi, pj = fs._pairs(mics)
        wq = 2
        win, stats = long_gcc_window_model(sig, pi, pj, mask, wq, *factors,
                                           seed=mics)
        spec = np.fft.rfft(sig, n=n)
        corr = _corr_reference(spec[:, pi], spec[:, pj], mask, n)
        for w2, s2 in (_window_reference(corr, wq),
                       (x.numpy() for x in cf.gcc_windowed_plain(
                           torch.from_numpy(sig), pi, pj, n, wq,
                           torch.from_numpy(mask)))):
            tol = 1e-9 * np.abs(corr).max()
            assert win.shape == w2.shape and stats.shape == s2.shape
            assert np.abs(win - w2).max() < tol
            assert np.array_equal(stats[..., 2], s2[..., 2])
            assert (np.abs(stats[..., 1] - s2[..., 1])
                    <= 2.0 ** -24 * np.abs(s2[..., 1])).all()
            assert np.abs(stats[..., 0] - s2[..., 0]).max() < 1e-12


def test_three_pass_window_keeps_the_smallest_tied_index():
    """``long_cols_window``'s keys on a planted tie of the maximum in
    three blocks (the smallest index in the last block to run) and a
    silent row whose zeros carry both signs, at 8 x 8 x 64: the smallest
    natural index (``torch.argmax``'s first occurrence) whatever the
    order of the blocks, and the block-order sum of the partials the same
    in every order."""
    n1a, n1b, n2 = FACTORS[0]
    n = n1a * n1b * n2
    strips = n2 // fs.S
    _, _, j1b, _ = _long_a_maps(n1a, n1b, n2, fs.S)
    t = _long_a_maps(n1a, n1b, n2, fs.S)[0]
    rng = np.random.default_rng(n)
    corr = rng.uniform(-1, 0.5, n).astype(np.float32)
    ties = [t[5, 3 * fs.S + 2], 17, t[-1, -1]]      # three blocks
    assert len({int(np.argwhere(t == x)[0, 0]) for x in ties}) == 3
    corr[ties] = 0.75
    zero = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    zero[0] = -0.0
    natural = (corr.astype(float) * n + 1j * zero.astype(float))
    cols = natural[t].reshape(-1, n1a, fs.S)
    blocks = n1b * strips
    seen = []
    for order in (np.arange(blocks), np.arange(blocks)[::-1],
                  rng.permutation(blocks)):
        _, stats = long_window_stats_model(cols, t, n, 128, order, n1a)
        assert stats[0, 2] == 17 == int(torch.argmax(torch.from_numpy(corr)))
        assert stats[0, 1] == np.float32(0.75)
        assert stats[1, 2] == 0 and stats[1, 1] == 0
        seen.append(stats[0, 0])
    assert seen[0] == seen[1] == seen[2]


def test_long_render_and_window_match_jax_package():
    """The three-pass models of K3's render and K2's GCC stage, and the
    port's plain versions (the functions the card's kernels are held to),
    at the first of ``FACTORS`` (8 x 8 x 64 = 4,096 points), against the
    JAX package's Pallas kernels in interpret mode on the same seeded
    float32 inputs, as ``tests/test_torch_windowed.py`` and
    ``tests/test_torch_simulator.py`` hold the twins to them:
    ``bfly_delay_sum`` (ops/pallas_fft.py:1851) within 5e-5 of the peak
    (the TPU kernel's float32 ramp phases) and ``bfly_gcc_windowed``
    (:1095) with windows and maxima within 3e-6, means within 1e-7 and
    the argmax equal (its bf16 x 3 lane DFT)."""
    import jax.numpy as jnp

    from pyaudiolocalization_tpu.ops import pallas_fft as pf
    factors = FACTORS[0]
    n = int(np.prod(factors))
    fs_hz, total, out = 8000.0, 3600, 3000
    rng = np.random.default_rng(4097)
    base = np.zeros((1, total), np.float32)
    base[0, :out] = rng.standard_normal(out)
    d = rng.uniform(0.0, 0.03, (4, 3)).astype(np.float32)
    g = rng.uniform(0.1, 1.0, (4, 3)).astype(np.float32)
    want = np.asarray(pf.bfly_delay_sum(
        jnp.asarray(base[0]), jnp.asarray(d), jnp.asarray(g), fs_hz, n, out,
        interpret=True))
    tau = d.astype(np.float64) * fs_hz
    got = long_render_model(base.astype(np.float64), tau[None],
                            g.astype(np.float64)[None], *factors)[0, :, :out]
    scale = np.abs(got).max()
    assert np.abs(got - want).max() < 5e-5 * scale
    plain = cf.delay_sum_plain(torch.from_numpy(base), torch.from_numpy(
        d * fs_hz)[None], torch.from_numpy(g)[None], n, out,
        torch.ones(out), False)[0].numpy()
    assert np.abs(plain - want).max() < 5e-5 * scale
    x = rng.standard_normal((4, 3000)).astype(np.float32)
    pi, pj = fs._pairs(4)
    band, wq = (300.0, 3400.0), 2
    jw, js = (np.asarray(a) for a in pf.bfly_gcc_windowed(
        jnp.asarray(x), np.array(pi), np.array(pj), n, wq, band=band,
        fs=fs_hz, interpret=True))
    mask = cf.band_mask(n, band, fs_hz, dtype=torch.float64).numpy()
    win, stats = long_gcc_window_model(x[None].astype(np.float64), pi, pj,
                                       mask, wq, *factors)
    pw, ps = (a.numpy() for a in cf.gcc_windowed_plain(
        torch.from_numpy(x), pi, pj, n, wq, cf.band_mask(n, band, fs_hz)))
    for gw, gs in ((win[0], stats[0]), (pw, ps)):
        assert gw.shape == jw.shape and gs.shape == js.shape
        assert np.abs(gw - jw).max() < 3e-6
        assert np.array_equal(gs[..., 2], js[..., 2])
        assert np.abs(gs[..., 1] - js[..., 1]).max() < 3e-6
        assert np.abs(gs[..., 0] - js[..., 0]).max() < 1e-7


def test_render_rows_long_and_window_maps_at_2_27():
    """K3's mix row pass and K2's pass A' at 2^27 (256 x 256 x 2,048), by
    index arithmetic alone: ``render_spec_rows_long`` takes
    ``corr_rows_long``'s blocks, tasks and bytes (``pair_task`` over
    strips of 2 rows, the rows written whole without the twiddle: its
    maps are ``test_corr_rows_long_maps_at_2_27``'s) and gathers the bins
    of packed mic row pm from the spectra of the scenes of mic rows 2pm
    and 2pm + 1 (one scene of 4 mics: scene 0's), at offsets past a
    32-bit int at 2^30 (the kernel's are size_t).  ``long_cols_window``'s
    blocks (j1b, strip) take samples n2 (n1b j1a + j1b) + j2 in runs of 16
    (pass A's load map, one to one); the window's 2w lags (w = 21 x 128,
    the fast path's) come from 2 x w / 16 blocks, each lag once; a row's
    32,768 blocks keep 32,768 partials of each pair (``_window_scratch``),
    which the last block's 256 threads sum 128 each; 65,536 blocks a row
    at 2^30, every sample index below 2^31."""
    n = 1 << 27
    plan = cf.long_plan(n)
    n1a, n1b, S = plan.n1a, plan.n1b, plan.cols_a.strip
    n1 = cf.fft_real_split(n)[0]
    route = cf.render_route(n)
    assert route == cf.gcc_route(n, 4) == cf.GccRoute(cf.ROUTE_LONG, n1, S, 2)
    assert plan.corr_rows == (2, 8 * (2048 // 2 + 2 * cf.row_ld(2, 2048)))
    mics = 4
    for pm in (0, 1):
        assert {(2 * pm) // mics, (2 * pm + 1) // mics} == {0}
    # At 2^30 packed mic row 1 starts 2^31 floats in, and scene 2's
    # spectrum 2 (2^29 + 1) complex points: past a 32-bit int.
    m = 1 << 30
    assert m * 2 >= 2 ** 31 and 2 * (m // 2 + 1) * 2 > 2 ** 31
    w = 21 * 128
    t = _long_a_maps(n1a, n1b, 2048, S)[0]
    assert np.array_equal(np.bincount(t.ravel(), minlength=n),
                          np.ones(n, np.int64))
    assert (np.diff(t.reshape(t.shape[0], n1a, S), axis=-1) == 1).all()
    at = np.where(t < w, w + t, np.where(t >= n - w, t - (n - w), -1))
    hit = np.flatnonzero((at >= 0).any(axis=1))
    assert len(hit) == 2 * w // S
    assert np.array_equal(np.bincount(at[at >= 0], minlength=2 * w),
                          np.ones(2 * w, int))
    del t, at
    keys, count, part = cf._window_scratch(3, n, route, "cpu")
    assert (keys.numel(), count.numel(), part.numel()) == (6, 3,
                                                           2 * 3 * 32768)
    threads = n1a * S // 16
    assert threads == 256 and 32768 // threads == 128
    big = cf.long_plan(1 << 30)
    assert big.n1b * 2048 // 16 == 65536 and big.n1a == 1024
    assert (1 << 30) - 1 < 2 ** 31


def test_corr_rows_long_maps_at_2_27():
    """K9's and K1's back half at 2^27 (256 x 256 x 2,048), by index
    arithmetic alone: ``corr_rows_long``'s block b holds rows b and n1 - b
    (block 0 rows 0 and n1/2), so the n1/2 blocks write every row once,
    each row whole (2,048 points, 16 KB a row, no twiddle); each of its
    tasks is a bin q <= n/2 and its mirror n - q in the same block, its
    tasks' bins n1 apart (the next block's the next bins);
    ``long_cols_corr``'s block (j1b, strip) writes samples n2 (n1b j1a +
    j1b) + j2 of both pairs' rows
    in runs of 16 floats (64 bytes), pass A's load map, one to one; and a
    4-mic scene's sixth correlation row starts 5 x 2^30 floats in at 2^30,
    past a 32-bit int (the kernel's offsets are size_t)."""
    n = 1 << 27
    plan = cf.long_plan(n)
    n1a, n1b, S = plan.n1a, plan.n1b, plan.corr_cols.strip
    n1, n2 = cf.fft_real_split(n)
    assert plan.corr_rows.strip == 2 and S == 16
    slot_rows = fs._slot_rows(n1, 2)
    assert slot_rows.shape == (n1 // 2, 2)
    assert np.array_equal(np.bincount(slot_rows.ravel(), minlength=n1),
                          np.ones(n1, int))
    assert (slot_rows[1:, 0] + slot_rows[1:, 1] == n1).all()
    assert slot_rows[0].tolist() == [0, n1 // 2]
    for b in (0, 1, n1 // 4, n1 // 2 - 1):
        r, k2, row, pr, pk = fs._boot_tasks(b, 2, n1, n2)
        assert (slot_rows[b, r] == row).all()
        p = row + n1 * k2
        pm = slot_rows[b, pr] + n1 * pk
        assert ((p + pm) % n == 0).all()
        q = np.where(p <= n // 2, p, pm)
        assert q.max() <= n // 2 and len(q) == n2 + (b == 0)
        assert (np.abs(np.diff(q[:n2 // 2 - 1])) == n1).all()
    strips = n2 // S
    for blk in (0, 1, strips, n1b * strips - 1):
        t = _long_a_maps(n1a, n1b, n2, S, [blk])[0][0].reshape(n1a, S)
        assert (np.diff(t, axis=-1) == 1).all()
        assert (np.diff(t[:, 0]) == n1b * n2).all()
    m = 1 << 30
    assert 5 * m + m - 1 >= 2 ** 31


def test_three_pass_maps_at_2_27():
    """One block's maps at 2^27 (256 x 256 x 2,048, strips of 16), by
    index arithmetic alone: pass A's blocks (j1b, strip) load points n2
    (n1b j1a + j1b) + j2 in runs of 16 consecutive samples (64 bytes of
    each real row) and write 16 consecutive points (128 bytes) of rows
    k1a + n1a j1b; pass B's blocks (k1a, strip) read and write the same
    128-byte runs of rows k1a + n1a q; both maps are one to one (a
    sample of points maps back to the block and slot that hold it);
    ``boot_rows_long``'s blocks hold rows b and n1 - b (block 0 rows 0
    and n1/2), each whitening task a bin and its mirror."""
    n = 1 << 27
    plan = cf.long_plan(n)
    n1a, n1b, S = plan.n1a, plan.n1b, plan.cols_a.strip
    n1, n2 = cf.fft_real_split(n)
    strips = n2 // S
    for blk in (0, 1, strips, n1b * strips - 1):
        t, dst = (m[0] for m in _long_a_maps(n1a, n1b, n2, S, [blk])[:2])
        runs = t.reshape(n1a, S)
        assert (np.diff(runs, axis=-1) == 1).all()
        assert (np.diff(runs[:, 0]) == n1b * n2).all()
        out = dst.reshape(n1a, S)
        assert (np.diff(out, axis=-1) == 1).all()
        assert (np.diff(out[:, 0]) == n2).all()
        assert out[0, 0] // n2 == n1a * (blk // strips)
        pos = _long_b_maps(n1a, n1b, n2, S, [blk])[0].reshape(n1b, S)
        assert (np.diff(pos, axis=-1) == 1).all()
        assert (np.diff(pos[:, 0]) == n1a * n2).all()
    rng = np.random.default_rng(27)
    t = rng.integers(0, n, 100_000)
    j1, j2 = t // n2, t % n2
    blk_a = (j1 % n1b) * strips + j2 // S
    slot_a = (j1 // n1b) * S + j2 % S
    assert np.array_equal(((n1b * (slot_a // S) + blk_a // strips) * n2
                           + blk_a % strips * S + slot_a % S), t)
    blk_b = (j1 % n1a) * strips + j2 // S
    slot_b = (j1 // n1a) * S + j2 % S
    assert np.array_equal((blk_b // strips + n1a * (slot_b // S)) * n2
                          + blk_b % strips * S + slot_b % S, t)
    slot_rows = np.array([[fs._pair_row(b, r, n1, 1) for r in range(2)]
                          for b in (0, 1, n1 // 2 - 1)])
    assert slot_rows.tolist() == [[0, n1 // 2], [1, n1 - 1],
                                  [n1 // 2 - 1, n1 // 2 + 1]]
    for i, b in enumerate((0, 1, n1 // 2 - 1)):
        r, k2, row, pr, pk = fs._boot_tasks(b, 2, n1, n2)
        assert (slot_rows[i, r] == row).all()
        p = row + n1 * k2
        pm = slot_rows[i, pr] + n1 * pk
        assert ((p + pm) % n == 0).all()
        assert len(p) == n2 + (b == 0)


@pytest.mark.parametrize("bits", [24, 25, 26, 27])
def test_spectra_routes_keep_their_limit(bits):
    """K9, K1, K2, K3 and K5 keep the split of K4a, K4b and K6 to its one
    limit, ``FFT_SPLIT_MAX`` = 2^24: through the spectra at 2^24 (n1 =
    4,096, strips of 4) at every mic count (``gcc_route``,
    ``render_route``, ``corr_schedule``, the finish spread over the card),
    the row pass at ``split_strips``' rows and bytes and the column pass at
    the split's column strip; from 2^25, where ``spectra_plan`` plans
    nothing, the three-pass split of all five (n1 = n / 2,048, 16 columns,
    2 rows), the finish spread there too."""
    n = 1 << bits
    assert not hasattr(cf, "SPECTRA_SPLIT_MAX")
    if bits > 24:
        long = cf.GccRoute(cf.ROUTE_LONG, n // 2048, 16, 2)
        assert cf.render_route(n) == long and cf.corr_schedule(n) == n // 2048
        for mics in (2, 3, 4, 8, 16, 64, 128):
            assert cf.gcc_route(n, mics) == long
        assert cf.finish_groups(n, 4) == 128
        with pytest.raises(ValueError):
            cf.spectra_plan(n)
        return
    n1, cs, rs = 4096, 4, 4
    spectra = cf.GccRoute(cf.ROUTE_SPECTRA, n1, cs, rs)
    assert cf.render_route(n) == spectra
    assert cf.corr_schedule(n) == n1
    for mics in (2, 3, 4, 8, 16, 64, 128):
        assert cf.gcc_route(n, mics) == spectra
    assert cf.finish_groups(n, 4) == 128
    for packed in (1, 2, 64):
        plan = cf.spectra_plan(n, packed)
        split = cf.split_plan(n, packed)
        assert (plan.cols, plan.rows) == (split.cols, split.rows)
        assert plan.spec_rows == (rs, 213_120)
        assert split.boot_rows == (2, 147_584)
        assert plan.spec_cols == (cs, 147_456)
        assert cf._spectra_strips(n, packed) == (cs, split.rows.strip, rs)
        for step in plan:
            assert step.smem <= cf.SMEM_OPTIN
        assert plan.spec_cols.smem + 257 <= cf.SMEM_OPTIN


def test_spectra_column_maps_at_2_26():
    """The spectra routes' column passes at 2^26 on the three-pass split
    (256 x 128 x 2,048), a few blocks alone: pass A' (``long_cols_corr``,
    ``long_cols_window``, ``long_cols_render``) writes samples n2 (n1b j1a
    + j1b) + j2 in runs of 16 columns (128 bytes of each packed row, where
    the split's ``corr_cols`` took 2 columns, half a 32-byte sector), and
    B' reads and writes runs of 16 too; ``long_cols_window`` keeps n1b x
    n2 / 16 = 16,384 partials a row (``_window_scratch``: one a block,
    summed in block order by the row's last block)."""
    n = 1 << 26
    plan = cf.long_plan(n)
    n1a, n1b, S = plan.n1a, plan.n1b, plan.corr_cols.strip
    n2 = n // (n1a * n1b)
    assert (n1a, n1b, n2, S) == (256, 128, 2048, 16)
    strips = n2 // S
    for blk in (0, 1, strips, n1b * strips - 1):
        t = _long_a_maps(n1a, n1b, n2, S, [blk])[0][0].reshape(n1a, S)
        assert (np.diff(t, axis=-1) == 1).all()
        assert (np.diff(t[:, 0]) == n1b * n2).all()
        pos = _long_b_maps(n1a, n1b, n2, S, [blk])[0].reshape(n1b, S)
        assert (np.diff(pos, axis=-1) == 1).all()
    keys, count, part = cf._window_scratch(3, n, cf.gcc_route(n, 4), "cpu")
    assert (keys.numel(), count.numel(), part.numel()) == (6, 3,
                                                           2 * 3 * 16384)


def test_twiddle_table_at_2_25():
    """At 2^25, on the three-pass split, the table (``_twiddles``) holds
    the half tables of n = 2^25, n1 = 16,384, n2 = 2,048, n1a = n1b = 128
    (``_twiddle_lengths``: 2^24 + 8,192 + 1,024 + 64 + 64 entries), then
    pass B's three tables of W_n (``tw3_sizes``: 512 + 512 + 128 entries,
    strides 1, 512 and 2^18), 16,787,712 entries in all; below 2^20 the
    n-point table alone.  (Their values and offsets:
    ``test_torch_k4a_half.py``.)"""
    n = 1 << 25
    assert cf._twiddle_lengths(n) == [n, 16384, 2048, 128, 128]
    assert cf.tw3_sizes(n) == [(512, 1), (512, 512), (128, 1 << 18)]
    entries = (sum(length // 2 for length in cf._twiddle_lengths(n))
               + sum(count for count, _ in cf.tw3_sizes(n)))
    assert entries == 16_787_712
    assert cf._twiddle_lengths(1 << 20) == [1 << 20]


@pytest.mark.parametrize("bits", [25, 26])
def test_long_split_maps(bits):
    """The three-pass split's maps at 2^25 and 2^26 (128 x 128 and 256 x
    128 x 2,048), every block: passes A (K4a's and K4b's, K6's draws) and
    B read and write every point once in runs of 16 columns; K4a's row
    pass (strips of 8 rows, 4 rows k1 and their partners) writes every bin
    0 .. n/2 once from its packed value and its mirror n - k's, slots 0..3
    of a block 4 consecutive bins; the one-strip row passes' tasks (strips
    of 2: ``boot_rows_long``' whitening, and the spectra routes'
    ``corr_rows_long`` and ``render_spec_rows_long``, which share
    ``pair_task``) take every bin of the packed spectrum once, each task a
    bin and its mirror in its own block, and gather every bin q <= n/2 of
    the natural-order spectra once."""
    n = 1 << bits
    (n1a, n1b), _, _ = LONG[bits]
    n1, n2, S = n1a * n1b, 2048, 16
    for m in _long_a_maps(n1a, n1b, n2, S)[:2] + _long_b_maps(n1a, n1b, n2,
                                                              S)[:1]:
        assert np.array_equal(np.bincount(m.ravel(), minlength=n),
                              np.ones(n, int))
        assert (np.diff(m.reshape(-1, S), axis=-1) == 1).all()
        del m
    s2 = cf.long_plan(n).rows.strip
    slot_rows = fs._slot_rows(n1, s2)
    assert (np.diff(slot_rows[:, :s2 // 2], axis=1) == 1).all()
    h2 = n2 // 2
    r = np.arange(s2)[None, :, None]
    k2 = np.arange(h2 + 1)[None, None, :]
    row, pr, pk = fs._partner(slot_rows, r, k2, n1, n2)
    live = (k2 < h2) | (row == 0)
    b = np.broadcast_to(np.arange(n1 // s2)[:, None, None], row.shape)
    k = (row + n1 * k2)[live]
    mirror = (slot_rows[b, pr] + n1 * pk)[live]
    del row, pr, pk, live, b
    assert np.array_equal(np.bincount(k, minlength=n // 2 + 1),
                          np.ones(n // 2 + 1, int))
    assert ((k + mirror) % n == 0).all()
    del k, mirror
    rs = cf.long_plan(n).boot_rows.strip
    slot_rows = fs._slot_rows(n1, rs)
    seen = np.zeros(n, np.int8)
    gathered = np.zeros(n // 2 + 1, np.int8)
    for blk in range(n1 // rs):
        r, k2, row, pr, pk = fs._boot_tasks(blk, rs, n1, n2)
        assert (slot_rows[blk, r] == row).all()
        p = row + n1 * k2
        pm = slot_rows[blk, pr] + n1 * pk
        assert ((p + pm) % n == 0).all()
        seen[p] += 1
        seen[pm[pm != p]] += 1
        gathered[np.where(p <= n // 2, p, pm)] += 1
    assert (seen == 1).all()
    assert (gathered == 1).all()


def test_row_stride_at_8192_is_conflict_free():
    """The three-pass split's row passes hold rows of 2,048 points at
    ``row_ld``: 2,056 for ``boot_rows_long``'s, ``corr_rows_long``'s and
    ``render_spec_rows_long``'s 2 rows, 2,050 for K4a's 8; one wavefront a
    half-warp."""
    assert cf.row_ld(2, 2048) == 2056 and cf.row_ld(8, 2048) == 2050
    fs.test_row_strip_stride_is_conflict_free(2, 2048)
    fs.test_row_strip_stride_is_conflict_free(8, 2048)

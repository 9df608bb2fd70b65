"""The four-step split of every transforming kernel at 2^25 and 2^26,
checked on the CPU: the rules that pick its shapes, strips, shared memory
and launches (``cuda_fft.fft_real_split``, ``split_strips``,
``fft_real_rows_strip``, ``split_plan``, ``spectra_plan``, ``_split_n1``,
``_launch_rows``), the one limit ``FFT_SPLIT_MAX`` of K4a, K4b, K6 and
the spectra routes of K9, K1, K2, K3 and K5 (``gcc_route``,
``render_route``, ``corr_schedule``), the twiddle table's n2-point copy
that the split's first column pass and its row passes read from device
memory there (``HiTable`` in ``csrc/kernels.cu``), and the float64 numpy
models of ``tests/test_torch_fft_schedule.py`` at 2^25 with the n2-point
table read as ``HiTable`` reads it, against ``np.fft`` or the float64
twins: K4a, K4b, K9 and K3's render.  At 2^26 the maps alone (a model
there would take twice 2^25's memory).

At 2^27 every transforming kernel takes the radix-2 passes.  No n-point
table above 2^25 is built here: at 2^27 it holds 2^26 entries.
"""

import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
import test_torch_fft_schedule as fs

# (n1, n2), (column strip, row strip), K4a's pass-2 strip, rows a launch
# (``_launch_rows``) and each launch's shared memory (``split_plan``:
# cols, rows, boot_rows, boot_cols) at 2^25 and 2^26; the radix-2 passes
# at 2^27.
LONG = {25: ((4096, 8192), (4, 2), 2, 128,
             (180_224, 163_968, 196_736, 147_584)),
        26: ((8192, 8192), (2, 2), 2, 64,
             (229_376, 163_968, 229_504, 163_968))}


def _tables_as_read(n, n1, n2):
    """``stage_split_lo_hi`` with hi in device memory: lo[r] = W_n^r (r <
    n1) and hi[a] = W_n2^a read from the n2-point half table at a mod
    n2/2, negated for a >= n2/2 (``HiTable``), in float64."""
    half = n2 // 2
    a = np.arange(n2)
    w = fs._half_table(n2)[a & (half - 1)]
    return fs._half_table(n)[:n1], np.where(a < half, w, -w)


@pytest.fixture
def hi_as_read(monkeypatch):
    """The models' split tables (``_split_tables``) as the kernels read
    them at n2 = 8,192."""
    monkeypatch.setattr(fs, "_split_tables", _tables_as_read)


def _np_stages(x, sgn=1.0):
    """``block_fft``'s transform of every sequence of a strip (..., L, S)
    by ``np.fft``: forward for sgn > 0, the unscaled inverse else."""
    if sgn > 0:
        return np.fft.fft(x, axis=-2)
    return np.fft.ifft(x, axis=-2) * x.shape[-2]


@pytest.fixture
def np_stages(monkeypatch):
    """The models' on-chip transforms (``block_fft``) by ``np.fft``, so
    that a model of the spectra routes at 2^25 holds their maps, strips
    and tables in seconds: ``block_fft``'s radix-16 stages at 4,096 and
    8,192 points are held at 2^25 by ``test_fft_real_model_at_2_25`` and
    ``test_bootstrap_model_at_2_25``."""
    monkeypatch.setattr(fs, "block_fft", _np_stages)


@pytest.mark.parametrize("bits", [25, 26])
def test_long_split_plan(bits):
    """At 2^25 (4,096 x 8,192) and 2^26 (8,192 x 8,192) K4a, K4b and K6 run
    the split: column strips of 4 and 2, row strips of 2 (one row k1 and
    its partner), K4a's pass 2 in strips of 2 at any batch, 128 and 64
    rows a launch under the 16 GiB scratch cap (64 and 32 packed rows).
    No launch holds the n2-point table in shared memory there
    (``split_hi_points``); every block holds at most ``BLOCK_POINTS``
    points in at most ``SMEM_OPTIN`` bytes; with the table neither the
    column nor the row pass would fit, and the next wider strip does not
    fit where a narrower one is taken."""
    n = 1 << bits
    (n1, n2), strips, s2, rows, smem = LONG[bits]
    assert cf.fft_real_split(n) == (n1, n2)
    assert cf.split_strips(n1, n2) == strips
    assert cf._split_n1(n) == n1 and cf._split_strips(n1, n) == strips
    assert cf.split_hi_points(n2) == 0 and cf.split_hi_points(4096) == 4096
    assert cf._launch_rows(n1, n) == rows
    assert rows * n * 8 // 2 <= cf.SPLIT_SCRATCH_BYTES
    cs, rs = strips
    for packed in (1, 2, 64):
        assert cf.fft_real_rows_strip(n2, packed) == s2
        plan = cf.split_plan(n, packed)
        assert (plan.cols.strip, plan.rows.strip, plan.boot_rows.strip,
                plan.boot_cols.strip) == (cs, s2, rs, cs)
        assert tuple(p.smem for p in plan) == smem
        for step, length in ((plan.cols, n1), (plan.rows, n2),
                             (plan.boot_rows, n2), (plan.boot_cols, n1)):
            assert step.strip * length <= cf.BLOCK_POINTS
            assert step.smem <= cf.SMEM_OPTIN
    assert 8 * (n1 // 2 + n1 + n2 + n1 * cs) > cf.SMEM_OPTIN
    assert 8 * (n2 // 2 + n1 + n2 + rs * cf.row_ld(rs, n2)) > cf.SMEM_OPTIN
    assert n1 * 2 * cs > cf.BLOCK_POINTS and n2 * 2 * rs > cf.BLOCK_POINTS
    assert n2 % cs == 0 and n1 % rs == 0 and n1 % s2 == 0
    assert cf._twiddle_lengths(n) == [n, n1, n2]


def test_passes_above_2_26():
    """At 2^27, past ``FFT_SPLIT_MAX``, K4a, K4b and K6 take the radix-2
    passes (n1 = 0): no strips, no plan, two copies of the packed rows'
    scratch (16 rows a launch under the 16 GiB cap), the n-point table
    alone."""
    n = 1 << 27
    assert cf.FFT_SPLIT_MAX == 1 << 26 < n
    assert cf._split_n1(n) == 0 and cf._split_strips(0, n) == (0, 0)
    with pytest.raises(ValueError):
        cf.split_plan(n)
    assert cf._launch_rows(0, n) == 16
    assert 2 * (16 // 2) * n * 8 <= cf.SPLIT_SCRATCH_BYTES
    assert cf._twiddle_lengths(n) == [n]


# The spectra routes at 2^24 to 2^26: (n1, column strip, row strip) of
# ``gcc_route`` and ``render_route``, and the bytes of the row pass and the
# column pass (``spectra_plan``).
SPECTRA = {24: ((4096, 4, 4), 213_120, 147_456),
           25: ((4096, 4, 2), 196_736, 147_456),
           26: ((8192, 2, 2), 229_504, 163_840)}


@pytest.mark.parametrize("bits", [24, 25, 26, 27])
def test_spectra_routes_keep_their_limit(bits):
    """K9, K1, K2, K3 and K5 keep the split of K4a, K4b and K6 to its one
    limit, ``FFT_SPLIT_MAX`` = 2^26: through the spectra at 2^24 (n1 =
    4,096, strips of 4), 2^25 (n1 = 4,096, 4 columns, 2 rows) and 2^26
    (n1 = 8,192, strips of 2) at every mic count (``gcc_route``,
    ``render_route``, ``corr_schedule``, ``scene_stages``, the finish
    spread over the card), the row pass at ``boot_rows``' strip and bytes
    (the n2-point table in device memory at 2^25 and 2^26) and the column
    pass at the split's column strip; the radix-2 passes at 2^27, where
    ``spectra_plan`` plans nothing."""
    n = 1 << bits
    assert not hasattr(cf, "SPECTRA_SPLIT_MAX")
    if bits == 27:
        passes = cf.GccRoute(cf.ROUTE_PASSES, 0, 0, 0)
        assert cf.render_route(n) == passes and cf.corr_schedule(n) == 0
        for mics in (2, 3, 4, 8, 16, 64, 128):
            assert cf.gcc_route(n, mics) == passes
            assert cf.scene_stages(n, mics) == (0, 0)
        assert cf.finish_groups(n, 4) == 1
        with pytest.raises(ValueError):
            cf.spectra_plan(n)
        return
    (n1, cs, rs), rows_smem, cols_smem = SPECTRA[bits]
    spectra = cf.GccRoute(cf.ROUTE_SPECTRA, n1, cs, rs)
    assert cf.render_route(n) == spectra
    assert cf.corr_schedule(n) == n1
    for mics in (2, 3, 4, 8, 16, 64, 128):
        assert cf.gcc_route(n, mics) == spectra
        assert cf.scene_stages(n, mics) == (n1, n1)
    assert cf.finish_groups(n, 4) == 128
    for packed in (1, 2, 64):
        plan = cf.spectra_plan(n, packed)
        split = cf.split_plan(n, packed)
        assert (plan.cols, plan.rows) == (split.cols, split.rows)
        assert plan.spec_rows == split.boot_rows == (rs, rows_smem)
        assert plan.spec_cols == (cs, cols_smem)
        assert cf._spectra_strips(n, packed) == (cs, split.rows.strip, rs)
        for step in plan:
            assert step.smem <= cf.SMEM_OPTIN
        assert plan.spec_cols.smem + 257 <= cf.SMEM_OPTIN


def test_corr_split_model_at_2_25(hi_as_read, np_stages):
    """K9 at 2^25, one row pair of a 380 s recording's length at 44.1 kHz,
    band-limited: ``corr_rows`` on strips of 2 rows (one row k1 and its
    partner; block 0 row 0 and row n1/2) with the n2-point table read as
    ``HiTable`` reads it, ``corr_cols`` on strips of 4 columns, against
    ``whitened_corr_plain`` in float64 within 1e-9 of the max, every bin
    gathered once and every sample written once."""
    n = 1 << 25
    assert cf.corr_schedule(n) == 4096
    assert (cf.spectra_plan(n).spec_cols.strip,
            cf.spectra_plan(n).spec_rows.strip) == (4, 2)
    rng = np.random.default_rng(2025)
    a, b = fs._spectra(rng, 1, n), fs._spectra(rng, 1, n)
    mask = cf.band_mask(n, (300.0, 3400.0), 44100.0,
                        dtype=torch.float64).numpy()
    got = fs.corr_split_model(a, b, mask, n)
    t = torch.from_numpy
    want = cf.whitened_corr_plain(t(a), t(b), t(mask), n).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


def test_render_spectra_model_at_2_25(hi_as_read, np_stages):
    """K3's render (K5's too) through the base rows' spectra at 2^25: one
    scene of 2 mics and one path, ``render_spec_rows`` mixing every mirror
    pair on strips of 2 rows with the n2-point table read as ``HiTable``
    reads it, ``render_cols`` on strips of 4 columns, from the bases' half
    spectra (K4a's model at 2^25 is ``test_fft_real_model_at_2_25``),
    against ``delay_sum_plain``'s transform (no finalize, fade 1) in
    float64 within 1e-9 of the max."""
    n = 1 << 25
    assert cf.render_route(n) == cf.GccRoute(cf.ROUTE_SPECTRA, 4096, 4, 2)
    base, tau, gain = fs._render_case(np.random.default_rng(325), 1, 2, 1,
                                      n)
    got = fs.render_spectra_model(base, tau, gain, n,
                                  spec=np.fft.rfft(base, n=n))
    t = torch.from_numpy
    want = cf.delay_sum_plain(t(base), t(tau), t(gain), n, n,
                              torch.ones(n, dtype=torch.float64),
                              False).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


def test_spectra_column_maps_at_2_26():
    """The spectra routes' column passes at 2^26 (8,192 x 8,192), a block
    alone: ``corr_cols``, ``window_cols`` and ``render_cols`` on strips of
    2 columns write every sample once, in runs of 2 (half a 32-byte
    sector a row), from the slots where the inverse column DFTs leave
    them (``corr_cols_model``'s map), and ``window_cols`` keeps 4,096
    partials a row (``_window_scratch``: one a block, summed in block
    order by the row's last block).  The row passes' gather at 2^26 is
    ``test_long_split_maps``'."""
    n = 1 << 26
    n1, n2 = cf.fft_real_split(n)
    cs = cf.spectra_plan(n).spec_cols.strip
    assert (n1, n2, cs) == (8192, 8192, 2)
    j = (np.arange(n1, dtype=np.int64)[:, None, None] * n2
         + np.arange(n2 // cs)[:, None] * cs + np.arange(cs))
    assert np.array_equal(np.bincount(j.ravel(), minlength=n),
                          np.ones(n, np.int64))
    assert (np.diff(j, axis=-1) == 1).all()
    del j
    keys, count, part = cf._window_scratch(3, n, cf.gcc_route(n, 4), "cpu")
    assert (keys.numel(), count.numel(), part.numel()) == (6, 3,
                                                           2 * 3 * 4096)


def test_twiddle_table_at_2_25():
    """At 2^25 the table carries the half tables of n1 = 4,096 and n2 =
    8,192 after the n-point one (``_twiddles``).  ``HiTable`` reads W_n2^a
    at offset n/2 + n1/2 + (a mod n2/2), negated for a >= n2/2: the float32
    bits that the shared-memory staging (``stage_split_tables_of``) holds,
    and those of every n1-th entry of the n-point table
    (``stage_split_tables``); lo reads the n-point table's first n1."""
    n, (n1, n2) = 1 << 25, LONG[25][0]
    tab = cf._twiddles(n, "cpu").numpy()
    assert tab.shape == (n // 2 + n1 // 2 + n2 // 2, 2)
    half = n2 // 2
    a = np.arange(n2)
    t2 = tab[n // 2 + n1 // 2:]
    sign = np.where(a < half, 1.0, -1.0).astype(np.float32)[:, None]
    read = t2[a & (half - 1)] * sign
    strided = tab[(a & (half - 1)) * n1] * sign
    assert np.array_equal(read.view(np.int32), strided.view(np.int32))
    t1 = tab[n // 2:n // 2 + n1 // 2]
    assert np.array_equal(t1.view(np.int32), tab[:n // 2:n2].view(np.int32))


def test_fft_real_model_at_2_25(hi_as_read):
    """K4a at 2^25, one row of a 380 s recording's length at 44.1 kHz:
    pass 1 over strips of 4 columns, pass 2 over blocks of one row k1 and
    its partner (row n1/2 in row 0's block), against np.fft.rfft: each bin
    written exactly once, DC and Nyquist exactly real."""
    n = 1 << 25
    x = fs._rows(np.random.default_rng(25), 1, 16_800_000)
    got, writes = fs.fft_real_model(x, n)
    want = np.fft.rfft(x, n=n)
    assert np.array_equal(writes, np.ones_like(writes))
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
    assert not got[:, 0].imag.any() and not got[:, -1].imag.any()


def test_bootstrap_model_at_2_25(hi_as_read):
    """K4b (and so K6, whose draws K4b's split transforms) at 2^25, one
    row: the column pass, ``boot_rows`` on strips of 2 rows (every bin's
    whitening task once, block 0 with row 0's and row n1/2's own pairs)
    and ``boot_cols``' maxima, against irfft(whiten(s1 * conj(rfft(row))))
    and ``bootstrap_peaks_plain``."""
    n = 1 << 25
    assert cf.split_strips(*cf.fft_real_split(n)) == (4, 2)
    fs._check_boot(*fs._boot_case(np.random.default_rng(125), 1, n), n)


@pytest.mark.parametrize("bits", [25, 26])
def test_long_split_maps(bits):
    """The maps at 2^25 and 2^26, a block alone: the column passes' load
    (K4a's and K4b's pass 1, K6's draws, K4b's pass 3) reads every point
    once in runs of the strip's columns; K4a's pass 2 (strips of 2 rows)
    writes every bin 0 .. n/2 once from its packed value and its mirror
    n - k's; the one-strip row passes' tasks (strips of 2: ``boot_rows``'
    whitening, and the spectra routes' ``corr_rows`` and
    ``render_spec_rows``, which share ``pair_task``) take every bin of
    the packed spectrum once, each task a bin and its mirror in its own
    block, and gather every bin q <= n/2 of the natural-order spectra
    once."""
    n = 1 << bits
    (n1, n2), (cs, rs), s2, _, _ = LONG[bits]
    land = fs._strip_points(n1, n2, cs)
    assert np.array_equal(np.bincount(land.ravel(), minlength=n),
                          np.ones(n, int))
    assert (np.diff(land.reshape(-1, cs), axis=-1) == 1).all()
    del land
    slot_rows = fs._slot_rows(n1, s2)
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
    """K4a's pass 2 and ``boot_rows`` hold their 2 rows of 8,192 points at
    ``row_ld`` = 8,200: one wavefront a half-warp."""
    assert cf.row_ld(2, 8192) == 8200
    fs.test_row_strip_stride_is_conflict_free(2, 8192)

"""K4a's, K4b's and K6's four-step split at 2^25 and 2^26, checked on the
CPU: the rules that pick its shapes, strips, shared memory and launches
(``cuda_fft.fft_real_split``, ``split_strips``, ``fft_real_rows_strip``,
``split_plan``, ``_split_n1``, ``_launch_rows``), the spectra routes'
limit of 2^24 that stays (``gcc_route``, ``render_route``,
``corr_schedule``, ``spectra_plan``), the twiddle table's n2-point copy
that the column and row passes read from device memory there
(``HiTable`` in ``csrc/kernels.cu``), and the float64 numpy models of
``tests/test_torch_fft_schedule.py`` at 2^25 with the n2-point table read
as ``HiTable`` reads it, against ``np.fft``.  At 2^26 the maps alone (a
model there would take twice 2^25's memory).

At 2^27 the three kernels take the radix-2 passes.  No n-point table
above 2^25 is built here: at 2^27 it holds 2^26 entries.
"""

import numpy as np
import pytest

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


@pytest.mark.parametrize("bits", [24, 25, 26])
def test_spectra_routes_keep_their_limit(bits):
    """K9, K1, K2, K3 and K5 take the routes they took before K4a's split
    passed 2^24: the spectra at 2^24 (n1 = 4,096, strips of 4), the radix-2
    passes at 2^25 and 2^26 at every mic count (``gcc_route``,
    ``render_route``, ``corr_schedule``, ``scene_stages``, one block a mic
    row in the finish), and ``spectra_plan`` plans nothing past 2^24."""
    n = 1 << bits
    assert cf.SPECTRA_SPLIT_MAX == 1 << 24
    spectra = cf.GccRoute(cf.ROUTE_SPECTRA, 4096, 4, 4)
    passes = cf.GccRoute(cf.ROUTE_PASSES, 0, 0, 0)
    want = spectra if bits == 24 else passes
    assert cf.render_route(n) == want
    assert cf.corr_schedule(n) == want.n1
    for mics in (2, 3, 4, 8, 16, 64, 128):
        assert cf.gcc_route(n, mics) == want
        assert cf.scene_stages(n, mics) == (want.n1, want.n1)
    assert cf.finish_groups(n, 4) == (128 if bits == 24 else 1)
    if bits == 24:
        assert cf.spectra_plan(n).spec_rows == cf.split_plan(n).boot_rows
    else:
        with pytest.raises(ValueError):
            cf.spectra_plan(n)


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
    n - k's; ``boot_rows``' whitening tasks (strips of 2) take every bin of
    the packed spectrum once, each task a bin and its mirror in its own
    block."""
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
    for blk in range(n1 // rs):
        r, k2, row, pr, pk = fs._boot_tasks(blk, rs, n1, n2)
        assert (slot_rows[blk, r] == row).all()
        p = row + n1 * k2
        pm = slot_rows[blk, pr] + n1 * pk
        assert ((p + pm) % n == 0).all()
        seen[p] += 1
        seen[pm[pm != p]] += 1
    assert (seen == 1).all()


def test_row_stride_at_8192_is_conflict_free():
    """K4a's pass 2 and ``boot_rows`` hold their 2 rows of 8,192 points at
    ``row_ld`` = 8,200: one wavefront a half-warp."""
    assert cf.row_ld(2, 8192) == 8200
    fs.test_row_strip_stride_is_conflict_free(2, 8192)

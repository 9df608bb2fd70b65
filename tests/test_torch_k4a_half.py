"""K4a's half-length transform of one real row and the three-pass split's
twiddles in shared memory, held on the CPU by float64 numpy models that
follow the kernels' index maps (``csrc/kernels.cu``):

- ``fft_real_half``: the row's even and odd samples as one complex row z
  of m = n/2 points (``HalfLoad``), m's schedule (``cuda_fft.half_plan``:
  the split; the three-pass split from ``HALF_LONG_MIN``), and the row
  pass's epilogue
  X[k] = E[k] + W_n^k O[k] (``half_bin``, W_n^k from ``_half_post``'s two
  tables) that writes every bin 0..n/2 once, against ``np.fft.rfft`` and
  the JAX package's ``bfly_fft_real_reference``;
- ``Tw3``: pass B's W_n^e as the product of three full-circle tables
  (``cuda_fft.tw3_sizes``), each entry one float32 rounding of its float64
  value, and their place in ``_twiddles`` where ``long_tables`` reads
  them;
- the three-pass split's row passes at 2^27 by index arithmetic (K4a's
  strips of 8 rows at n2 = 2,048 writing runs of 4 bins, the half
  epilogue, ``boot_rows_long``'s grid), and every plan's blocks within a
  block's shared memory with column strips of at least 32 bytes a row.
"""

import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
import test_torch_fft_schedule as fs
import test_torch_split_long as sl


def _circle(n, e):
    """exp(-2 pi i e / n) in float64, as the tables make it (cos and sin
    of the angle, their exact zeros kept exact)."""
    ang = -2.0 * np.pi * (np.asarray(e) % n) / n
    c, s = np.cos(ang), np.sin(ang)
    c[np.abs(c) < 1e-12] = 0.0
    s[np.abs(s) < 1e-12] = 0.0
    return c + 1j * s


def half_rows_model(y, n1, n2, strip):
    """``fft_real_rows``' half epilogue on Y (1, n1, n2), the row pass of
    one row's half-length transform Z (m = n1 * n2) in strips of ``strip``
    rows -> ((m + 1,) spectrum of the real row, writes to each bin): every
    (block, slot r, k2 < n2) writes bin k = row + n1 k2 from Z[k] and its
    mirror Z[m - k] at the partner's place, with W_2m^k = W_2m^row *
    W_(2 n2)^k2; slot 0 of block 0 (row 0, k2 = 0) also writes bin m."""
    m = n1 * n2
    slot_rows = fs._slot_rows(n1, strip)
    buf = fs.block_fft(y[:, slot_rows, :].transpose(0, 1, 3, 2))[0]
    nb = n1 // strip
    b = np.arange(nb)[:, None, None]
    r = np.arange(strip)[None, :, None]
    k2 = np.arange(n2)[None, None, :]
    row, pr, pk = fs._partner(slot_rows, r, k2, n1, n2)
    b, r, k2 = (np.broadcast_to(a, row.shape) for a in (b, r, k2))
    zk, zm = buf[b, k2, r], buf[b, pk, pr]
    k = row + n1 * k2
    w = _circle(2 * m, row) * _circle(2 * n2, k2)
    out = np.full(m + 1, np.nan, complex)
    writes = np.zeros(m + 1, int)
    out[k] = fs._split_bin(zk, zm, 0) + w * fs._split_bin(zk, zm, 1)
    np.add.at(writes, k.ravel(), 1)
    z0 = zk[(row == 0) & (k2 == 0)]
    assert z0.shape == (1,)
    out[m] = z0[0].real - z0[0].imag
    writes[m] += 1
    return out, writes


def half_fft_real_model(x, n, factors=None):
    """K4a's half-length transform of one real row x (len <= n) -> ((n/2 +
    1,) spectrum, writes to each bin), on ``half_plan``'s schedule at n, or
    with ``factors`` = (n1a, n1b, n2) on the three-pass split of those
    factors (m = n1a n1b n2 = n/2): z[t] = x[2t] + i x[2t + 1]; on the
    split K4a's pass 1, on the three-pass split passes A and B, then the
    half epilogue (``half_rows_model``)."""
    xp = np.zeros(n)
    xp[:len(x)] = x
    z = (xp[0::2] + 1j * xp[1::2])[None]
    m = n // 2
    if factors is not None:
        n1a, n1b, n2 = factors
        y = sl.long_forward_model(z, n1a, n1b, n2)
        return half_rows_model(y, n1a * n1b, n2, cf.fft_real_rows_strip(
            n2, 1))
    plan = cf.half_plan(n)
    assert plan.m == m
    n1, n2 = plan.n1, m // plan.n1
    if plan.n1a:
        y = sl.long_forward_model(z, plan.n1a, n1 // plan.n1a, n2,
                                  plan.cols)
    else:
        y = fs._cols_pass(z, n1, n2, plan.cols)
    return half_rows_model(y, n1, n2, plan.rows)


def _check_half(x, n, got, writes):
    want = np.fft.rfft(x, n=n)
    assert np.array_equal(writes, np.ones_like(writes))
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()
    assert got[0].imag == 0 and got[-1].imag == 0


@pytest.mark.parametrize("bits", range(14, 19))
def test_half_spectrum_matches_rfft(bits):
    """One row at n = 2^14 to 2^18 on ``half_plan``'s schedule (the split
    of n/2 points) against ``np.fft.rfft``: every bin 0..n/2 written
    once, DC and Nyquist exactly real; an odd length and a full one."""
    n = 1 << bits
    rng = np.random.default_rng(bits)
    for length in (n - n // 4 - 1, n):
        x = rng.standard_normal(length)
        _check_half(x, n, *half_fft_real_model(x, n))


@pytest.mark.parametrize("factors", [(8, 8, 64), (16, 8, 128), (8, 16, 32)])
def test_half_spectrum_on_the_three_pass_split(factors):
    """One row whose half-length transform takes the three-pass split of
    small factors (passes A and B, then K4a's row pass in strips of 8 rows
    at n2 = 2,048's rule) against ``np.fft.rfft``."""
    n = 2 * int(np.prod(factors))
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n - 3)
    _check_half(x, n, *half_fft_real_model(x, n, factors))


def test_half_plan_by_length():
    """``half_plan``: from ``HALF_MIN`` (``fft_real``'s rule; the plan
    itself from m = n/2 past one block), m's split below ``HALF_LONG_MIN``
    (2^23) and its three-pass split from it, below ``FFT_SPLIT_MAX`` too
    (m = 2^23 and 2^24 at n = 2^24 and 2^25), the strips of m's packed row
    of one; ``_half_post``'s table."""
    assert cf.HALF_LONG_MIN == 1 << 23 <= cf.FFT_SPLIT_MAX
    assert 2 * cf.FFT_REAL_ONE_BLOCK < cf.HALF_MIN == 1 << 17
    with pytest.raises(ValueError):
        cf.half_plan(2 * cf.FFT_REAL_ONE_BLOCK)
    for bits in range(14, 31):
        n = 1 << bits
        plan = cf.half_plan(n)
        m = n // 2
        assert plan.m == m
        if m < cf.HALF_LONG_MIN:
            sp = cf.split_plan(m, 1)
            assert plan == (m, cf.fft_real_split(m)[0], sp.cols.strip,
                            sp.rows.strip, 0)
        else:
            n1a, n1b, n2 = cf.three_pass_shape(m)
            lp = cf._three_pass_plan(m, 1)
            assert plan == (m, n1a * n1b, lp.cols_a.strip, lp.rows.strip,
                            n1a)
            assert n2 == cf.LONG_N2 and lp.rows.strip == 8
    post = cf._half_post(1 << 16, "cpu").numpy()
    plan = cf.half_plan(1 << 16)
    n2 = plan.m // plan.n1
    assert post.shape == (plan.n1 + n2, 2)
    want = np.concatenate([_circle(1 << 16, np.arange(plan.n1)),
                           _circle(2 * n2, np.arange(n2))])
    assert np.array_equal(post[:, 0] + 1j * post[:, 1],
                          want.astype(np.complex64))


@pytest.mark.parametrize("n", [1 << 14, 1 << 17])
def test_half_spectrum_matches_jax_package(n):
    """The half-length model (the split at 2^14 and 2^17)
    against the JAX package's ``bfly_fft_real_reference``
    (ops/pallas_fft.py:1942, the oracle of ``bfly_fft_real``) on the same
    seeded float64 row: bins 0..n/2 of its bit-reversed (n2, 128) planes
    within 1e-6 of the peak.  The oracle's twiddle constants are float32
    (``_bfly_consts``), so it lies up to ~1e-7 of the peak from the exact
    spectrum, which the model matches to 1e-10 (``np.fft.rfft``)."""
    import jax.numpy as jnp

    from pyaudiolocalization_tpu.ops import pallas_fft as pf
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal(n)
    yr, yi = pf.bfly_fft_real_reference(jnp.asarray(x[None]))
    n2 = n // 128
    k = np.arange(128)[None, :] * n2 + pf._bitrev_perm(n2)[:, None]
    full = np.empty(n, complex)
    full[k] = np.asarray(yr)[0] + 1j * np.asarray(yi)[0]
    got, _ = half_fft_real_model(x, n)
    want = full[:n // 2 + 1]
    assert np.abs(got - want).max() < 1e-6 * np.abs(want).max()
    exact = np.fft.rfft(x)
    assert np.abs(got - exact).max() < 1e-10 * np.abs(exact).max()


def _tw3_tables(n):
    """The three tables of ``tw3_sizes(n)`` as ``_twiddles`` makes them
    (complex64) and in float64."""
    f32, f64 = [], []
    for count, step in cf.tw3_sizes(n):
        t = cf._half_table_part(n, 0, count, step)
        f32.append(t[:, 0] + 1j * t[:, 1])
        f64.append(_circle(n, np.arange(count) * step))
    return f32, f64


def tw3_twiddle(tables, n, e):
    """``Tw3``: W_n^e = T2[e >> 2b] * T1[(e >> b) mod 2^b] * T0[e mod 2^b],
    b = ceil(log2(n) / 3), every index within its table."""
    b = ((n.bit_length() - 1) + 2) // 3
    i2, i1, i0 = e >> (2 * b), (e >> b) & ((1 << b) - 1), e & ((1 << b) - 1)
    assert i2.max() < len(tables[2]) and i1.max() < len(tables[1])
    return (tables[2][i2] * tables[1][i1]) * tables[0][i0]


@pytest.mark.parametrize("bits", [21, 26, 27, 30])
def test_tw3_tables_and_product(bits):
    """Each of the three tables is its float64 values rounded once to
    float32 (at most 1,024 entries, so the three fit shared memory beside
    pass B's strip), and their product is W_n^e within 3e-7 at every e of
    a sample that includes 0 and n - 1; in float64 it is W_n^e."""
    n = 1 << bits
    f32, f64 = _tw3_tables(n)
    assert max(len(t) for t in f32) <= 1024
    for t32, t64 in zip(f32, f64):
        assert np.array_equal(t32, t64.astype(np.complex64))
    rng = np.random.default_rng(bits)
    e = np.concatenate([[0, 1, n // 4, n // 2, n - 1],
                        rng.integers(0, n, 20_000)])
    exact = _circle(n, e)
    assert np.abs(tw3_twiddle(f64, n, e) - exact).max() < 1e-14
    got = tw3_twiddle([t.astype(np.complex128) for t in f32], n, e)
    assert np.abs(got - exact).max() < 3e-7


def test_tw3_tables_follow_the_half_tables(monkeypatch):
    """``_twiddles`` on the three-pass split: the n-, n1-, n2-, n1a- and
    n1b-point half tables, then ``tw3_sizes``' three, where
    ``long_tables`` reads them (a small split of 64-point rows with the
    limit lowered, so that no large table is built)."""
    monkeypatch.setattr(cf, "FFT_SPLIT_MAX", 1 << 12)
    monkeypatch.setattr(cf, "LONG_N2", 64)
    cf._table.cache_clear()
    try:
        n = 1 << 16
        n1a, n1b, n2 = cf.three_pass_shape(n)
        assert (n1a, n1b, n2) == (32, 32, 64)
        tab = cf._twiddles(n, "cpu").numpy()
        tab = tab[:, 0] + 1j * tab[:, 1]
        at = 0
        for length in (n, n1a * n1b, n2, n1a, n1b):
            want = _circle(length, np.arange(length // 2))
            assert np.array_equal(tab[at:at + length // 2],
                                  want.astype(np.complex64))
            at += length // 2
        for t in _tw3_tables(n)[0]:
            assert np.array_equal(tab[at:at + len(t)], t)
            at += len(t)
        assert at == len(tab)
    finally:
        cf._table.cache_clear()


def test_row_passes_maps_at_2_27():
    """By index arithmetic at 2^27 (256 x 256 x 2,048): K4a's row pass
    holds 8 rows a block (4 rows k1 and their partners), its blocks' slots
    hold every row once, and the bins row + n1 k2 (k2 < n2/2, and n/2 by
    row 0) are every bin 0..n/2 once, slots 0..3 writing 4 consecutive
    bins; the half epilogue at m = 2^26 (32,768 x 2,048) writes every bin
    k < m once and bin m once; ``boot_rows_long``'s grid of packed rows
    fastest gives each (packed row, strip) one block."""
    n = 1 << 27
    n1, n2 = cf.fft_real_split(n)
    assert (n1, n2) == (65536, 2048)
    strip = cf.long_plan(n).rows.strip
    assert strip == 8
    slots = fs._slot_rows(n1, strip)
    assert np.array_equal(np.sort(slots.ravel()), np.arange(n1))
    assert (np.diff(slots[1:, :4], axis=1) == 1).all()
    assert (np.diff(slots[1:, 4:], axis=1) == -1).all()
    h2 = n2 // 2
    first = slots.ravel()
    assert first.max() + n1 * (h2 - 1) < n // 2 and n1 * h2 == n // 2
    m = n // 2
    plan = cf.half_plan(n)
    assert (plan.n1, plan.rows) == (m // n2, 8)
    hslots = fs._slot_rows(plan.n1, plan.rows)
    assert np.array_equal(np.sort(hslots.ravel()), np.arange(plan.n1))
    assert plan.n1 * n2 == m              # bins row + n1 k2, k2 < n2
    packed, strips = 16, n1 // cf.LONG_ROW_STRIP
    x = np.arange(packed * strips)
    c, b = x % packed, x // packed
    assert np.array_equal(np.bincount(b * packed + c), np.ones(x.size, int))
    assert (b < strips).all()


@pytest.mark.parametrize("rows", [1, 2, 3, 64, 1000])
def test_plans_fit_a_block_and_read_whole_sectors(rows):
    """From 2^21 to 2^30, at 1 to 1,000 rows: every launch of K4a's, K4b's
    and K6's plan (``split_plan`` to ``FFT_SPLIT_MAX``, ``long_plan``
    above) and of the odd row's ``half_plan`` fits a block's shared memory
    (``SMEM_OPTIN``) and every column pass reads at least 32 bytes (4
    complex points) of each row it touches."""
    for bits in range(21, 31):
        n = 1 << bits
        packed = (min(rows, cf._launch_rows(cf._split_n1(n), n)) + 1) // 2
        if n > cf.FFT_SPLIT_MAX:
            plan = cf.long_plan(n, packed)
            cols = (plan.cols_a, plan.cols_b, plan.corr_cols)
            steps = cols + (plan.rows, plan.boot_rows, plan.corr_rows)
        else:
            plan = cf.split_plan(n, packed)
            cols = (plan.cols, plan.boot_cols)
            steps = tuple(plan)
        for step in steps:
            assert step.smem <= cf.SMEM_OPTIN
        for step in cols:
            assert 8 * step.strip >= 32
        half = cf.half_plan(n)
        assert half.n1 == 1 or 8 * half.cols >= 32

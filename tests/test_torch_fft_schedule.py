"""A float64 numpy model of the on-chip FFT schedules of ``csrc/fft.cuh``,
K4a (``palt_fft_real``), K4b (``palt_bootstrap_peaks``) and K10b
(``palt_row_stages``), that follows the kernels' index maps step by step,
held against ``np.fft``.

The CUDA kernels cannot run here; the model repeats their arithmetic of
indices so that a wrong map shows before the card sees it:

- ``block_fft``: Stockham stages of radix 16 (one of radix 2, 4 or 8
  first where log2(L) is not a multiple of 4), butterfly i reading points
  i + m*L/R with the twiddle index e = m*k*L/(pR) (k = i mod p) into the
  half table, sign flipped for e >= L/2, and writing (i - k)*R + k + m*p;
  the 8- and 16-point DFTs split into DFT-4s in registers;
- K4a: the n1 x n2 split (``cuda_fft.fft_real_split``) up to 2^24 (n1
  < n2 above 2^22), pass 1 over strips of S = 16 columns (``kStrip``; 8
  at n1 = 2,048, 4 at 4,096, ``cuda_fft.split_strips``) with the twiddle
  W_n^{j2 k1} (e = j2*k1 < n) as W_n2^{e / n1} * W_n^{e mod n1}, pass
  2's blocks of 4, 8, 16, 32 or 64 rows k1
  (``cuda_fft.fft_real_rows_strip``) and their partners n1 - k1 (row
  n1/2 in the slot of row 0's) and the k2 maps of the Hermitian split,
  DC and Nyquist; one block for n <= 4096;
- K4b: K4a's pass 1; pass 2's blocks of 16 rows (8 at n2 = 2,048, 4 at
  4,096; any even strip in the model), their forward row DFTs, the
  whitening task by
  task (a mirror
  pair of bins against s1 at the lower bin, imaginary parts dropped at
  DC and Nyquist; row 0's and row n1/2's own pairs in block 0 with one
  task more), the inverse row DFTs and the conjugate twiddle written
  back in place; pass 3's inverse column DFTs over pass 1's strips and
  the maxima of the blocks' maxima; one block for n <= 4096; against
  irfft(whiten(s1 * conj(rfft(row)))) and ``bootstrap_peaks_plain``; the
  strip rule (``split_strips``) and the split's limits;
- K10b: strips of S lanes, zero_top, the input scale, the
  conjugate twiddles of the inverse, output modes 0/1/2 and rep chains;
- K1 and K9 (``palt_gcc_all_pairs``, ``palt_whitened_corr``): K1's split
  (K2's passes 1 and 2, then ``corr_cols``' inverse column DFTs written
  to pairs 2c and 2c + 1 in natural order), K9's row pass gathering
  natural-order bins by the mirror-pair tasks (16 rows a strip, 8 at n2
  = 2,048, and 8 columns at n1 = 2,048; the strips of 4 of 2^23 and 2^24
  at 65,536, as the render's and the window's), K1 above 2^20 (K4a's
  passes into the mic rows' spectra, K9's row pass with the pair-indexed
  loader, ``corr_cols``), held also against the JAX package at 2^21, K2's
  GCC on that route (``window_cols`` over the route's column strips) and
  through the spectra in one block (``fft_real_block``, then
  ``corr_block`` a packed cross row with ``CorrOut`` or ``WindowOut``),
  ``spectra_plan``'s launches at every length of the split, the one-block
  versions
  (``gcc_block`` with a scene's rows packed across scenes and couples
  shared over groups, ``corr_block``) against ``gcc_all_pairs_plain`` and
  ``whitened_corr_plain``, and the rules that pick each schedule
  (``gcc_route``, ``corr_schedule``);
- K3, K2 and K5 in one block up to 4,096 points: ``render_block`` (a
  packed base row's two scenes, their packed mic rows mixed, inverted
  and finished one at a time, the noise by its Philox key map) against
  ``delay_sum_plain``, ``window_block`` (``gcc_block``'s body with the
  lag window and the statistics by the kernel's block reductions, ties to
  the smallest index) against ``gcc_windowed_plain``, K5 as the one over
  the other's packed rows, and the rules that pick the schedule of all
  three (``render_route``, ``gcc_route``).
"""

import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
from pyaudiolocalization_tpu_torch.ops import noise as noise_ops

S = 16          # kStrip in csrc/fft.cuh


def _half_table(n):
    """tw[m] = exp(-2 pi i m / n), m < n/2 (``cuda_fft._twiddles``)."""
    return np.exp(-2j * np.pi * np.arange(n // 2) / n)


def _twiddle(tab, e, sgn=1.0):
    """exp(-2 pi i e / n) from the half table: -tab[e - n/2] for
    e >= n/2; the conjugate for sgn < 0."""
    half = tab.shape[0]
    w = np.where(e < half, tab[np.where(e < half, e, 0)],
                 -tab[np.where(e >= half, e - half, 0)])
    return np.conj(w) if sgn < 0 else w


def _w16(e, sgn):
    return np.exp(-2j * np.pi * sgn * e / 16)


def _dft_small(v, sgn):
    """The in-register DFT of R = 2, 4, 8 or 16 points: 8 and 16 as point
    m = R2*a + b (R1 = 4), DFT-4 over a, times W_R^{bc}, DFT-R2 over b,
    bin c + 4*d."""
    R = len(v)
    if R == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if R == 4:
        t0, t1 = v[0] + v[2], v[0] - v[2]
        t2 = v[1] + v[3]
        t3 = -1j * sgn * (v[1] - v[3])
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    R2 = R // 4
    u = [_dft_small([v[R2 * a + b] for a in range(4)], sgn)
         for b in range(R2)]
    u = [[u[b][c] * (_w16(b * c * (16 // R), sgn) if b and c else 1)
          for c in range(4)] for b in range(R2)]
    out = [None] * R
    for c in range(4):
        t = _dft_small([u[b][c] for b in range(R2)], sgn)
        for d in range(R2):
            out[c + 4 * d] = t[d]
    return out


def _stage(x, L, p, R, stw, sgn):
    """One Stockham stage over axis -2 of x (..., L, S)."""
    q = L // R
    i = np.arange(q)
    k = i & (p - 1)
    tstep = L // (p * R)
    v = [x[..., i + m * q, :] for m in range(R)]
    if p > 1:
        v = [v[0]] + [v[m] * _twiddle(stw, m * k * tstep, sgn)[:, None]
                      for m in range(1, R)]
    y = _dft_small(v, sgn)
    out = np.full_like(x, np.nan)
    base = (i - k) * R + k
    for m in range(R):
        out[..., base + m * p, :] = y[m]
    return out


def block_fft(x, sgn=1.0):
    """``block_fft``: the L-point transform of every sequence of a strip
    (..., L, S), point j of sequence s at [..., j, s]."""
    L = x.shape[-2]
    stw = _half_table(L)   # stage_twiddles: tw_n[q * n/L] = exp(-2 pi i q/L)
    p = 1 << ((L.bit_length() - 1) & 3)
    if p > 1:
        x = _stage(x, L, 1, p, stw, sgn)
    while p < L:
        x = _stage(x, L, p, 16, stw, sgn)
        p *= 16
    return x


def _split_bin(zk, zm, odd):
    if not odd:
        return 0.5 * (zk.real + zm.real) + 0.5j * (zk.imag - zm.imag)
    return 0.5 * (zk.imag + zm.imag) - 0.5j * (zk.real - zm.real)


def _pair_row(b, r, n1, pairs):
    own = b * pairs + r % pairs
    if r < pairs:
        return own
    return n1 // 2 if own == 0 else n1 - own


def _pack(x, n):
    """(rows, len) real rows -> (ceil(rows/2), n) complex rows 2c + i*2c+1,
    zero-padded, as the kernels pack them while loading."""
    rows, length = x.shape
    xp = np.zeros((2 * ((rows + 1) // 2), n))
    xp[:rows, :length] = x
    return xp[0::2] + 1j * xp[1::2]


def _split_tables(n, n1, n2):
    """``stage_split_tables``: lo[r] = W_n^r (r < n1), hi[a] = W_n2^a."""
    tab = _half_table(n)
    return tab[:n1], _twiddle(tab, np.arange(n2) * n1)


def _split_twiddle(lo, hi, e, n1):
    """``split_twiddle``: W_n^e = W_n2^{e / n1} * W_n^{e mod n1}, e < n."""
    assert e.max() < n1 * hi.shape[0]
    return hi[e >> (n1.bit_length() - 1)] * lo[e & (n1 - 1)]


def _cols_pass(z, n1, n2, strip=S):
    """K4a's pass 1 (``fft_real_cols``): strips c0 = b*strip of columns j2
    = c0 + s; the strip holds point (j1, s) = z[n2*j1 + c0 + s] -> Y[k1,
    j2] (packed, n1, n2) with the twiddle W_n^{j2 k1}."""
    packed = z.shape[0]
    strips = z.reshape(packed, n1, n2 // strip, strip).transpose(0, 2, 1, 3)
    cols = block_fft(strips)                  # (packed, n2/strip, n1, strip)
    k1 = np.arange(n1)[:, None]
    j2 = (np.arange(n2 // strip)[:, None, None] * strip + np.arange(strip))
    lo, hi = _split_tables(n1 * n2, n1, n2)
    yv = cols * _split_twiddle(lo, hi, j2 * k1, n1)
    return yv.transpose(0, 2, 1, 3).reshape(packed, n1, n2)


def _slot_rows(n1, S2):
    """(n1 / S2, S2): the row k1 in slot r of pass-2 block b."""
    return np.array([[_pair_row(b, r, n1, S2 // 2) for r in range(S2)]
                     for b in range(n1 // S2)])


def _partner(slot_rows, r, k2, n1, n2):
    """The slot and k2 of bin n - k's packed value for slot r, k2 of the
    pass-2 block (rows 0 and n1/2 are their own partners)."""
    pairs = slot_rows.shape[1] // 2
    row = slot_rows[:, :, None] + 0 * k2
    pr = np.where((row == 0) | (row == n1 // 2), r,
                  np.where(r < pairs, r + pairs, r - pairs)) + 0 * k2
    pk = np.where(row == 0, (n2 - k2) & (n2 - 1), n2 - 1 - k2)
    return row, pr, pk


def fft_real_model(x, n):
    """K4a on (rows, len) real rows -> (rows, n/2 + 1), and the count of
    writes to each output bin."""
    rows = x.shape[0]
    z = _pack(x, n)
    packed = z.shape[0]
    n1, n2 = cf.fft_real_split(n)
    if n1 == 1:                                       # fft_real_block
        bins = n // 2 + 1
        out = np.zeros((2 * packed, bins), complex)
        zf = block_fft(z[:, :, None])[..., 0]
        k = np.arange(bins)
        zk, zm = zf[:, k], zf[:, (n - k) & (n - 1)]
        out[0::2], out[1::2] = _split_bin(zk, zm, 0), _split_bin(zk, zm, 1)
        return out[:rows], np.ones((rows, bins), int)
    assert n1 * n2 == n and n1 <= 4096 and n1 % 32 == 0
    assert n1 >= n2 or n > cf.SPLIT_COLS_LONG_MAX   # long side in the rows
    plan = cf.split_plan(n, packed)
    S2 = plan.rows.strip
    assert S2 == cf.fft_real_rows_strip(n2, packed)
    out, writes = rows_pass_model(_cols_pass(z, n1, n2, plan.cols.strip),
                                  n1, n2, S2)
    return out[:rows], writes[:rows]


def rows_pass_model(y, n1, n2, S2):
    """K4a's pass 2 (``fft_real_rows``) on Y (packed, n1, n2) in strips of
    S2 rows -> (2 * packed, n/2 + 1) spectra and the count of writes to
    each bin: block b holds rows pair_row(b, r), r < S2, all blocks at
    once; then each (block, slot r, k2) of the epilogue."""
    packed, n = y.shape[0], n1 * n2
    out = np.zeros((2 * packed, n // 2 + 1), complex)
    writes = np.zeros((2 * packed, n // 2 + 1), int)
    nb, h2 = n1 // S2, n2 // 2
    slot_rows = _slot_rows(n1, S2)                         # (nb, S2)
    buf = block_fft(y[:, slot_rows, :].transpose(0, 1, 3, 2))  # (.,nb,n2,S)
    del y
    b = np.arange(nb)[:, None, None]
    r = np.arange(S2)[None, :, None]
    k2 = np.arange(h2 + 1)[None, None, :]
    row, pr, pk = _partner(slot_rows, r, k2, n1, n2)
    live = (k2 < h2) | (row == 0)          # bin n/2 is row 0's alone
    b, r, k2 = (np.broadcast_to(a, row.shape) for a in (b, r, k2))
    zk = buf[:, b[live], k2[live], r[live]]
    zm = buf[:, b[live], pk[live], pr[live]]
    k = (row + n1 * k2)[live]
    out[0::2, k] = _split_bin(zk, zm, 0)
    out[1::2, k] = _split_bin(zk, zm, 1)
    np.add.at(writes, (slice(None), k), 1)
    return out, writes


def _whiten(a, b):
    r = a * np.conj(b)
    return r / (np.abs(r) + cf.PHAT_EPS)


def _boot_pair(s1, zq, zm, q, n):
    """``boot_pair``: bins q <= n/2 and n - q of the packed whitened
    cross-spectrum from zq = Z[q] and zm = Z[(n - q) mod n]; imaginary
    parts dropped at DC and Nyquist; the mirror as ``store_packed``."""
    assert (q <= n // 2).all()
    s = s1[q]
    edge = (q == 0) | (q == n // 2)
    wa = _whiten(s, _split_bin(zq, zm, 0))
    wb = _whiten(s, _split_bin(zq, zm, 1))
    wa, wb = np.where(edge, wa.real, wa), np.where(edge, wb.real, wb)
    return wa + 1j * wb, np.conj(wa) + 1j * np.conj(wb)


def _boot_tasks(b, S2, n1, n2):
    """``boot_rows``' whitening tasks of block b: (slot, k2, row) of each
    pair's first bin and (slot, k2) of its mirror, task t at r = t mod
    S2/2 (row-fastest), k2 = t div S2/2; block 0 has one task more."""
    pairs = S2 // 2
    t = np.arange(pairs * n2 + (b == 0))
    r, k2 = t % pairs, t // pairs
    row = b * pairs + r
    pr, pk = r + pairs, n2 - 1 - k2
    zero = (row == 0) & (k2 <= n2 // 2)        # row 0, its own partner
    mid = (row == 0) & (k2 > n2 // 2)          # row n1/2 in slot S2/2
    pr = np.where(zero, 0, pr)
    pk = np.where(zero, (n2 - k2) & (n2 - 1), pk)
    r = np.where(mid, pairs, r)
    k2 = np.where(mid, k2 - n2 // 2 - 1, k2)
    pk = np.where(mid, n2 - 1 - k2, pk)
    row = np.where(mid, n1 // 2, row)
    return r, k2, row, pr, pk


def bootstrap_peaks_model(s1, x, n, strip=None):
    """K4b on (rows, len) real rows against s1 (n/2 + 1,) -> ((rows,)
    maxima, (rows, n) correlations in natural order), following the
    kernels: one block for n <= 4096 (``boot_block``), else K4a's pass 1,
    ``boot_rows`` (``strip`` rows a block; the kernel's by default,
    ``boot_strip``: 16, 8 at n2 = 1,024, 4 at 2,048, 2 at 4,096) and
    ``boot_cols`` (pass 1's
    strips of columns).  Asserts that the whitening's tasks
    cover every bin once (a pair's two bins, or a self-mirrored bin), that
    pass 2 writes every row k1 once, and that its tasks read s1 at
    consecutive bins."""
    rows = x.shape[0]
    z = _pack(x, n)
    packed = z.shape[0]
    n1, n2 = cf.fft_real_split(n)
    if n1 == 1:                                       # boot_block
        zf = block_fft(z[:, :, None])[..., 0]
        q = np.arange(n // 2 + 1)
        m = (n - q) & (n - 1)
        zf[:, q], zf[:, m] = _boot_pair(s1, zf[:, q], zf[:, m], q, n)
        natural = block_fft(zf[:, :, None], -1.0)[..., 0]
        maxima = np.stack([natural.real.max(-1), natural.imag.max(-1)], -1)
    else:
        plan = cf.split_plan(n, packed)
        cs, rs = plan.cols.strip, plan.boot_rows.strip
        assert (cs, rs) == (cf.split_strips(n1, n2)[0],
                            cf.boot_strip(n1, n2))
        assert plan.boot_cols.strip == cs
        y = _cols_pass(z, n1, n2, cs)
        # Pass 2 (boot_rows), then times W_n^{-j2 k1}, written back in
        # place.
        inv, slot_rows = boot_rows_model(y, s1, n1, n2, strip or rs)
        lo, hi = _split_tables(n, n1, n2)
        e = np.arange(n2)[None, :, None] * slot_rows[:, None, :]
        w = np.conj(_split_twiddle(lo, hi, e, n1))
        assert np.array_equal(np.bincount(slot_rows.ravel(), minlength=n1),
                              np.ones(n1, int))
        y[:, slot_rows, :] = (inv * w).transpose(0, 1, 3, 2)
        # Pass 3 (boot_cols): pass 1's strips of cs columns j2, the inverse
        # column DFTs; each block's maxima, then their maximum (the
        # atomics).
        strips = y.reshape(packed, n1, n2 // cs, cs).transpose(0, 2, 1, 3)
        del y
        cols = block_fft(strips, -1.0)               # (packed, n2/cs, n1, cs)
        maxima = np.stack([cols.real.max(axis=(2, 3)).max(-1),
                           cols.imag.max(axis=(2, 3)).max(-1)], -1)
        natural = cols.transpose(0, 2, 1, 3).reshape(packed, n)
    corr = np.stack([natural.real, natural.imag], 1).reshape(-1, n) / n
    return maxima.reshape(-1)[:rows] / n, corr[:rows]


def boot_rows_model(y, s1, n1, n2, S2):
    """``boot_rows`` (``boot_rows_long`` above 2^26) on Y (packed, n1, n2)
    in strips of S2 rows, up to its inverse twiddle: the forward row DFTs
    of each block's slots, the whitening block by block, one task a
    mirror pair, and the inverse row DFTs -> ((packed, n1 / S2, n2, S2)
    rows, (n1 / S2, S2) the row k1 in each slot).  Asserts that the
    tasks cover every bin once (a pair's two bins, or a self-mirrored
    bin) and read s1 at consecutive bins."""
    n = n1 * n2
    nb = n1 // S2
    slot_rows = _slot_rows(n1, S2)                     # (nb, S2)
    buf = block_fft(y[:, slot_rows, :].transpose(0, 1, 3, 2))
    seen = np.zeros(n, int)
    for b in range(nb):
        r, k2, row, pr, pk = _boot_tasks(b, S2, n1, n2)
        assert (slot_rows[b, r] == row).all()
        p = row + n1 * k2
        pm = slot_rows[b, pr] + n1 * pk
        assert ((p + pm) % n == 0).all()
        np.add.at(seen, p, 1)
        np.add.at(seen, pm[pm != p], 1)
        low = p <= n // 2
        q = np.where(low, p, pm)
        assert (np.abs(np.diff(q[:S2 // 2 - (b == 0)])) == 1).all()
        zr, zp = buf[:, b, k2, r], buf[:, b, pk, pr]
        yq, ym = _boot_pair(s1, np.where(low, zr, zp),
                            np.where(low, zp, zr), q, n)
        buf[:, b, pk, pr] = np.where(low, ym, yq)
        buf[:, b, k2, r] = np.where(low, yq, ym)   # self pairs: yq
    assert np.array_equal(seen, np.ones(n, int))
    return block_fft(buf, -1.0), slot_rows


def row_stages_model(xr, xi, n2, inverse=False, rep=1, scale=1.0,
                     out_r=None, mode=0):
    """K10b on (B, rows_in, 128) planes: per rep one launch; each block a
    strip of S lanes; rows >= rows_in zero; the input scaled on load."""
    sgn = -1.0 if inverse else 1.0
    cur = xr + (0 if xi is None else 1j * xi)
    for it in range(rep):
        planes, rows_in, lanes = cur.shape
        strips = np.zeros((planes, lanes // S, n2, S), complex)
        sc = 1e-3 if it else scale
        strips[:, :, :rows_in] = (cur * sc).reshape(
            planes, rows_in, lanes // S, S).transpose(0, 2, 1, 3)
        done = block_fft(strips, sgn)
        cur = done.transpose(0, 2, 1, 3).reshape(planes, n2, lanes)
    if mode == 0:
        return cur.real, cur.imag
    if mode == 1:
        return cur.real
    return out_r + cur.real


def _rows(rng, rows, length):
    return rng.standard_normal((rows, length))


@pytest.mark.parametrize("bits", range(2, 21))
def test_fft_real_schedule_matches_rfft(bits):
    """Every n from 4 to 2^20 at 1, 2 and 3 rows with len < n; each bin
    written exactly once, DC and Nyquist exactly real."""
    n = 1 << bits
    rng = np.random.default_rng(bits)
    for rows in (1, 2, 3):
        length = max(1, n - n // 4 - 1)
        x = _rows(rng, rows, length)
        got, writes = fft_real_model(x, n)
        want = np.fft.rfft(x, n=n)
        assert np.array_equal(writes, np.ones_like(writes)), (n, rows)
        assert np.abs(got - want).max() < 1e-9 * np.abs(want).max(), (n, rows)
        assert not got[:, 0].imag.any() and not got[:, -1].imag.any()


@pytest.mark.parametrize("n,strip", [(8192, 64), (65536, 64), (1 << 18, 32)])
def test_fft_real_schedule_wide_strips(n, strip, monkeypatch):
    """Pass 2 with 64- and 32-row strips, which the kernel takes from 64
    packed rows on; the rule is patched to take them at 3 rows."""
    rule = cf.fft_real_rows_strip
    assert rule(cf.fft_real_split(n)[1], 64) == strip
    monkeypatch.setattr(cf, "fft_real_rows_strip",
                        lambda n2, packed: rule(n2, 64))
    x = _rows(np.random.default_rng(n), 3, n - 100)
    got, writes = fft_real_model(x, n)
    want = np.fft.rfft(x, n=n)
    assert np.array_equal(writes, np.ones_like(writes))
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("bits,rows", [(23, 1), (23, 2), (24, 2)])
def test_fft_real_schedule_above_2_22(bits, rows):
    """2^23 (2,048 x 4,096: the long side in the rows, pass 1's strips of 8
    columns, pass 2's of 4 rows) and 2^24 (4,096 x 4,096: 4 columns, 4
    rows), the split past its square shapes (``SPLIT_COLS_LONG_MAX``), against
    np.fft.rfft, one and two rows (one packed row): each bin written
    exactly once, DC and Nyquist exactly real."""
    n = 1 << bits
    n1, n2 = cf.fft_real_split(n)
    assert (n1, n2) == ((2048, 4096) if bits == 23 else (4096, 4096))
    assert cf._split_n1(n) == n1 and cf.corr_schedule(n) == n1
    assert cf.split_strips(n1, n2) == ((8, 4) if bits == 23 else (4, 4))
    assert cf.fft_real_rows_strip(n2, 1) == 4
    x = _rows(np.random.default_rng(bits + 10 * rows), rows,
              n - n // 4 - 1)
    got, writes = fft_real_model(x, n)
    want = np.fft.rfft(x, n=n)
    assert np.array_equal(writes, np.ones_like(writes))
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
    assert not got[:, 0].imag.any() and not got[:, -1].imag.any()


@pytest.mark.parametrize("bits,rows", [(21, 1), (21, 3), (22, 1), (22, 2)])
def test_fft_real_schedule_above_2_20(bits, rows):
    """2^21 (2,048 x 1,024: pass 1's strips of 8 columns, pass 2's of 16
    rows) and 2^22 (2,048 x 2,048: 8 columns, pass 2's 8 rows) against
    np.fft.rfft, odd and even row counts: each bin written exactly once,
    DC and Nyquist exactly real."""
    n = 1 << bits
    n1, n2 = cf.fft_real_split(n)
    assert cf._split_n1(n) == n1 == 2048
    assert cf.split_strips(n1, n2)[0] == 8
    assert cf.fft_real_rows_strip(n2, (rows + 1) // 2) == (16 if bits == 21
                                                           else 8)
    x = _rows(np.random.default_rng(bits + 10 * rows), rows,
              n - n // 4 - 1)
    got, writes = fft_real_model(x, n)
    want = np.fft.rfft(x, n=n)
    assert np.array_equal(writes, np.ones_like(writes))
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
    assert not got[:, 0].imag.any() and not got[:, -1].imag.any()


def _boot_case(rng, rows, n):
    """s1 (n/2 + 1,) random complex (imaginary parts at DC and Nyquist
    too) and rows of len < n."""
    s1 = rng.standard_normal(n // 2 + 1) + 1j * rng.standard_normal(
        n // 2 + 1)
    return s1, _rows(rng, rows, max(1, n - n // 4 - 1))


def _boot_reference(s1, x, n):
    return np.fft.irfft(_whiten(s1[None, :], np.fft.rfft(x, n=n)), n=n)


def _check_boot(s1, x, n, strip=None):
    peaks, corr = bootstrap_peaks_model(s1, x, n, strip)
    want = _boot_reference(s1, x, n)
    tol = 1e-9 * np.abs(want).max()
    assert np.abs(corr - want).max() < tol, n
    assert np.abs(peaks - want.max(-1)).max() < tol, n
    plain = cf.bootstrap_peaks_plain(torch.from_numpy(s1), torch.from_numpy(x),
                                     n).numpy()
    assert np.abs(peaks - plain).max() < tol, n


@pytest.mark.parametrize("bits", range(3, 18))
def test_bootstrap_schedule_matches_irfft(bits):
    """K4b's index maps at every n from 8 to 2^17 (one block up to 4096,
    the split from 8192) at 1, 2 and 3 rows: the correlations and their
    maxima against irfft(whiten(s1 * conj(rfft(row)))) and against
    ``bootstrap_peaks_plain``."""
    n = 1 << bits
    rng = np.random.default_rng(100 + bits)
    for rows in (1, 2, 3):
        _check_boot(*_boot_case(rng, rows, n), n)


def test_bootstrap_schedule_largest_split():
    """2^22, the largest square split (2,048 x 2,048: strips of 8 columns,
    ``boot_rows``' of 4 rows), at one row."""
    n = cf.SPLIT_COLS_LONG_MAX
    assert cf.split_strips(*cf.fft_real_split(n))[0] == 8
    assert cf.boot_strip(*cf.fft_real_split(n)) == 4
    _check_boot(*_boot_case(np.random.default_rng(22), 1, n), n)


@pytest.mark.parametrize("bits", [23, 24])
def test_bootstrap_schedule_above_2_22(bits):
    """K4b's split past 2^22, the long side in the rows: 2^23 (2,048 x
    4,096: column strips of 8, ``boot_rows``' of 2 rows, row k1 and its
    partner) and 2^24 (4,096 x 4,096: 4 and 2), at one row."""
    n = 1 << bits
    assert cf._split_n1(n) == cf.fft_real_split(n)[0]
    assert cf.boot_strip(*cf.fft_real_split(n)) == 2
    _check_boot(*_boot_case(np.random.default_rng(bits), 1, n), n)


@pytest.mark.parametrize("bits", [20, 21])
def test_bootstrap_schedule_long_splits(bits):
    """2^20 (1,024 x 1,024, the largest split of column strips of 16,
    ``boot_rows``' of 8 rows) and 2^21 (2,048 x 1,024: 8 columns a column
    strip, 8 rows a row strip) at one row."""
    n = 1 << bits
    _check_boot(*_boot_case(np.random.default_rng(bits), 1, n), n)


@pytest.mark.parametrize("n", [8192, 65536, 131072, 1 << 18])
@pytest.mark.parametrize("strip", [16, 32, 64])
def test_bootstrap_schedule_strips(n, strip):
    """Pass 2's task map (mirror pairs, row 0's and row n1/2's own pairs in
    block 0, the extra task) holds for strips of 16, 32 and 64 rows; the
    kernel holds 16 (kStrip), the production lengths' n2 = 256 at 65,536
    and 131,072."""
    _check_boot(*_boot_case(np.random.default_rng(n + strip), 3, n), n,
                strip)


@pytest.mark.parametrize("n", [64, 128, 4096, 8192])
def test_fft_real_split_choice(n):
    """Up to 4096 one block; from 8192 on n1 >= n2, both <= 1024, and
    pass 2 has whole blocks of S rows."""
    n1, n2 = cf.fft_real_split(n)
    assert n1 * n2 == n
    if n <= cf.FFT_REAL_ONE_BLOCK:
        assert n1 == 1
    else:
        assert n2 <= n1 <= 2 * n2 and n1 % 32 == 0 and n2 % S == 0
        assert cf.fft_real_rows_strip(n2, 63) == 16
        assert n1 % cf.fft_real_rows_strip(n2, 64) == 0
    assert cf.fft_real_split(cf.SPLIT_COLS_LONG_MAX) == (2048, 2048)
    assert cf.fft_real_split(2 * cf.SPLIT_COLS_LONG_MAX) == (2048, 4096)
    assert cf.fft_real_split(1 << 24) == (4096, 4096)
    assert cf.fft_real_split(cf.FFT_SPLIT_MAX) == (4096, 4096)


@pytest.mark.parametrize("n,strips,rows_strip", [
    (8192, (16, 16), 16), (1 << 16, (16, 16), 16), (1 << 18, (16, 16), 16),
    (1 << 20, (16, 16), 16), (1 << 21, (8, 16), 16), (1 << 22, (8, 8), 8),
    (1 << 23, (8, 4), 4), (1 << 24, (4, 4), 4)])
def test_split_strips_rule(n, strips, rows_strip):
    """K4a's, K4b's, K6's and the spectra routes' strips (``split_strips``):
    16 columns and 16 rows up to n1 = 1,024 (every shape up to 2^20 keeps
    its strips), 8 columns at n1 = 2,048 and 8 rows at n2 = 2,048, 4 at
    4,096 (2^23's rows, both of 2^24's); K4a's pass 2 8 rows at n2 = 2,048
    and 4 at 4,096; K4b's and K6's row pass half the points of the
    spectra routes' from n2 = 1,024 (``boot_strip``: at most 512 threads).
    Each strip holds at most ``BLOCK_POINTS`` points and its pass fits one
    block's shared memory (the kernels' byte counts); the next wider strip
    does not fit where a narrower one is taken; ``split_plan`` and
    ``spectra_plan`` give the same strips.  The split reaches 2^24 for
    every transforming kernel (K9's schedule is K4a's), one limit
    (``FFT_SPLIT_MAX``), its row passes of more than one strip 2^20
    (``STAGE_SPLIT_MAX``)."""
    n1, n2 = cf.fft_real_split(n)
    assert cf.split_strips(n1, n2) == strips
    assert cf.fft_real_rows_strip(n2, 1) == rows_strip
    plan = cf.split_plan(n)
    assert plan.cols.strip == strips[0]
    boot = plan.boot_rows.strip
    assert boot == cf.boot_strip(n1, n2) == (
        strips[1] if n2 <= 512 else strips[1] // 2)
    assert n2 <= 256 or n2 * boot <= cf.BLOCK_POINTS // 2
    assert plan.rows.strip == rows_strip
    cs, rs = strips
    assert n1 * cs <= cf.BLOCK_POINTS and n2 * rs <= cf.BLOCK_POINTS
    assert n2 % cs == 0 and n1 % rs == 0 and n1 % rows_strip == 0
    assert 8 * (n1 // 2 + n1 + n2 + n1 * cs) <= cf.SMEM_OPTIN
    assert 8 * (n2 // 2 + n1 + n2 + rs * (n2 + 1)) <= cf.SMEM_OPTIN
    assert 8 * (n2 // 2 + rows_strip * (n2 + 1)) <= cf.SMEM_OPTIN
    if cs < 16:
        assert n1 * 2 * cs > cf.BLOCK_POINTS
    if rs < 16:
        assert n2 * 2 * rs > cf.BLOCK_POINTS
    assert cf._split_n1(n) == n1
    assert cf._split_strips(n1, n) == (strips[0], boot)
    assert cf.corr_schedule(n) == n1
    spectra = cf.spectra_plan(n)
    assert (spectra.spec_cols.strip, spectra.spec_rows.strip) == strips
    # Above 2^24 K9, as K4a, K4b and K6, takes the three-pass split
    # (``long_plan``).
    assert cf.corr_schedule(2 * cf.FFT_SPLIT_MAX) == 16384
    assert cf._split_n1(2 * cf.FFT_SPLIT_MAX) == 16384
    assert cf._split_strips(16384, 2 * cf.FFT_SPLIT_MAX) == (16, 2)
    assert cf.STAGE_SPLIT_MAX == 1 << 20 and cf.SPLIT_COLS_LONG_MAX == 1 << 22
    assert cf.FFT_SPLIT_MAX == 1 << 24
    assert not hasattr(cf, "SPECTRA_SPLIT_MAX")


@pytest.mark.parametrize("bits", range(13, 25))
def test_split_plan_rule(bits):
    """``split_plan`` at every length of the split, 8,192 to 2^24: each
    pass's strip as ``split_strips`` and ``fft_real_rows_strip`` give it,
    at most ``BLOCK_POINTS`` points and ``SMEM_OPTIN`` bytes a block (the
    kernels' byte counts, the row strips at the stride ``row_ld``), for
    1, 2 and 64 packed rows; up to 2^20 the rows at the odd stride n2 + 1
    as before, and only strips of 16 columns there, of 16 rows up to n2 =
    512 (``boot_strip``)."""
    n = 1 << bits
    n1, n2 = cf.fft_real_split(n)
    cs, rs = cf.split_strips(n1, n2)[0], cf.boot_strip(n1, n2)
    for packed in (1, 2, 64):
        plan = cf.split_plan(n, packed)
        s2 = cf.fft_real_rows_strip(n2, packed)
        assert plan.cols == (cs, 8 * (n1 // 2 + n1 + n2 + n1 * cs))
        assert plan.rows == (s2, 8 * (n2 // 2 + s2 * cf.row_ld(s2, n2)))
        assert plan.boot_rows == (rs, 8 * (n2 // 2 + n1 + n2
                                           + rs * cf.row_ld(rs, n2)))
        assert plan.boot_cols == (cs, 8 * (n1 // 2 + n1 * cs) + 128)
        for step, length in ((plan.cols, n1), (plan.rows, n2),
                             (plan.boot_rows, n2), (plan.boot_cols, n1)):
            assert step.strip * length <= cf.BLOCK_POINTS
            assert step.smem <= cf.SMEM_OPTIN
        if n <= cf.STAGE_SPLIT_MAX:
            assert cf.row_ld(s2, n2) == n2 + 1 and cs == 16 and s2 >= 16
            assert rs == (16 if n2 <= 512 else 8)
    with pytest.raises(ValueError):
        cf.split_plan(cf.FFT_REAL_ONE_BLOCK)
    with pytest.raises(ValueError):
        cf.split_plan(2 * cf.FFT_SPLIT_MAX)


@pytest.mark.parametrize("bits", range(13, 25))
def test_split_twiddle_tables(bits):
    """Above 2^20 the twiddle table (``_twiddles``) carries the half tables
    of n1 and n2 after the n-point one, which K4a's, K4b's and K6's split
    kernels read contiguously (``stage_split_twiddles``) in place of every
    n2-th and n1-th entry of the n-point table: the same float32 bits.  Up
    to 2^20 the table is the n-point one alone, read as before."""
    n = 1 << bits
    n1, n2 = cf.fft_real_split(n)
    tab = cf._twiddles(n, "cpu").numpy()
    if n <= cf.STAGE_SPLIT_MAX:
        assert tab.shape == (n // 2, 2)
        return
    assert tab.shape == (n // 2 + n1 // 2 + n2 // 2, 2)
    t1, t2 = tab[n // 2:n // 2 + n1 // 2], tab[n // 2 + n1 // 2:]
    assert np.array_equal(t1.view(np.int32), tab[:n // 2:n2].view(np.int32))
    assert np.array_equal(t2.view(np.int32), tab[:n // 2:n1].view(np.int32))
    assert cf._twiddles(4096, "cpu").shape == (2048, 2)
    # Past the split (2^25, a table of 2^24 entries: its lengths only):
    # the three-pass split's n1 and n2, then n1a and n1b.
    assert cf._twiddle_lengths(2 * cf.FFT_SPLIT_MAX) == [
        2 * cf.FFT_SPLIT_MAX, 16384, 2048, 128, 128]


@pytest.mark.parametrize("n1,n2,strip", [(2048, 1024, 8), (2048, 2048, 8),
                                         (2048, 4096, 8), (4096, 4096, 4)])
@pytest.mark.parametrize("s2", [4, 8, 16])
def test_split_maps(n1, n2, strip, s2):
    """The split's maps at its long shapes, a block alone: the column
    passes' load (``_strip_points``; K4a's and K4b's pass 1, K4b's pass 3)
    reads every point once, in runs of ``strip`` consecutive columns a
    row, and pass 2's epilogue (strips of ``s2`` rows and their partners,
    ``fft_real_rows``) writes every bin 0 .. n/2 once, each from its own
    packed value and its mirror n - k's."""
    n = n1 * n2
    land = _strip_points(n1, n2, strip)
    assert np.array_equal(np.bincount(land.ravel(), minlength=n),
                          np.ones(n, int))
    assert (np.diff(land.reshape(-1, strip), axis=-1) == 1).all()
    if n2 * s2 > cf.BLOCK_POINTS:
        return                                  # no block holds the strip
    slot_rows = _slot_rows(n1, s2)
    h2 = n2 // 2
    r = np.arange(s2)[None, :, None]
    k2 = np.arange(h2 + 1)[None, None, :]
    row, pr, pk = _partner(slot_rows, r, k2, n1, n2)
    live = (k2 < h2) | (row == 0)
    b = np.broadcast_to(np.arange(n1 // s2)[:, None, None], row.shape)
    k = (row + n1 * k2)[live]
    mirror = (slot_rows[b, pr] + n1 * pk)[live]
    assert np.array_equal(np.bincount(k, minlength=n // 2 + 1),
                          np.ones(n // 2 + 1, int))
    assert ((k + mirror) % n == 0).all()


@pytest.mark.parametrize("bits", [21, 22, 23, 24])
def test_noise_bootstrap_schedule_above_2_20(bits):
    """K6 above 2^20: the noise loader's counter map over the column
    pass's strips (``noise_rows_model``: every sample drawn once at its
    own counter), then K4b's split, against
    irfft(whiten(s1 * conj(rfft(draw)))) and ``noise_bootstrap_peaks_plain``,
    at one draw of a recording's length."""
    n = 1 << bits
    rng = np.random.default_rng(200 + bits)
    seeds = rng.integers(-2 ** 31, 2 ** 31, (1, 2)).astype(np.int32)
    n_samp = n - n // 4 - 1
    rows, reads = noise_rows_model(seeds, n_samp, n)
    assert np.array_equal(reads, np.ones(n, int))
    s1 = rng.standard_normal(n // 2 + 1) + 1j * rng.standard_normal(
        n // 2 + 1)
    x = rows.astype(np.float64)
    del rows, reads
    _check_boot(s1, x, n)
    plain = cf.noise_bootstrap_peaks_plain(
        torch.from_numpy(s1), torch.from_numpy(seeds), n_samp, n)
    assert torch.equal(plain, cf.bootstrap_peaks_plain(
        torch.from_numpy(s1), torch.from_numpy(x), n))


@pytest.mark.parametrize("n2", [64, 128, 256, 512, 1024])
def test_row_stages_schedule_matches_fft(n2):
    """Forward, zero_top, the unscaled inverse, real input, rep chains and
    the real-part modes 1 and 2 against np.fft along the rows."""
    rng = np.random.default_rng(n2)
    xr = rng.standard_normal((3, n2, 128))
    xi = rng.standard_normal((3, n2, 128))
    z = xr + 1j * xi
    yr, yi = row_stages_model(xr, xi, n2)
    want = np.fft.fft(z, axis=1)
    tol = 1e-9 * np.abs(want).max()
    assert np.abs(yr + 1j * yi - want).max() < tol
    yr, yi = row_stages_model(xr[:, :n2 // 2], None, n2, scale=0.5)
    want = np.fft.fft(0.5 * xr[:, :n2 // 2], n=n2, axis=1)
    assert np.abs(yr + 1j * yi - want).max() < tol
    yr, yi = row_stages_model(xr, xi, n2, inverse=True)
    assert np.abs(yr + 1j * yi - n2 * np.fft.ifft(z, axis=1)).max() < tol
    want = z
    for it in range(3):
        want = np.fft.fft(want * (1e-3 if it else 1.0), axis=1)
    yr, yi = row_stages_model(xr, xi, n2, rep=3)
    assert np.abs(yr + 1j * yi - want).max() < 1e-9 * np.abs(want).max()
    inv = n2 * np.fft.ifft(z, axis=1)
    got = row_stages_model(xr, xi, n2, inverse=True, mode=1)
    assert np.abs(got - inv.real).max() < tol
    acc = rng.standard_normal((3, n2, 128))
    got = row_stages_model(xr, xi, n2, inverse=True, out_r=acc, mode=2)
    assert np.abs(got - (acc + inv.real)).max() < tol


# ---------------------------------------------------------------------------
# K6's loader; the render and windowed-GCC stages on the split (K3, K2, K5)
# ---------------------------------------------------------------------------

def _strip_points(n1, n2, strip=S):
    """Point t that pass 1 (``fft_real_cols``) loads into slot idx =
    j1*strip + s of column strip c0 = b*strip: (n2 / strip, n1 * strip)."""
    idx = np.arange(n1 * strip)
    return ((idx // strip) * n2 + np.arange(n2 // strip)[:, None] * strip
            + idx % strip)


def noise_rows_model(seeds, n_samp, n):
    """``NoiseLoad`` as the kernels call it -> (rows, n) draws, and the
    count of reads of each point: draw d = 2c + h of packed row c, point t
    = Philox word 0 at counter t with key seeds[d] as int32 times 2^-32
    for t < n_samp, else 0.  One block (n <= 4096) reads t = thread + u *
    blockDim; the split's pass 1 reads ``_strip_points``."""
    rows = seeds.shape[0]
    n1, n2 = cf.fft_real_split(n)
    if n1 == 1:
        t = np.arange(n)
    else:
        t = _strip_points(n1, n2, cf.split_plan(n).cols.strip).ravel()
    reads = np.bincount(t, minlength=n)
    key = seeds.astype(np.int64) & 0xFFFFFFFF
    w0, _ = noise_ops.philox_bits(torch.from_numpy(key[:, :1]),
                                  torch.from_numpy(key[:, 1:]),
                                  torch.from_numpy(t.astype(np.int64)))
    w0 = w0.numpy()
    draws = np.where(w0 >= 2 ** 31, w0 - 2 ** 32, w0).astype(np.float32)
    out = np.zeros((rows, n), np.float32)
    out[:, t] = np.where(t < n_samp, draws * np.float32(2.0 ** -32), 0.0)
    return out, reads


@pytest.mark.parametrize("n,n_samp", [(128, 100), (4096, 1500),
                                      (8192, 8192), (65536, 44100),
                                      (131072, 44100),
                                      (1 << 21, 1_046_019)])
def test_noise_loader_counter_map(n, n_samp):
    """Every draw reads each sample t once, at slot t (counter t), zero
    from n_samp on: the loaded rows are ``noise_ops.uniform`` zero-padded,
    so K6 is K4b on those rows (the model's peaks against the twin's)."""
    rng = np.random.default_rng(n)
    seeds = rng.integers(-2 ** 31, 2 ** 31, (3, 2)).astype(np.int32)
    rows, reads = noise_rows_model(seeds, n_samp, n)
    assert np.array_equal(reads, np.ones(n, int))
    want = noise_ops.uniform(torch.from_numpy(seeds), n_samp).numpy()
    assert np.array_equal(rows[:, :n_samp], want)
    assert not rows[:, n_samp:].any()
    if n <= 8192:
        s1 = rng.standard_normal(n // 2 + 1) + 1j * rng.standard_normal(
            n // 2 + 1)
        x = rows.astype(np.float64)
        peaks, _ = bootstrap_peaks_model(s1, x, n)
        plain = cf.noise_bootstrap_peaks_plain(
            torch.from_numpy(s1), torch.from_numpy(seeds), n_samp, n).numpy()
        assert np.abs(peaks - plain).max() < 1e-9 * np.abs(plain).max()


def _block_tasks(nb, strip, n1, n2):
    """Every row-pass block's mirror-pair tasks (``pair_task``) at once:
    (block, slot, k2, row, partner slot, partner k2, lower bin q, whether
    (slot, k2) holds q)."""
    parts = [(np.full(len(t[0]), b),) + tuple(t)
             for b, t in ((b, _boot_tasks(b, strip, n1, n2))
                          for b in range(nb))]
    bi, r, k2, row, pr, pk = (np.concatenate(a) for a in zip(*parts))
    slot_rows = _slot_rows(n1, strip)
    p = row + n1 * k2
    mirror = slot_rows[bi, pr] + n1 * pk
    n = n1 * n2
    assert ((p + mirror) % n == 0).all()
    low = p <= n // 2
    return bi, r, k2, pr, pk, np.where(low, p, mirror), low


def _store_pairs(work, tasks, ya, yb, n):
    """``store_pair`` of every task into work (blocks, n2, S): bins q and
    n - q of the packed Hermitian pair ya + i*yb, imaginary parts dropped
    at DC and Nyquist.  Asserts that the tasks write every place once."""
    bi, r, k2, pr, pk, q, low = tasks
    edge = (q == 0) | (q == n // 2)
    ya = np.where(edge, ya.real, ya)
    yb = np.where(edge, yb.real, yb)
    vq, vm = ya + 1j * yb, np.conj(ya) + 1j * np.conj(yb)
    seen = np.zeros(work.shape, int)
    at = (bi, np.where(low, k2, pk), np.where(low, r, pr))
    mi = (bi, np.where(low, pk, k2), np.where(low, pr, r))
    work[at] = vq
    np.add.at(seen, at, 1)
    work[tuple(a[~edge] for a in mi)] = vm[~edge]
    np.add.at(seen, tuple(a[~edge] for a in mi), 1)
    assert np.array_equal(seen, np.ones_like(seen))


def _pair_bins(strips, tasks):
    """(Z[q], Z[n - q]) of every task from strips (blocks, n2, S)."""
    bi, r, k2, pr, pk, q, low = tasks
    zr, zp = strips[bi, k2, r], strips[bi, pk, pr]
    return np.where(low, zr, zp), np.where(low, zp, zr)


def _rows_back(work, slot_rows, n1, n2):
    """The inverse row DFTs of work (blocks, n2, S) times W_n^{-j2 k1},
    as rows k1 of a (n1, n2) pass-1 layout (``store_rows``)."""
    inv = block_fft(work, -1.0)
    lo, hi = _split_tables(n1 * n2, n1, n2)
    e = np.arange(n2)[None, :, None] * slot_rows[:, None, :]
    out = np.zeros((n1, n2), complex)
    out[slot_rows, :] = (inv * np.conj(_split_twiddle(lo, hi, e, n1))
                         ).transpose(0, 2, 1)
    return out


def _cols_back(y, n1, n2, strip=S):
    """The inverse column DFTs of y (rows, n1, n2) by strips of ``strip``
    columns (``cols_inverse``): (rows, n2 / strip, n1, strip), slot (j1, s)
    of strip b holding sample n2*j1 + b*strip + s."""
    rows = y.shape[0]
    return block_fft(y.reshape(rows, n1, n2 // strip, strip).transpose(
        0, 2, 1, 3), -1.0)


def _mic_response(tau, gain, q, n):
    """``mic_response``: sum_p g_p exp(-2 pi i q tau_p / n), the phase
    reduced by whole turns."""
    turns = q[:, None] * tau[None, :] / n
    turns -= np.floor(turns)
    return (gain[None, :] * np.exp(-2j * np.pi * turns)).sum(-1)


def render_split_model(base, tau, gain, n, strip=S):
    """K3's render stage on the split: base (scenes, len), tau / gain
    (scenes, mics, paths) -> (scenes, mics, n) the packed inverse of the
    mixes over n (natural order).  ``render_rows``: block (b, cb) of the
    packed base row cb mixes packed mic rows [cb * mics, (cb + 1) *
    mics), one at a time; ``render_cols`` writes in place."""
    scenes = base.shape[0]
    mics, paths = tau.shape[1:]
    n1, n2 = cf.fft_real_split(n)
    y = _cols_pass(_pack(base, n), n1, n2)
    slot_rows = _slot_rows(n1, strip)
    nb = n1 // strip
    bufs = block_fft(y[:, slot_rows, :].transpose(0, 1, 3, 2))
    tasks = _block_tasks(nb, strip, n1, n2)
    q = tasks[5]
    rows = scenes * mics
    packed = (rows + 1) // 2
    tau_r, gain_r = tau.reshape(rows, paths), gain.reshape(rows, paths)
    z = np.full((packed, n1, n2), np.nan, complex)
    for cb in range(bufs.shape[0]):
        zq, zm = _pair_bins(bufs[cb], tasks)
        for pm in range(cb * mics, min((cb + 1) * mics, packed)):
            ra, rb = 2 * pm, 2 * pm + 1
            assert ra // mics >> 1 == cb and (rb >= rows or rb // mics >> 1
                                              == cb)
            ya = _split_bin(zq, zm, (ra // mics) & 1) * _mic_response(
                tau_r[ra], gain_r[ra], q, n)
            yb = np.zeros_like(ya)
            if rb < rows:
                yb = _split_bin(zq, zm, (rb // mics) & 1) * _mic_response(
                    tau_r[rb], gain_r[rb], q, n)
            work = np.full((nb, n2, strip), np.nan, complex)
            _store_pairs(work, tasks, ya, yb, n)
            z[pm] = _rows_back(work, slot_rows, n1, n2)
    assert not np.isnan(z).any()
    cols = _cols_back(z, n1, n2)
    natural = cols.transpose(0, 2, 1, 3).reshape(packed, n)
    out = np.stack([natural.real, natural.imag], 1).reshape(-1, n)[:rows]
    return out.reshape(scenes, mics, n) / n


def _render_case(rng, scenes, mics, paths, n):
    length = n - n // 4
    base = rng.standard_normal((scenes, length))
    tau = rng.uniform(0, n // 4, (scenes, mics, paths))
    gain = rng.uniform(0.1, 1.0, (scenes, mics, paths))
    return base, tau, gain


@pytest.mark.parametrize("mics,paths", [(2, 1), (3, 3), (4, 1), (8, 3)])
@pytest.mark.parametrize("n,strip", [(8192, 16), (16384, 32), (65536, 16)])
def test_render_split_matches_delay_sum(mics, paths, n, strip):
    """The render's index maps (a packed base row's scenes to its mic
    rows, odd mic counts packed across scenes, the mixes on every mirror
    pair, the inverse row and column passes) at 3 scenes against
    ``delay_sum_plain``'s transform (no finalize, fade 1)."""
    rng = np.random.default_rng(mics * 100 + paths + n)
    base, tau, gain = _render_case(rng, 3, mics, paths, n)
    got = render_split_model(base, tau, gain, n, strip)
    t = torch.from_numpy
    want = cf.delay_sum_plain(t(base), t(tau), t(gain), n, n,
                              torch.ones(n, dtype=torch.float64),
                              False).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


def render_spectra_model(base, tau, gain, n, strips=None, spec=None):
    """K3's render stage through the base rows' spectra (``render_route``'s
    spectra route, 2^20 to 2^26): base (scenes, len), tau / gain (scenes,
    mics, paths) -> (scenes, mics, n), the packed inverse of the mixes
    over n.  K4a's two passes with the kernel's strips
    (``fft_real_model``) write each scene's half spectrum, every bin once;
    ``render_spec_rows``: block (b, pm) of packed mic row pm gathers bin q
    <= n/2 of each of its mirror-pair tasks from the spectra of the scenes
    of mic rows 2pm and 2pm + 1 (an odd mic count packs across scenes),
    mixes them (``mic_response``), stores the Hermitian pair, runs the
    inverse row DFTs and the conjugate twiddle (strips of the route's
    rows); ``render_cols`` over the route's column strips (8 at n1 =
    2,048, 4 at 4,096).  ``strips`` (columns, rows) in place of the
    route's runs the same maps at a length the route does not take
    through the spectra.  ``spec`` in place of K4a's model's spectra
    gives the bases' half spectra where K4a's model is held on its own
    (``tests/test_torch_split_long.py`` at 2^25).  Asserts that each strip
    reads only bins q <= n/2, each once a row."""
    scenes = base.shape[0]
    mics, paths = tau.shape[1:]
    if strips is None:
        route = cf.render_route(n)
        assert route.kind == cf.ROUTE_SPECTRA
        strips = route.cols, route.rows
    n1, n2 = cf.fft_real_split(n)
    if spec is None:
        spec, writes = fft_real_model(base, n)
        assert np.array_equal(writes, np.ones_like(writes))
    strip = strips[1]
    nb = n1 // strip
    slot_rows = _slot_rows(n1, strip)
    tasks = _block_tasks(nb, strip, n1, n2)
    q = tasks[5]
    assert np.array_equal(np.bincount(q, minlength=n // 2 + 1),
                          np.ones(n // 2 + 1, int))
    rows = scenes * mics
    packed = (rows + 1) // 2
    tau_r, gain_r = tau.reshape(rows, paths), gain.reshape(rows, paths)
    z = np.full((packed, n1, n2), np.nan, complex)
    for pm in range(packed):
        ra, rb = 2 * pm, 2 * pm + 1
        ya = spec[ra // mics][q] * _mic_response(tau_r[ra], gain_r[ra], q, n)
        yb = np.zeros_like(ya)
        if rb < rows:
            yb = spec[rb // mics][q] * _mic_response(tau_r[rb], gain_r[rb],
                                                     q, n)
        work = np.full((nb, n2, strip), np.nan, complex)
        _store_pairs(work, tasks, ya, yb, n)
        z[pm] = _rows_back(work, slot_rows, n1, n2)
    assert not np.isnan(z).any()
    cols = _cols_back(z, n1, n2, strips[0])
    natural = cols.transpose(0, 2, 1, 3).reshape(packed, n)
    out = np.stack([natural.real, natural.imag], 1).reshape(-1, n)[:rows]
    return out.reshape(scenes, mics, n) / n


@pytest.mark.parametrize("scenes,mics,paths", [(1, 4, 1), (2, 3, 3)])
@pytest.mark.parametrize("bits", [20, 21, 22])
def test_render_spectra_route_matches_delay_sum(bits, scenes, mics, paths):
    """The render's spectra route (K4a's spectra of the bases, the
    one-strip mix row pass on every mirror pair, odd mic counts packed
    across scenes, the inverse columns with 8-wide strips at n1 = 2,048)
    at 2^20, 2^21 and 2^22, one scene of 4 mics and one path and 2 scenes
    of 3 mics and 3 paths, against ``delay_sum_plain``'s transform (no
    finalize, fade 1) within 1e-9 of the max."""
    n = 1 << bits
    rng = np.random.default_rng(bits * 100 + scenes * 10 + mics)
    base, tau, gain = _render_case(rng, scenes, mics, paths, n)
    got = render_spectra_model(base, tau, gain, n)
    t = torch.from_numpy
    want = cf.delay_sum_plain(t(base), t(tau), t(gain), n, n,
                              torch.ones(n, dtype=torch.float64),
                              False).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("scenes,mics,paths", [(1, 4, 1), (2, 3, 3)])
def test_render_spectra_strips_of_four(scenes, mics, paths):
    """The maps of the render's spectra route at 2^23 and 2^24, where
    ``render_spec_rows`` holds strips of 4 rows and ``render_cols`` of 4
    columns, at 65,536 points (256 x 256): against ``delay_sum_plain``'s
    transform within 1e-9 of the max."""
    n = 65536
    rng = np.random.default_rng(scenes * 10 + mics)
    base, tau, gain = _render_case(rng, scenes, mics, paths, n)
    got = render_spectra_model(base, tau, gain, n, strips=(4, 4))
    t = torch.from_numpy
    want = cf.delay_sum_plain(t(base), t(tau), t(gain), n, n,
                              torch.ones(n, dtype=torch.float64),
                              False).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


def finish_spread_model(y, finalize, snr_db, seeds, scene, mic, groups,
                        threads=1024):
    """``finish_spread`` on one scaled, faded, trimmed mic row y over
    ``groups`` blocks of ``threads``: block g takes samples t = g *
    threads + x + k * groups * threads; each step's per-block partials
    (the maxima of |y|, the sums of squares) are combined in block order,
    the maxima as a running maximum and the sums from 0.  Asserts that the
    blocks take every sample once.  -> (row, peak, compressed peak,
    sigma), the last three None where their step does not run."""
    t = np.arange(y.shape[0])
    blocks = [np.flatnonzero((t // threads) % groups == g)
              for g in range(groups)]
    assert np.array_equal(np.sort(np.concatenate(blocks)), t)

    def peak_of(v):
        top = 0.0
        for b in blocks:
            top = max(top, float(np.abs(v[b]).max(initial=0.0)))
        return top

    def squares_of(v):
        total = 0.0
        for b in blocks:
            total += np.sum(v[b] * v[b])
        return total

    peak = cpeak = sigma = None
    if finalize:
        peak = peak_of(y)
        if peak != 0:
            y = y / peak
        comp = np.sign(y) * np.log1p(np.abs(y) / 0.8 + 1e-8)
        cpeak = peak_of(comp)
        y = comp / cpeak if cpeak > 0 else comp
    if snr_db is not None:
        rms = np.sqrt(squares_of(y) / y.shape[0])
        sigma = rms * np.exp(-snr_db[scene] * noise_ops.LN10_OVER_20)
        y = y + sigma * _render_noise(seeds, scene, mic, y.shape[0])
    return y, peak, cpeak, sigma


@pytest.mark.parametrize("groups", [1, 3, 32])
@pytest.mark.parametrize("finalize,noise", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_spread_finish_matches_the_one_block_finish(groups, finalize, noise):
    """The finish spread over 1, 3 and 32 blocks a row (partials combined
    in block order) against the one-block finish (``_finish_model``, as
    ``render_finalize`` and ``render_block`` run it), with the finalize
    and the noise on and off, on a row of 100,003 samples and a silent
    row: peaks and sigma within 1e-12 relative, the rows within 1e-12 of
    their peak; one block equals the one-block finish exactly."""
    rng = np.random.default_rng(groups * 10 + 2 * finalize + noise)
    snr, seeds = _noise_inputs(rng, 2)
    snr, seeds = (snr, seeds) if noise else (None, None)
    for scene, y in enumerate((rng.standard_normal(100_003) * 3e-3,
                               np.zeros(100_003))):
        want = _finish_model(y, finalize, snr, seeds, scene, 1)
        got, peak, cpeak, sigma = finish_spread_model(y, finalize, snr,
                                                      seeds, scene, 1, groups)
        if groups == 1:
            assert np.array_equal(got, want)
        assert np.abs(got - want).max() <= 1e-12 * max(
            np.abs(want).max(), 1e-300)
        if finalize:
            assert abs(peak - np.abs(y).max()) <= 1e-12 * peak
            y = y / peak if peak else y
            comp = np.sign(y) * np.log1p(np.abs(y) / 0.8 + 1e-8)
            assert abs(cpeak - np.abs(comp).max()) <= 1e-12 * cpeak
            y = comp / cpeak if cpeak else comp
        if noise:
            exact = np.sqrt(np.mean(y * y)) * np.exp(
                -snr[scene] * noise_ops.LN10_OVER_20)
            assert abs(sigma - exact) <= 1e-12 * exact
            assert (sigma == 0) == (scene == 1)


def arg_key(v, j):
    """``arg_key``: float32 v (-0 as +0) and index j -> the uint64 whose
    order is v's, then the smallest j."""
    u = np.where(v == 0, np.float32(0), v).astype(np.float32).view(np.uint32)
    top = np.where(u & 0x80000000, ~u, u | np.uint32(0x80000000))
    return (top.astype(np.uint64) << np.uint64(32)) | (
        ~np.asarray(j).astype(np.uint32)).astype(np.uint64)


def arg_unkey(key):
    top = (key >> np.uint64(32)).astype(np.uint32)
    u = np.where(top & 0x80000000, top & np.uint32(0x7FFFFFFF), ~top)
    j = ~(key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return u.astype(np.uint32).view(np.float32), j.astype(np.int64)


def window_stats_model(cols, n1, n2, w, order, strip=S):
    """``window_cols`` on one packed cross row's inverse columns cols (n2
    / strip, n1, strip) times 1/n, its blocks taken in ``order``: each
    block's sum of |corr| (the partials, summed in block order by the last
    block) and its (max, smallest index) as a 64-bit atomic maximum; the
    window j < w or j >= n - w.  -> (win (2, 2w), stats (2, 3)) for the
    real and imaginary parts."""
    n = n1 * n2
    nb = n2 // strip
    j = (np.arange(n1)[:, None] * n2
         + np.arange(nb)[:, None, None] * strip
         + np.arange(strip))                             # (nb, n1, strip)
    win = np.zeros((2, 2 * w))
    stats = np.zeros((2, 3))
    for h, part in enumerate((cols.real / n, cols.imag / n)):
        partials = np.abs(part).sum(axis=(1, 2))
        keys = np.zeros((), np.uint64)
        for b in order:
            at = np.argmax(part[b].ravel())       # ties: smallest slot
            top = part[b].ravel()[at]
            tied = j[b].ravel()[part[b].ravel() == top]
            keys = max(keys, arg_key(np.float32(top), tied.min()))
        m, idx = arg_unkey(np.array(keys))
        stats[h] = partials.sum() / n, m, idx
        at = np.where(j < w, w + j, np.where(j >= n - w, j - (n - w), -1))
        win[h, at[at >= 0]] = part[at >= 0]
    return win, stats


def gcc_rows_model(sig, pairs_i, pairs_j, n, mask, strip=S):
    """K1's and K2's GCC pass 1 and pass 2 on the split: sig (scenes, mics,
    len) -> every (scene, couple c, packed cross row (n1, n2)), with the
    inverse row DFTs and the conjugate twiddle applied.  ``gcc_rows``:
    block (b, scene) holds the strips of packed mic rows first .. first +
    span - 1 (the rows of the scene's mics), and per couple c writes
    packed cross row scene * couples + c."""
    scenes, mics, length = sig.shape
    n1, n2 = cf.fft_real_split(n)
    rows = scenes * mics
    y = _cols_pass(_pack(sig.reshape(rows, length), n), n1, n2)
    slot_rows = _slot_rows(n1, strip)
    nb = n1 // strip
    bufs = block_fft(y[:, slot_rows, :].transpose(0, 1, 3, 2))
    tasks = _block_tasks(nb, strip, n1, n2)
    q = tasks[5]
    pairs = len(pairs_i)
    couples = (pairs + 1) // 2
    for s in range(scenes):
        row0 = s * mics
        first = row0 >> 1
        span = ((row0 + mics - 1) >> 1) - first + 1
        assert span <= (mics + 1) // 2
        spectra = {}
        for r in range(row0, row0 + mics):
            assert first <= r >> 1 < first + span
            zq, zm = _pair_bins(bufs[r >> 1], tasks)
            spectra[r - row0] = _split_bin(zq, zm, r & 1)
        for c in range(couples):
            ya = _whiten(spectra[pairs_i[2 * c]], spectra[pairs_j[2 * c]])
            ya = ya * mask[q]
            yb = np.zeros_like(ya)
            if 2 * c + 1 < pairs:
                yb = _whiten(spectra[pairs_i[2 * c + 1]],
                             spectra[pairs_j[2 * c + 1]]) * mask[q]
            work = np.full((nb, n2, strip), np.nan, complex)
            _store_pairs(work, tasks, ya, yb, n)
            yield s, c, _rows_back(work, slot_rows, n1, n2)


def gcc_split_model(sig, pairs_i, pairs_j, n, wq, mask, strip=S, seed=0):
    """K2's GCC stage on the split: sig (scenes, mics, len) -> (win (scenes,
    P, 2w), stats (scenes, P, 3)): ``gcc_rows_model``, then
    ``window_cols``, which takes its blocks in a shuffled order."""
    scenes = sig.shape[0]
    n1, n2 = cf.fft_real_split(n)
    pairs = len(pairs_i)
    couples = (pairs + 1) // 2
    w = wq * 128
    rng = np.random.default_rng(seed)
    win = np.zeros((scenes, 2 * couples, 2 * w))
    stats = np.zeros((scenes, 2 * couples, 3))
    for s, c, cross in gcc_rows_model(sig, pairs_i, pairs_j, n, mask, strip):
        cols = _cols_back(cross[None], n1, n2)[0]
        order = rng.permutation(n2 // S)
        cw, cs = window_stats_model(cols, n1, n2, w, order)
        win[s, 2 * c:2 * c + 2], stats[s, 2 * c:2 * c + 2] = cw, cs
    return win[:, :pairs], stats[:, :pairs]


def _pairs(m):
    pairs = [(i, j) for i in range(m) for j in range(i + 1, m)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("scenes,mics,n,wq,strip", [
    (3, 3, 8192, 2, 16), (2, 4, 8192, 16, 32), (3, 5, 16384, 4, 16),
    (2, 2, 8192, 32, 16), (1, 4, 65536, 21, 16), (2, 8, 8192, 3, 64)])
def test_gcc_split_matches_gcc_windowed(scenes, mics, n, wq, strip):
    """The GCC stage's index maps (a scene's strips across packed rows,
    odd mic and pair counts, the cross-spectra on every mirror pair, the
    inverse passes, the window) and its statistics combined from block
    partials and keys in any block order, against ``gcc_windowed_plain``:
    the argmax equal, the rest within 1e-9."""
    rng = np.random.default_rng(scenes * 1000 + mics * 10 + wq)
    sig = rng.standard_normal((scenes, mics, n - n // 3))
    pi, pj = _pairs(mics)
    mask = cf.band_mask(n, (300.0, 3400.0), 16000.0,
                        dtype=torch.float64).numpy()
    win, stats = gcc_split_model(sig, pi, pj, n, wq, mask, strip)
    w2, s2 = cf.gcc_windowed_plain(torch.from_numpy(sig), pi, pj, n, wq,
                                   torch.from_numpy(mask))
    w2, s2 = w2.numpy(), s2.numpy()
    assert np.abs(win - w2).max() < 1e-9 * np.abs(w2).max()
    assert np.array_equal(stats[..., 2], s2[..., 2])
    assert np.abs(stats[..., :2] - s2[..., :2]).max() < 1e-6


@pytest.mark.parametrize("n", [8192, 65536])
def test_window_stats_keep_the_smallest_tied_index(n):
    """A planted tie of the maximum in three blocks, the smallest index in
    the last block to run, and a silent row whose zeros carry both signs:
    the keys give the smallest natural index (``torch.argmax``'s first
    occurrence) whatever the order of the blocks."""
    n1, n2 = cf.fft_real_split(n)
    rng = np.random.default_rng(n)
    corr = rng.uniform(-1, 0.5, n).astype(np.float32)
    ties = [n2 * 7 + 3, 17, n - 5]            # blocks 0, 1 and the last
    corr[ties] = 0.75
    zero = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    zero[0] = -0.0
    natural = (corr * n + 1j * zero).astype(complex)
    cols = natural.reshape(n1, n2 // S, S).transpose(1, 0, 2)
    for order in (np.arange(n2 // S), np.arange(n2 // S)[::-1],
                  rng.permutation(n2 // S)):
        _, stats = window_stats_model(cols, n1, n2, 128, order)
        assert stats[0, 2] == 17 == int(torch.argmax(torch.from_numpy(corr)))
        assert stats[0, 1] == np.float32(0.75)
        assert stats[1, 2] == 0 and stats[1, 1] == 0


@pytest.mark.parametrize("n,mics,want", [
    (4096, 4, (1, 1)), (512, 4, (1, 1)), (2048, 24, (1, 1)),
    (2048, 25, (1, 1)), (2048, 26, (1, 1)), (4096, 10, (1, 1)),
    (4096, 11, (1, 1)), (8192, 3, (128, 128)), (65536, 4, (256, 256)),
    (65536, 10, (256, 256)), (65536, 11, (256, 256)),
    (1 << 18, 4, (512, 512)), (1 << 18, 8, (512, 512)),
    (1 << 19, 4, (1024, 1024)), (1 << 20, 2, (1024, 1024)),
    (1 << 22, 4, (2048, 2048)), (1 << 23, 4, (2048, 2048)),
    (1 << 24, 4, (4096, 4096)), (1 << 25, 4, (16384, 16384)),
    (1 << 26, 4, (32768, 32768)), (1 << 27, 4, (65536, 65536)),
    (1 << 28, 3, (131072, 131072))])
def test_scene_stages_rule(n, mics, want):
    """One rule for K3, K2 and K5, read from the two routes (the n1 of
    ``render_route`` and of ``gcc_route``): up to 4,096 one block for the
    render (its twiddles, base row and work row), and for the GCC one
    block a scene where a scene's packed mic rows and a spare row fit,
    else a packed cross row through the mic rows' spectra; the split from
    8,192 to 2^24, the render's with ``render_rows`` where its row pass's
    two strips fit one block's shared memory (to 2^19), else through the
    base rows' spectra, whose row pass holds one strip of
    ``split_strips``, the GCC's with ``gcc_rows`` where its (mics + 1) //
    2 + 1 strips fit, else through the mic rows' spectra; above 2^24 both
    through the spectra on the three-pass split, one route."""
    route = cf.gcc_route(n, mics)
    render = cf.render_route(n)
    got = render.n1, route.n1
    assert got == want
    if n <= cf.FFT_REAL_ONE_BLOCK:
        assert got[0] == 1 and 8 * (n // 2 + 2 * n) <= cf.SMEM_OPTIN
        assert render.kind == cf.ROUTE_BLOCK
        smem = 8 * (n // 2 + ((mics + 1) // 2 + 1) * n)
        assert (smem <= cf.SMEM_OPTIN) == (route.kind == cf.ROUTE_BLOCK)
        return
    n1, n2 = cf.fft_real_split(n)
    assert got[0] == n1
    if n > cf.FFT_SPLIT_MAX:
        assert render == route and render.kind == cf.ROUTE_LONG
        plan = cf.long_plan(n)
        assert (render.cols, render.rows) == (plan.cols_a.strip,
                                              plan.corr_rows.strip)
        return
    two = cf._row_pass_smem(n1, n2, 2) <= cf.SMEM_OPTIN
    assert render.kind == (cf.ROUTE_ROWS if two else cf.ROUTE_SPECTRA)
    if not two:
        assert (render.cols, render.rows) == cf.split_strips(n1, n2)
        assert cf._row_pass_smem(n1, n2, 1, render.rows) <= cf.SMEM_OPTIN
    if route.kind == cf.ROUTE_ROWS:
        assert cf._row_pass_smem(got[1], n // got[1],
                                 (mics + 1) // 2 + 1) <= cf.SMEM_OPTIN


# ---------------------------------------------------------------------------
# K1 and K9: whole correlations on the split and in one block
# ---------------------------------------------------------------------------

def corr_cols_model(cross, n1, n2, strip=S):
    """``corr_cols`` on one packed cross row (n1, n2): the inverse column
    DFTs by strips of ``strip`` columns, times 1/n; slot (j1, s) of strip b
    goes to sample j = n2*j1 + b*strip + s of both rows -> ((2, n) real and
    imaginary parts, the count of writes to each sample)."""
    n = n1 * n2
    cols = _cols_back(cross[None], n1, n2, strip)[0]   # (n2/strip, n1, strip)
    j = (np.arange(n1)[:, None] * n2
         + np.arange(n2 // strip)[:, None, None] * strip + np.arange(strip))
    out = np.full((2, n), np.nan)
    out[0, j.ravel()] = cols.real.ravel() / n
    out[1, j.ravel()] = cols.imag.ravel() / n
    return out, np.bincount(j.ravel(), minlength=n)


def gcc_all_split_model(sig, pairs_i, pairs_j, n, mask, strip=S):
    """K1 on the split: ``gcc_rows_model``, then ``corr_cols`` writing pair
    2c from the real part and 2c + 1 from the imaginary part (none for an
    odd pair count's last couple) -> (scenes, P, n)."""
    scenes = sig.shape[0]
    n1, n2 = cf.fft_real_split(n)
    pairs = len(pairs_i)
    out = np.full((scenes, pairs, n), np.nan)
    for s, c, cross in gcc_rows_model(sig, pairs_i, pairs_j, n, mask, strip):
        rows, writes = corr_cols_model(cross, n1, n2)
        assert np.array_equal(writes, np.ones(n, int))
        for h in range(2):
            if 2 * c + h < pairs:
                assert np.isnan(out[s, 2 * c + h]).all()
                out[s, 2 * c + h] = rows[h]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("scenes,mics,n,strip", [
    (3, 3, 8192, 16), (2, 4, 8192, 32), (3, 5, 16384, 64), (2, 2, 8192, 16),
    (1, 4, 65536, 16), (2, 8, 8192, 64), (1, 3, 1 << 18, 16)])
def test_gcc_all_split_matches_gcc_all_pairs(scenes, mics, n, strip):
    """K1's split (K2's passes 1 and 2, then ``corr_cols``): a scene's
    strips across packed rows, odd mic and pair counts, 8 mics, 65,536
    and 2^18, against ``gcc_all_pairs_plain`` within 1e-9 of the max."""
    rng = np.random.default_rng(scenes * 1000 + mics * 10 + strip)
    sig = rng.standard_normal((scenes, mics, n - n // 3))
    pi, pj = _pairs(mics)
    mask = cf.band_mask(n, (300.0, 3400.0), 16000.0,
                        dtype=torch.float64).numpy()
    got = gcc_all_split_model(sig, pi, pj, n, mask, strip)
    want = cf.gcc_all_pairs_plain(torch.from_numpy(sig), pi, pj, n,
                                  torch.from_numpy(mask)).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


def corr_rows_model(pairs, mask, n, strip=None):
    """``corr_rows`` over packed cross rows, each as its loader gives it:
    ``pairs`` yields the spectra rows (a0, b0, a1, b1) (n/2 + 1,) of each
    packed cross row c, a1 and b1 None without a second pair.  Block (blk,
    c) gathers bin q <= n/2 of the rows for each of its mirror-pair tasks,
    whitens times the band and stores the pair (``store_pair``), then the
    inverse row DFTs and the conjugate twiddle -> yields each packed cross
    row (n1, n2).  ``strip`` rows a block (the kernel's by default,
    ``split_strips``: 16, 8 at n2 = 2,048).  Asserts that each strip reads
    only bins q <= n/2, each once a row."""
    n1, n2 = cf.fft_real_split(n)
    strip = strip or cf.split_strips(n1, n2)[1]
    nb = n1 // strip
    slot_rows = _slot_rows(n1, strip)
    tasks = _block_tasks(nb, strip, n1, n2)
    q = tasks[5]
    assert q.max() <= n // 2
    assert np.array_equal(np.bincount(q, minlength=n // 2 + 1),
                          np.ones(n // 2 + 1, int))
    for a0, b0, a1, b1 in pairs:
        ya = _whiten(a0[q], b0[q]) * mask[q]
        yb = (np.zeros_like(ya) if a1 is None
              else _whiten(a1[q], b1[q]) * mask[q])
        work = np.full((nb, n2, strip), np.nan, complex)
        _store_pairs(work, tasks, ya, yb, n)
        yield _rows_back(work, slot_rows, n1, n2)


def corr_split_model(a, b, mask, n, strip=None, cols=None):
    """K9 on the split: ``corr_rows`` with ``RowPairLoad`` (rows 2c and 2c
    + 1 of a and b; ``strip`` rows a block) and ``corr_cols`` with
    ``cols`` columns a strip (the kernel's by default, ``spectra_plan``:
    16, 8 at n1 = 2,048, 4 at 4,096) -> (rows, n)."""
    rows = a.shape[0]
    n1, n2 = cf.fft_real_split(n)
    cols = cols or cf.spectra_plan(n).spec_cols.strip
    loads = ((a[2 * c], b[2 * c]) + ((a[2 * c + 1], b[2 * c + 1])
                                     if 2 * c + 1 < rows else (None, None))
             for c in range((rows + 1) // 2))
    out = np.full((rows, n), np.nan)
    for c, cross in enumerate(corr_rows_model(loads, mask, n, strip)):
        res, writes = corr_cols_model(cross, n1, n2, cols)
        assert np.array_equal(writes, np.ones(n, int))
        out[2 * c:2 * c + 2] = res[:min(2, rows - 2 * c)]
    return out


def gcc_spectra_cross_model(sig, pairs_i, pairs_j, n, mask):
    """The spectra route's first three launches (``spectra_cross``): sig
    (scenes, mics, len) -> K4a's two passes (``fft_real_model``) into the
    spectra of rows scene * mics + mic, each bin written once; ``corr_rows``
    with ``PairIndexLoad`` (packed cross row scene * couples + c reads rows
    scene * mics + pairs_i[p] and + pairs_j[p] for p = 2c, 2c + 1) ->
    yields (scene, c, packed cross row (n1, n2))."""
    scenes, mics, length = sig.shape
    spec, writes = fft_real_model(sig.reshape(scenes * mics, length), n)
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

    crosses = corr_rows_model(map(load, range(scenes * couples)), mask, n)
    for rc, cross in enumerate(crosses):
        yield divmod(rc, couples) + (cross,)


def gcc_spectra_model(sig, pairs_i, pairs_j, n, mask):
    """K1 on the spectra route (``spectra_cross`` then ``corr_cols``):
    ``gcc_spectra_cross_model``, then ``corr_cols`` writing pair 2c from
    the real part and 2c + 1 from the imaginary part (none for an odd pair
    count's last couple) -> (scenes, P, n)."""
    scenes = sig.shape[0]
    n1, n2 = cf.fft_real_split(n)
    pairs = len(pairs_i)
    cols = cf.split_strips(n1, n2)[0]
    out = np.full((scenes, pairs, n), np.nan)
    for scene, c, cross in gcc_spectra_cross_model(sig, pairs_i, pairs_j, n,
                                                   mask):
        rows, writes = corr_cols_model(cross, n1, n2, cols)
        assert np.array_equal(writes, np.ones(n, int))
        for h in range(2):
            if 2 * c + h < pairs:
                assert np.isnan(out[scene, 2 * c + h]).all()
                out[scene, 2 * c + h] = rows[h]
    assert not np.isnan(out).any()
    return out


def gcc_spectra_window_model(sig, pairs_i, pairs_j, n, wq, mask, seed=0,
                             cols=None):
    """K2's (and K5's) GCC stage on the spectra route: the same three
    launches, then ``window_cols`` over strips of ``cols`` columns (the
    route's by default: 16, 8 at n1 = 2,048, 4 at 4,096), its blocks in a
    shuffled order -> (win (scenes, P, 2w), stats (scenes, P, 3))."""
    scenes = sig.shape[0]
    n1, n2 = cf.fft_real_split(n)
    cols = cols or cf.spectra_plan(n).spec_cols.strip
    pairs = len(pairs_i)
    couples = (pairs + 1) // 2
    w = wq * 128
    rng = np.random.default_rng(seed)
    win = np.zeros((scenes, 2 * couples, 2 * w))
    stats = np.zeros((scenes, 2 * couples, 3))
    for scene, c, cross in gcc_spectra_cross_model(sig, pairs_i, pairs_j, n,
                                                   mask):
        back = _cols_back(cross[None], n1, n2, cols)[0]
        order = rng.permutation(n2 // cols)
        cw, cst = window_stats_model(back, n1, n2, w, order, cols)
        win[scene, 2 * c:2 * c + 2] = cw
        stats[scene, 2 * c:2 * c + 2] = cst
    return win[:, :pairs], stats[:, :pairs]


def spectra_block_model(sig, pairs_i, pairs_j, n, mask):
    """The spectra block route (n <= 4,096): ``fft_real_block`` over the
    mic rows (``fft_real_model``) into their spectra, then ``corr_block``
    with ``PairIndexLoad``: block rc = scene * couples + c packs the
    whitened, band-masked cross-spectra of pairs 2c and 2c + 1 of the
    scene from bins 0..n/2 (``store_packed``) and inverts -> yields
    (scene, c, the unscaled packed inverse (n,)) for the epilogue."""
    scenes, mics, length = sig.shape
    assert cf.fft_real_split(n)[0] == 1
    spec, writes = fft_real_model(sig.reshape(scenes * mics, length), n)
    assert np.array_equal(writes, np.ones_like(writes))
    pairs = len(pairs_i)
    for rc in range(scenes * ((pairs + 1) // 2)):
        scene, c = divmod(rc, (pairs + 1) // 2)
        m0 = scene * mics
        ya = _whiten(spec[m0 + pairs_i[2 * c]], spec[m0 + pairs_j[2 * c]])
        yb = np.zeros_like(ya)
        if 2 * c + 1 < pairs:
            yb = _whiten(spec[m0 + pairs_i[2 * c + 1]],
                         spec[m0 + pairs_j[2 * c + 1]])
        work = _store_packed(ya * mask, yb * mask, n)
        yield scene, c, block_fft(work[:, None], -1.0)[:, 0]


def _spectra(rng, rows, n):
    """Random complex (rows, n/2 + 1) spectra, imaginary parts at DC and
    Nyquist too (the kernels drop them after whitening, as the twin)."""
    shape = (rows, n // 2 + 1)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("n", [8192, 65536, 131072])
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_corr_split_matches_whitened_corr(rows, n):
    """K9's gather of natural-order bins by the row pass's tasks, its
    Hermitian packing of two row pairs and ``corr_cols``' write, against
    ``whitened_corr_plain`` within 1e-9 of the max (a band at 131,072)."""
    rng = np.random.default_rng(rows * 7 + n)
    a, b = _spectra(rng, rows, n), _spectra(rng, rows, n)
    band = (300.0, 3400.0) if n == 131072 else None
    mask = cf.band_mask(n, band, 16000.0, dtype=torch.float64).numpy()
    got = corr_split_model(a, b, mask, n)
    t = torch.from_numpy
    want = cf.whitened_corr_plain(t(a), t(b), t(mask), n).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("bits,rows", [(21, 3), (22, 1)])
def test_corr_split_above_2_20(bits, rows):
    """K9 on the split to 2^22: at 2^21 (2,048 x 1,024) row strips of 16
    and column strips of 8, at 2^22 (2,048 x 2,048) 8 and 8, against
    ``whitened_corr_plain`` within 1e-9 of the max, every bin written
    once (``corr_cols_model``)."""
    n = 1 << bits
    n1, n2 = cf.fft_real_split(n)
    assert cf.corr_schedule(n) == n1 == 2048
    assert cf.split_strips(n1, n2) == ((8, 16) if bits == 21 else (8, 8))
    rng = np.random.default_rng(bits * 10 + rows)
    a, b = _spectra(rng, rows, n), _spectra(rng, rows, n)
    mask = cf.band_mask(n, (300.0, 3400.0), 44100.0,
                        dtype=torch.float64).numpy()
    got = corr_split_model(a, b, mask, n)
    t = torch.from_numpy
    want = cf.whitened_corr_plain(t(a), t(b), t(mask), n).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("n", [8192, 65536])
@pytest.mark.parametrize("rows", [1, 3])
def test_corr_split_strips_of_four(rows, n):
    """The maps of K9's split at 2^23 and 2^24, where ``corr_rows`` holds
    strips of 4 rows (one row k1 and its partner n1 - k1 a pair of slots;
    block 0 row 0 and row n1/2) and ``corr_cols`` strips of 4 columns, run
    at lengths whose arrays the CPU holds at once: against
    ``whitened_corr_plain`` within 1e-9 of the max, every sample written
    once."""
    rng = np.random.default_rng(rows * 11 + n)
    a, b = _spectra(rng, rows, n), _spectra(rng, rows, n)
    mask = cf.band_mask(n, (300.0, 3400.0), 16000.0,
                        dtype=torch.float64).numpy()
    got = corr_split_model(a, b, mask, n, strip=4, cols=4)
    t = torch.from_numpy
    want = cf.whitened_corr_plain(t(a), t(b), t(mask), n).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("bits", range(13, 25))
def test_spectra_plan_rule(bits):
    """``spectra_plan`` at every length of the split, 8,192 to 2^24, for
    1, 2 and 64 packed rows: K4a's two passes as ``split_plan`` gives
    them, the row pass (``corr_rows``, ``render_spec_rows``) one strip of
    ``split_strips``' rows at the stride ``row_ld`` beside the n1- and
    n2-point tables, the column pass (``corr_cols``, ``window_cols``,
    ``render_cols``) ``split_strips``' columns beside the n1/2
    sub-twiddles; each block at most ``BLOCK_POINTS`` points in at most
    ``SMEM_OPTIN`` bytes (``window_cols`` with its 257 static bytes);
    the routes of K1, K2, K3, K5 and K9 take its strips, and up to 2^20
    the row strip keeps the stride n2 + 1."""
    n = 1 << bits
    n1, n2 = cf.fft_real_split(n)
    cs, rs = cf.split_strips(n1, n2)
    for packed in (1, 2, 64):
        plan = cf.spectra_plan(n, packed)
        split = cf.split_plan(n, packed)
        assert (plan.cols, plan.rows) == (split.cols, split.rows)
        assert plan.spec_rows == (rs, 8 * (n2 // 2 + n1 + n2
                                           + rs * cf.row_ld(rs, n2)))
        assert plan.spec_cols == (cs, 8 * (n1 // 2 + n1 * cs))
        for step, length in ((plan.cols, n1), (plan.rows, n2),
                             (plan.spec_rows, n2), (plan.spec_cols, n1)):
            assert step.strip * length <= cf.BLOCK_POINTS
            assert step.smem <= cf.SMEM_OPTIN
        assert plan.spec_cols.smem + 257 <= cf.SMEM_OPTIN
        assert cf._spectra_strips(n, packed) == (cs, plan.rows.strip, rs)
    if n <= cf.STAGE_SPLIT_MAX:
        assert cf.row_ld(rs, n2) == n2 + 1
    for route in (cf.gcc_route(n, 128), cf.render_route(n)):
        if route.kind == cf.ROUTE_SPECTRA:
            assert (route.n1, route.cols, route.rows) == (n1, cs, rs)
    assert cf.corr_schedule(n) == n1


@pytest.mark.parametrize("bits,scenes,mics", [(21, 1, 4), (21, 2, 3),
                                              (22, 1, 4)])
def test_gcc_spectra_route_matches_gcc_all_pairs(bits, scenes, mics):
    """K1 above 2^20 (``gcc_all_spectra``): K4a's passes into the mic rows'
    spectra, K9's row pass reading pairs of them by index, the column
    pass.  1 x 4 mics and 2 scenes x 3 mics at 2^21 (an odd pair count,
    rows packed across scenes in K4a's passes), 4 mics at 2^22, against
    ``gcc_all_pairs_plain`` within 1e-9 of the max; every spectrum bin and
    correlation sample written once."""
    n = 1 << bits
    assert cf.gcc_route(n, mics).n1 == 2048
    rng = np.random.default_rng(bits * 100 + scenes * 10 + mics)
    sig = rng.standard_normal((scenes, mics, n // 2 + 3000))
    pi, pj = _pairs(mics)
    mask = cf.band_mask(n, (300.0, 3400.0), 44100.0,
                        dtype=torch.float64).numpy()
    got = gcc_spectra_model(sig, pi, pj, n, mask)
    want = cf.gcc_all_pairs_plain(torch.from_numpy(sig), pi, pj, n,
                                  torch.from_numpy(mask)).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("scenes,mics,n,wq,cols", [
    (2, 5, 8192, 2, None), (1, 6, 1 << 18, 16, None),
    (1, 3, 1 << 21, 32, None), (2, 3, 65536, 4, 4)])
def test_gcc_spectra_window_matches_gcc_windowed(scenes, mics, n, wq, cols):
    """K2's and K5's GCC stage through the mic rows' spectra: K4a's two
    passes, the pair-indexed row pass, ``window_cols`` over the route's
    column strips (16 at 8,192 and 2^18, 8 at 2^21) with its blocks in any
    order, at 2 scenes of 5 mics (rows packed across scenes, an even pair
    count), 6 mics at 2^18 (past ``gcc_rows``' 4), 3 mics at 2^21 (an odd
    pair count) and 2 scenes of 3 mics at 65,536 with 2^24's column strips
    of 4 (64 blocks a row of partials), against ``gcc_windowed_plain``:
    the window within 1e-9 of the max, the argmax equal, the rest within
    1e-6."""
    route = cf.gcc_route(n, mics)
    assert route.kind in (cf.ROUTE_SPECTRA, cf.ROUTE_ROWS)
    rng = np.random.default_rng(scenes * 1000 + mics * 10 + wq)
    sig = rng.standard_normal((scenes, mics, n - n // 3))
    pi, pj = _pairs(mics)
    mask = cf.band_mask(n, (300.0, 3400.0), 16000.0,
                        dtype=torch.float64).numpy()
    win, stats = gcc_spectra_window_model(sig, pi, pj, n, wq, mask,
                                          cols=cols)
    w2, s2 = cf.gcc_windowed_plain(torch.from_numpy(sig), pi, pj, n, wq,
                                   torch.from_numpy(mask))
    w2, s2 = w2.numpy(), s2.numpy()
    assert np.abs(win - w2).max() < 1e-9 * np.abs(w2).max()
    assert np.array_equal(stats[..., 2], s2[..., 2])
    assert np.abs(stats[..., :2] - s2[..., :2]).max() < 1e-6


@pytest.mark.parametrize("scenes,mics,n", [(2, 11, 4096), (1, 25, 2048),
                                           (3, 5, 1024)])
def test_spectra_block_matches_gcc_all_pairs_and_windowed(scenes, mics, n):
    """The spectra block route at n <= 4,096: K4a's one-block transform
    into the spectra, then a block a packed cross row by pair index, with
    K1's epilogue (``CorrOut``, against ``gcc_all_pairs_plain`` within
    1e-9 of the max) and K2's (``WindowOut``'s window and block
    reductions at ``block_threads(n)``, against ``gcc_windowed_plain``:
    the argmax equal); 11 mics at 4,096 and 25 at 2,048 (one past the
    one-block limit) and 3 scenes of 5 mics (rows packed across scenes)."""
    rng = np.random.default_rng(scenes * 100 + mics + n)
    sig = rng.standard_normal((scenes, mics, n - n // 5))
    pi, pj = _pairs(mics)
    pairs = len(pi)
    mask = cf.band_mask(n, (300.0, 3400.0), 16000.0,
                        dtype=torch.float64).numpy()
    wq = n // 512
    w = wq * 128
    t = np.arange(n)
    at = np.where(t < w, w + t, np.where(t >= n - w, t - (n - w), -1))
    corr = np.full((scenes, pairs, n), np.nan)
    win = np.full((scenes, pairs, 2 * w), np.nan)
    stats = np.full((scenes, pairs, 3), np.nan)
    for scene, c, inv in spectra_block_model(sig, pi, pj, n, mask):
        for h, row in enumerate((inv.real / n, inv.imag / n)):
            p = 2 * c + h
            if p < pairs:
                corr[scene, p] = row
                win[scene, p, at[at >= 0]] = row[at >= 0]
                total, top, arg = block_reduce_model(row, block_threads(n))
                stats[scene, p] = total / n, top, arg
    t64 = torch.from_numpy
    want = cf.gcc_all_pairs_plain(t64(sig), pi, pj, n, t64(mask)).numpy()
    assert np.abs(corr - want).max() < 1e-9 * np.abs(want).max()
    w2, s2 = cf.gcc_windowed_plain(t64(sig), pi, pj, n, wq, t64(mask))
    w2, s2 = w2.numpy(), s2.numpy()
    assert np.abs(win - w2).max() < 1e-9 * np.abs(w2).max()
    assert np.array_equal(stats[..., 2], s2[..., 2])
    assert np.abs(stats[..., :2] - s2[..., :2]).max() < 1e-9


def test_port_matches_jax_package_at_2_21():
    """The port's K1 and K9 wrappers at 2^21 on the CPU (their plain twins,
    the functions the card's kernels are held to) against the JAX
    package's ``gcc_phat_all_pairs`` (ops/gccphat.py:123) and
    ``phat_correlation`` (:98) on the same float64 rows, within 1e-9 of
    the max: 4 mics of a 23.7 s recording's length at 44.1 kHz with the
    band, and one pair through K4a's spectra and K9."""
    import jax.numpy as jnp

    from pyaudiolocalization_tpu.ops import gccphat as jgcc
    from pyaudiolocalization_tpu_torch.ops import gccphat as tgcc
    n = 1 << 21
    rng = np.random.default_rng(2021)
    sig = rng.standard_normal((4, 1_046_019))
    pi, pj = _pairs(4)
    band = (300.0, 3400.0)
    want = np.asarray(jgcc.gcc_phat_all_pairs(
        jnp.asarray(sig), np.asarray(pi), np.asarray(pj), nfft=n, band=band,
        fs=44100.0))
    got = tgcc.gcc_phat_all_pairs(torch.from_numpy(sig), pi, pj, nfft=n,
                                  band=band, fs=44100.0).numpy()
    assert got.shape == want.shape == (6, n)
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
    want = np.asarray(jgcc.phat_correlation(jnp.asarray(sig[0]),
                                            jnp.asarray(sig[1]), nfft=n))
    spec = cf.fft_real(torch.from_numpy(sig[:2]), n)
    mask = cf.band_mask(n, None, None, dtype=torch.float64)
    got = cf.whitened_corr(spec[:1], spec[1:], mask, n)[0].numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


def test_render_scene_matches_jax_package_at_2_21():
    """The port's ``models/simulator.render_scene`` (``pad_mode='pow2'``,
    on the CPU in float64: ``delay_sum``'s twin, which the card's spectra
    route is held to) at total_samples 1,600,000 -> 2^21, 4 mics x 3 paths,
    against the JAX package's ``render_scene`` on the same numpy inputs:
    raw renders within 1e-9 of the max, finalized ones within 1e-11 of the
    max (``test_simulate_signals_matches_jax``'s tolerance for finalized
    renders)."""
    import jax.numpy as jnp

    from pyaudiolocalization_tpu.models import simulator as jsim
    from pyaudiolocalization_tpu_torch.models import simulator as tsim
    fs, total, out = 44100.0, 1_600_000, 1_550_000
    rng = np.random.default_rng(2121)
    base = rng.standard_normal(1_500_000)
    delays = rng.uniform(0.0, 0.05, (4, 3))
    gains = rng.uniform(0.1, 1.0, (4, 3))
    for finalize, tol in ((False, 1e-9), (True, 1e-11)):
        want = np.asarray(jsim.render_scene(
            jnp.asarray(base), jnp.asarray(delays), jnp.asarray(gains), fs,
            total, out, pad_mode="pow2", finalize=finalize))
        got = tsim.render_scene(
            torch.from_numpy(base), torch.from_numpy(delays),
            torch.from_numpy(gains), fs, total, out, pad_mode="pow2",
            finalize=finalize).numpy()
        assert got.shape == want.shape == (4, out)
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _store_packed(ya, yb, n):
    """``store_packed`` of bins q = 0..n/2 into a fresh row: bin q holds ya
    + i*yb, bin n - q their conjugates' pair, imaginary parts dropped at DC
    and Nyquist; asserts that every bin is written once."""
    q = np.arange(n // 2 + 1)
    edge = (q == 0) | (q == n // 2)
    ya, yb = np.where(edge, ya.real, ya), np.where(edge, yb.real, yb)
    row = np.full(n, np.nan, complex)
    row[q] = ya + 1j * yb
    m = n - q[~edge]
    row[m] = np.conj(ya[~edge]) + 1j * np.conj(yb[~edge])
    assert np.array_equal(np.bincount(np.concatenate([q, m]), minlength=n),
                          np.ones(n, int))
    return row


def gcc_body_model(z, scenes, mics, pairs_i, pairs_j, n, mask, groups=1):
    """``gcc_body`` over packed rows z (ceil(scenes * mics / 2), n) as its
    loader gives them: block (scene, g) transforms the packed rows first
    .. first + span - 1 (rows packed across scenes), then for couples c =
    g, g + groups, ... forms the cross-spectra from bins q and (n - q) mod
    n (``split_bin``), packs them (``store_packed``) and inverts -> yields
    (scene, c, the unscaled packed inverse (n,)) for the epilogue.  Asserts
    that every couple is done by one group."""
    pairs = len(pairs_i)
    couples = (pairs + 1) // 2
    q = np.arange(n // 2 + 1)
    m = (n - q) & (n - 1)
    done = np.zeros((scenes, couples), int)
    for s in range(scenes):
        row0 = s * mics
        first = row0 >> 1
        span = ((row0 + mics - 1) >> 1) - first + 1
        assert span <= (mics + 1) // 2
        spec = block_fft(z[first:first + span, :, None])[..., 0]

        def bins(mic):
            r = row0 + mic
            zr = spec[(r >> 1) - first]
            return _split_bin(zr[q], zr[m], r & 1)

        for g in range(groups):
            for c in range(g, couples, groups):
                done[s, c] += 1
                ya = _whiten(bins(pairs_i[2 * c]), bins(pairs_j[2 * c]))
                yb = np.zeros_like(ya)
                if 2 * c + 1 < pairs:
                    yb = _whiten(bins(pairs_i[2 * c + 1]),
                                 bins(pairs_j[2 * c + 1]))
                work = _store_packed(ya * mask, yb * mask, n)
                yield s, c, block_fft(work[:, None], -1.0)[:, 0]
    assert np.array_equal(done, np.ones_like(done))


def gcc_block_model(sig, pairs_i, pairs_j, n, mask, groups=1):
    """``gcc_block``: ``gcc_body`` over the rows of sig (scenes, mics, len)
    packed as ``RowLoad`` gives them, with ``CorrOut``: pairs 2c and 2c + 1
    times 1/n -> (scenes, P, n)."""
    scenes, mics, length = sig.shape
    z = _pack(sig.reshape(scenes * mics, length), n)
    pairs = len(pairs_i)
    out = np.full((scenes, pairs, n), np.nan)
    for s, c, inv in gcc_body_model(z, scenes, mics, pairs_i, pairs_j, n,
                                    mask, groups):
        out[s, 2 * c] = inv.real / n
        if 2 * c + 1 < pairs:
            out[s, 2 * c + 1] = inv.imag / n
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("scenes,mics,n,groups", [
    (3, 3, 128, 1), (2, 4, 256, 2), (3, 5, 1024, 3), (4, 2, 512, 1),
    (2, 8, 4096, 2), (3, 7, 2048, 4), (5, 10, 4096, 1)])
def test_gcc_block_matches_gcc_all_pairs(scenes, mics, n, groups):
    """K1 in one block: a scene's packed rows (odd mic counts packed
    across scenes), odd pair counts, couples shared over groups, 8 and 10
    mics at 4,096, against ``gcc_all_pairs_plain`` within 1e-9 of the
    max."""
    rng = np.random.default_rng(scenes * 100 + mics + n)
    sig = rng.standard_normal((scenes, mics, n - n // 5))
    pi, pj = _pairs(mics)
    mask = cf.band_mask(n, (300.0, 3400.0), 16000.0,
                        dtype=torch.float64).numpy()
    got = gcc_block_model(sig, pi, pj, n, mask, groups)
    want = cf.gcc_all_pairs_plain(torch.from_numpy(sig), pi, pj, n,
                                  torch.from_numpy(mask)).numpy()
    assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


def corr_block_model(a, b, mask, n):
    """``corr_block``: block c packs whiten(a * conj(b)) * band of rows 2c
    and 2c + 1 (``store_packed``), inverts and writes both rows times 1/n
    -> (rows, n)."""
    rows = a.shape[0]
    out = np.full((rows, n), np.nan)
    for c in range((rows + 1) // 2):
        ya = _whiten(a[2 * c], b[2 * c]) * mask
        yb = (_whiten(a[2 * c + 1], b[2 * c + 1]) * mask
              if 2 * c + 1 < rows else np.zeros_like(ya))
        inv = block_fft(_store_packed(ya, yb, n)[:, None], -1.0)[:, 0] / n
        out[2 * c] = inv.real
        if 2 * c + 1 < rows:
            out[2 * c + 1] = inv.imag
    return out


@pytest.mark.parametrize("n", [128, 256, 512, 1024, 2048, 4096])
def test_corr_block_matches_whitened_corr(n):
    """K9 in one block at 1, 2 and 3 rows against ``whitened_corr_plain``
    within 1e-9 of the max."""
    rng = np.random.default_rng(n)
    mask = cf.band_mask(n, (300.0, 3400.0), 16000.0,
                        dtype=torch.float64).numpy()
    for rows in (1, 2, 3):
        a, b = _spectra(rng, rows, n), _spectra(rng, rows, n)
        got = corr_block_model(a, b, mask, n)
        t = torch.from_numpy
        want = cf.whitened_corr_plain(t(a), t(b), t(mask), n).numpy()
        assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("n,mics,want", [
    (4, 2, 1), (128, 4, 1), (4096, 4, 1), (4096, 8, 1), (4096, 10, 1),
    (4096, 11, 1), (2048, 24, 1), (2048, 26, 1), (8192, 3, 128),
    (65536, 4, 256), (65536, 10, 256), (65536, 11, 256), (1 << 18, 8, 512),
    (1 << 19, 4, 1024), (1 << 20, 2, 1024), (1 << 21, 4, 2048),
    (1 << 21, 64, 2048), (1 << 22, 4, 2048), (1 << 23, 4, 2048),
    (1 << 24, 4, 4096), (1 << 24, 128, 4096), (1 << 25, 4, 16384),
    (1 << 25, 128, 16384), (1 << 26, 4, 32768), (1 << 27, 4, 65536),
    (1 << 30, 7, 524288)])
def test_gcc_schedule_rule(n, mics, want):
    """K1's schedule (``gcc_route``'s n1) is K2's GCC stage's and K5's,
    one rule: one block up to 4,096 (a scene where the twiddles, a scene's
    widest span of packed rows and a spare row fit one block's shared
    memory, else a packed cross row through the spectra); the split from
    8,192 to 2^24 (``gcc_rows`` or the spectra, which hold one strip at
    any mic count); the three-pass split through the spectra above, to
    2^30."""
    route = cf.gcc_route(n, mics)
    got = route.n1
    assert got == want
    assert (route.kind == cf.ROUTE_LONG) == (n > cf.FFT_SPLIT_MAX)
    if 1 < got:
        assert got == cf._split_n1(n)
    if n <= cf.FFT_REAL_ONE_BLOCK:
        smem = 8 * (n // 2 + ((mics + 1) // 2 + 1) * n)
        assert (smem <= cf.SMEM_OPTIN) == (route.kind == cf.ROUTE_BLOCK)


@pytest.mark.parametrize("n,want", [
    (4, 1), (128, 1), (4096, 1), (8192, 128), (65536, 256), (131072, 512),
    (1 << 20, 1024), (1 << 21, 2048), (1 << 22, 2048), (1 << 23, 2048),
    (1 << 24, 4096), (1 << 25, 16384), (1 << 26, 32768), (1 << 27, 65536),
    (1 << 30, 524288)])
def test_corr_schedule_rule(n, want):
    """K9's schedule (``corr_schedule``): one block up to 4,096, K4a's
    split up to 2^24 (its row pass's one strip of ``spectra_plan`` fits at
    every split: 16 rows, 8 at n2 = 2,048, 4 at 4,096), the three-pass
    split above, as K4a's (``corr_rows_long`` in strips of 2 rows of 2,048
    without an n1- or n2-point table)."""
    assert cf.corr_schedule(n) == want
    if n > cf.FFT_SPLIT_MAX:
        plan = cf.long_plan(n)
        assert plan.corr_rows.strip == 2 and n // want == 2048
        assert plan.corr_rows.smem == 8 * (1024 + 2 * cf.row_ld(2, 2048))
        assert plan.corr_rows.smem <= cf.SMEM_OPTIN
    elif 1 < want:
        plan = cf.spectra_plan(n)
        rows = plan.spec_rows.strip
        n2 = n // want
        assert rows == cf.split_strips(want, n2)[1]
        assert cf._row_pass_smem(want, n2, 1, rows) <= cf.SMEM_OPTIN
        assert plan.spec_rows.smem <= cf.SMEM_OPTIN


# ---------------------------------------------------------------------------
# K3, K2 and K5 in one block (nfft <= 4,096): render_block, window_block
# ---------------------------------------------------------------------------

def block_threads(n):
    """``block_threads``: what block_fft needs at n (n / 16), at least two
    warps."""
    return max(64, -(-n // 16))


def _render_noise(seeds, scene, mic, count):
    """The Philox normals ``finish_rows`` adds to mic row (scene, mic):
    key (seed word 0, seed word 1 + mic * 0x9E3779B9 mod 2^32) of the
    scene's int32 words read as uint32, counter t < count, the first two
    output words' top 24 bits through the Box-Muller (float32)."""
    key = seeds.astype(np.int64) & 0xFFFFFFFF
    k0 = torch.tensor([int(key[scene, 0])])
    k1 = torch.tensor([(int(key[scene, 1]) + mic * noise_ops.PHILOX_W0)
                       & 0xFFFFFFFF])
    w0, w1 = noise_ops.philox_bits(k0, k1, torch.arange(count))
    return noise_ops.bits_to_normal(w0 >> 8, w1 >> 8).double().numpy()


def _finish_model(y, finalize, snr_db, seeds, scene, mic):
    """``finish_rows`` on one scaled, faded, trimmed mic row."""
    if finalize:
        peak = np.abs(y).max()
        if peak != 0:
            y = y / peak
        comp = np.sign(y) * np.log1p(np.abs(y) / 0.8 + 1e-8)
        cpeak = np.abs(comp).max()
        y = comp / cpeak if cpeak > 0 else comp
    if snr_db is not None:
        rms = np.sqrt(np.sum(y * y) / y.shape[0])
        sigma = rms * np.exp(-snr_db[scene] * noise_ops.LN10_OVER_20)
        y = y + sigma * _render_noise(seeds, scene, mic, y.shape[0])
    return y


def render_block_model(base, tau, gain, n, out_len, fade, finalize,
                       snr_db=None, seeds=None, groups=1):
    """``render_block``: block (cb, g) transforms the packed base row cb
    (scenes 2cb and 2cb + 1), then for packed mic rows pm = cb * mics + g,
    + groups, ... < (cb + 1) * mics mixes mic rows 2pm and 2pm + 1 from
    their scenes' halves of that spectrum (``split_bin``, ``mic_response``),
    packs them (``store_packed``), inverts, and finishes each half (1/n,
    fade, trim, ``finish_rows``) -> (out (scenes, mics, out_len), packed
    (ceil(rows / 2), n): the rows as K5 writes them, zero-padded).  Asserts
    that each packed mic row is done once, by the block of its scenes."""
    scenes = base.shape[0]
    mics, paths = tau.shape[1:]
    rows = scenes * mics
    num_packed = (rows + 1) // 2
    zb = _pack(base, n)
    tau_r, gain_r = tau.reshape(rows, paths), gain.reshape(rows, paths)
    q = np.arange(n // 2 + 1)
    m = (n - q) & (n - 1)
    out = np.full((rows, out_len), np.nan)
    packed = np.full((num_packed, n), np.nan, complex)
    done = np.zeros(num_packed, int)
    for cb in range(zb.shape[0]):
        spec = block_fft(zb[cb][:, None])[:, 0]
        last = min((cb + 1) * mics, num_packed)
        for g in range(groups):
            for pm in range(cb * mics + g, last, groups):
                done[pm] += 1
                ra, rb = 2 * pm, 2 * pm + 1
                assert ra // mics >> 1 == cb
                assert rb >= rows or rb // mics >> 1 == cb
                ya = _split_bin(spec[q], spec[m], (ra // mics) & 1) * \
                    _mic_response(tau_r[ra], gain_r[ra], q, n)
                yb = np.zeros_like(ya)
                if rb < rows:
                    yb = _split_bin(spec[q], spec[m], (rb // mics) & 1) * \
                        _mic_response(tau_r[rb], gain_r[rb], q, n)
                inv = block_fft(_store_packed(ya, yb, n)[:, None], -1.0)[:, 0]
                for h, r in enumerate(range(ra, min(rb + 1, rows))):
                    scene, mic = divmod(r, mics)
                    y = (inv.imag if h else inv.real)[:out_len] / n * fade
                    out[r] = _finish_model(y, finalize, snr_db, seeds, scene,
                                           mic)
                row = np.zeros(n, complex)
                row[:out_len] = out[ra] + (1j * out[rb] if rb < rows else 0)
                packed[pm] = row
    assert np.array_equal(done, np.ones_like(done))
    assert not np.isnan(out).any()
    return out.reshape(scenes, mics, out_len), packed


def _warp_tree(v, idx=None):
    """``block_sum``'s (idx None) or ``block_argmax``'s shuffle tree over
    the 32 lanes of v: lane l takes lane l ^ off's value at off = 16, 8,
    4, 2, 1 -> lane 0's result."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        ov = v[lanes ^ off]
        if idx is None:
            v = v + ov
            continue
        oi = idx[lanes ^ off]
        take = (ov > v) | ((ov == v) & (oi < idx))
        v, idx = np.where(take, ov, v), np.where(take, oi, idx)
    return v[0] if idx is None else (v[0], idx[0])


def block_reduce_model(x, threads):
    """``WindowOut``'s reductions of one row x (n,): each thread's serial
    sum of |x| and (max, smallest index) over t = thread + k * threads
    (-0 taken as +0), then each warp's shuffle tree and warp 0's over the
    warps' results -> (sum, max, index)."""
    big = np.iinfo(np.int64).max
    sums = np.zeros(threads)
    best = np.full(threads, -np.inf)
    idx = np.full(threads, big)
    for k in range(-(-x.shape[0] // threads)):
        j = np.arange(k * threads, min((k + 1) * threads, x.shape[0]))
        tid = j - k * threads
        v = np.where(x[j] == 0, 0.0, x[j])
        sums[tid] += np.abs(x[j])
        take = (v > best[tid]) | ((v == best[tid]) & (j < idx[tid]))
        best[tid] = np.where(take, v, best[tid])
        idx[tid] = np.where(take, j, idx[tid])
    warps = threads // 32
    ws = np.zeros(32)
    wv = np.full(32, -np.inf)
    wi = np.full(32, big)
    for w in range(warps):
        lanes = slice(32 * w, 32 * w + 32)
        ws[w] = _warp_tree(sums[lanes])
        wv[w], wi[w] = _warp_tree(best[lanes], idx[lanes])
    top, at = _warp_tree(wv, wi)
    return _warp_tree(ws), top, at


def window_block_model(z, scenes, mics, pairs_i, pairs_j, n, wq, mask,
                       groups=1):
    """``window_block``: ``gcc_body`` over the packed rows z (K2's rows as
    ``RowLoad`` packs them, or K5's as ``render_block`` writes them), with
    ``WindowOut``: each correlation times 1/n, its lags [-w, w) and its
    statistics by ``block_reduce_model`` at ``block_threads(n)`` threads
    -> (win (scenes, P, 2w), stats (scenes, P, 3))."""
    pairs = len(pairs_i)
    w = wq * 128
    t = np.arange(n)
    at = np.where(t < w, w + t, np.where(t >= n - w, t - (n - w), -1))
    win = np.full((scenes, pairs, 2 * w), np.nan)
    stats = np.full((scenes, pairs, 3), np.nan)
    for s, c, inv in gcc_body_model(z, scenes, mics, pairs_i, pairs_j, n,
                                    mask, groups):
        for h, corr in enumerate((inv.real / n, inv.imag / n)):
            p = 2 * c + h
            if p < pairs:
                win[s, p, at[at >= 0]] = corr[at >= 0]
                total, top, arg = block_reduce_model(corr, block_threads(n))
                stats[s, p] = total / n, top, arg
    assert not np.isnan(win).any() and not np.isnan(stats).any()
    return win, stats


def _noise_inputs(rng, scenes):
    snr = rng.uniform(20.0, 40.0, scenes)
    seeds = rng.integers(-2 ** 31, 2 ** 31, (scenes, 2)).astype(np.int32)
    return snr, seeds


@pytest.mark.parametrize("mics", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("n", [512, 1024, 2048, 4096])
def test_render_block_matches_delay_sum(n, mics):
    """K3's one-block render (a packed base row's two scenes, odd mic counts
    packed across them, the mixes, the packed inverse, the finish of both
    halves) at 1 and 2 scenes, 1 to 3 paths, mic rows shared over groups,
    with the finalize and noise (the noise held by its key map) and
    without, against ``delay_sum_plain`` within 1e-9 of the max; the rows
    K5 packs are K3's rows in K2's packing."""
    rng = np.random.default_rng(n + mics)
    t = torch.from_numpy
    for scenes, paths, groups, finish in ((1, 1, 1, True),
                                          (2, 1 + mics % 3, 2, True),
                                          (2, 3, 1 + mics // 3, False)):
        out_len = n - n // 8
        base, tau, gain = _render_case(rng, scenes, mics, paths, n)
        fade = rng.uniform(0.5, 1.0, out_len)
        snr, seeds = _noise_inputs(rng, scenes) if finish else (None, None)
        got, packed = render_block_model(base, tau, gain, n, out_len, fade,
                                         finish, snr, seeds, groups)
        want = cf.delay_sum_plain(
            t(base), t(tau), t(gain), n, out_len, t(fade), finish,
            None if snr is None else t(snr),
            None if seeds is None else t(seeds)).numpy()
        assert np.abs(got - want).max() < 1e-9 * np.abs(want).max()
        rows = got.reshape(scenes * mics, out_len)
        assert np.array_equal(packed, _pack(rows, n))


@pytest.mark.parametrize("mics", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("n", [512, 1024, 2048, 4096])
def test_window_block_matches_gcc_windowed(n, mics):
    """K2's one-block GCC (a scene's packed rows across scenes, odd pair
    counts, couples shared over groups) with ``WindowOut``'s lag window and
    block reductions, at 1 and 2 scenes and the narrowest and widest
    window, against ``gcc_windowed_plain``: the window within 1e-9 of the
    max, the argmax equal, the mean and the maximum within 1e-9."""
    rng = np.random.default_rng(10 * n + mics)
    pi, pj = _pairs(mics)
    mask = cf.band_mask(n, (300.0, 3400.0), 16000.0,
                        dtype=torch.float64).numpy()
    for scenes, wq, groups in ((1, 1, 2), (2, n // 256, 1)):
        sig = rng.standard_normal((scenes, mics, n - n // 5))
        z = _pack(sig.reshape(scenes * mics, -1), n)
        win, stats = window_block_model(z, scenes, mics, pi, pj, n, wq, mask,
                                        groups)
        w2, s2 = cf.gcc_windowed_plain(torch.from_numpy(sig), pi, pj, n, wq,
                                       torch.from_numpy(mask))
        w2, s2 = w2.numpy(), s2.numpy()
        assert np.abs(win - w2).max() < 1e-9 * np.abs(w2).max()
        assert np.array_equal(stats[..., 2], s2[..., 2])
        assert np.abs(stats[..., :2] - s2[..., :2]).max() < 1e-9


@pytest.mark.parametrize("n", [512, 4096])
def test_window_block_keeps_the_smallest_tied_index(n):
    """``WindowOut``'s reductions on a planted tie of the maximum whose
    smallest index (33: thread 33, warp 1) is held by a later warp than
    two larger tied indices (threads 5 and 2, warp 0) and by an earlier
    thread than another (34), and on a silent row whose zeros carry both
    signs: the smallest natural index (``torch.argmax``'s first
    occurrence) and +0 at index 0, whatever thread holds it."""
    threads = block_threads(n)
    rng = np.random.default_rng(n)
    corr = rng.uniform(-1, 0.5, n)
    ties = [threads + 5, 2 * threads + 2, 34, 33, n - 1]
    corr[ties] = 0.75
    got = block_reduce_model(corr, threads)
    assert got[1:] == (0.75, 33) == (0.75, int(torch.argmax(
        torch.from_numpy(corr))))
    assert abs(got[0] - np.abs(corr).sum()) < 1e-9 * n
    zero = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    zero[0] = -0.0
    total, top, at = block_reduce_model(zero, threads)
    assert (total, at) == (0.0, 0) and top == 0 and not np.signbit(top)


@pytest.mark.parametrize("scenes,mics,n,wq", [(2, 3, 1024, 2),
                                              (3, 5, 2048, 4),
                                              (1, 8, 4096, 16)])
def test_scene_block_is_render_then_window(scenes, mics, n, wq):
    """K5 in one block: ``window_block`` over the rows ``render_block``
    packed equals ``window_block`` over K3's rows as K2 packs them, to the
    bit, and both equal ``scene_windowed_plain`` within 1e-9."""
    rng = np.random.default_rng(scenes * 100 + mics + n)
    pi, pj = _pairs(mics)
    out_len = n - n // 4
    base, tau, gain = _render_case(rng, scenes, mics, 2, n)
    fade = rng.uniform(0.5, 1.0, out_len)
    snr, seeds = _noise_inputs(rng, scenes)
    mask = cf.band_mask(n, (300.0, 3400.0), 16000.0,
                        dtype=torch.float64).numpy()
    rows, packed = render_block_model(base, tau, gain, n, out_len, fade,
                                      True, snr, seeds, 2)
    fused = window_block_model(packed, scenes, mics, pi, pj, n, wq, mask)
    split = window_block_model(_pack(rows.reshape(scenes * mics, out_len), n),
                               scenes, mics, pi, pj, n, wq, mask)
    assert all(np.array_equal(a, b) for a, b in zip(fused, split))
    t = torch.from_numpy
    w2, s2 = cf.scene_windowed_plain(t(base), t(tau), t(gain), pi, pj, n,
                                     out_len, wq, t(fade), t(mask), t(snr),
                                     t(seeds))
    assert np.abs(fused[0] - w2.numpy()).max() < 1e-9
    assert np.array_equal(fused[1][..., 2], s2.numpy()[..., 2])


# ---------------------------------------------------------------------------
# K10a and K10c (csrc/rowdft.cu): the radix-16 stage as a W16 product on
# the tensor cores over K10b's strips, and the lane DFT on block_fft
# ---------------------------------------------------------------------------

LANE_ROWS = 32       # kLaneRows: the rows one lane-DFT block holds
LANE_LD = 129        # kLaneLd: their stride in float2
LANE_THREADS = 256   # fft_threads(128, kLaneRows)


def _strided(js, ss):
    """``Strided``: point j of sequence s at slot j*js + s*ss."""
    return lambda j, s: j * js + s * ss


def _stage_flat(buf, at, L, S, p, R, stw, sgn):
    """``stockham_stage<S, R>`` on a flat shared buffer (..., slots), point
    j of sequence s at slot at(j, s): butterfly ``task`` (sequence
    s = task mod S, i = task // S) reads points i + m*L/R and writes
    base + m*p.  Returns the new buffer and the read slots (tasks, R)."""
    q = L // R
    task = np.arange(q * S)
    s, i = task % S, task // S
    k = i & (p - 1)
    tstep = L // (p * R)
    reads = at(i[:, None] + np.arange(R) * q, s[:, None])
    v = [buf[..., reads[:, m]] for m in range(R)]
    if p > 1:
        v = [v[0]] + [v[m] * _twiddle(stw, m * k * tstep, sgn)
                      for m in range(1, R)]
    y = _dft_small(v, sgn)
    writes = at(((i - k) * R + k)[:, None] + np.arange(R) * p, s[:, None])
    assert np.array_equal(np.sort(writes, None), np.sort(reads, None))
    out = buf.copy()
    for m in range(R):
        out[..., writes[:, m]] = y[m]
    return out, reads


def block_fft_flat(buf, at, L, S, sgn=1.0, stage16=None):
    """``block_fft<S>`` on a flat buffer, point j of sequence s at slot
    at(j, s); ``stage16`` (same arguments as ``_stage_flat`` without R)
    replaces the float32 radix-16 stage.  Returns the buffer and each
    stage's read slots."""
    stw = _half_table(L)
    p = 1 << ((L.bit_length() - 1) & 3)
    reads = []
    if p > 1:
        buf, r = _stage_flat(buf, at, L, S, 1, p, stw, sgn)
        reads.append(r)
    while p < L:
        if stage16 is None:
            buf, r = _stage_flat(buf, at, L, S, p, 16, stw, sgn)
        else:
            buf, r = stage16(buf, at, L, S, p, stw, sgn)
        reads.append(r)
        p *= 16
    return buf, reads


def _ways(addr):
    """Wavefronts an 8-byte shared-memory access of consecutive threads
    takes, the most over its half-warps: distinct addresses (float2
    slots) in one of the 16 bank pairs."""
    worst = 1
    for h in range(0, addr.size, 16):
        a = np.unique(addr[h:h + 16])
        worst = max(worst, int(np.bincount(a % 16).max()))
    return worst


def _stage_ways(reads, threads):
    """The worst ``_ways`` over a stage's reads: thread t takes butterflies
    t + u*threads, one read instruction a point m."""
    worst = 1
    for u in range(0, reads.shape[0], threads):
        for m in range(reads.shape[1]):
            worst = max(worst, _ways(reads[u:u + threads, m]))
    return worst


def _lane_load_map():
    """K10c's 16-byte loads: thread idx < LANE_ROWS * 32 takes row
    idx // 32, lanes 4 (idx % 32) .. + 3; (rows, lanes) of every point in
    the order the threads take them."""
    idx = np.arange(LANE_ROWS * 32)
    rows = np.repeat(idx >> 5, 4)
    cols = (4 * (idx & 31)[:, None] + np.arange(4)).ravel()
    return rows, cols


def lane_dft_model(ar, ai, n2, conj=False, twiddle=False, cross=None,
                   natural=False):
    """K10c on (B, n2, 128) planes, block by block (LANE_ROWS rows from
    t0): the load map (``_lane_load_map``) with the whitening and forward
    twiddle prologues into shared memory at stride LANE_LD, ``block_fft``
    at L = 128, js = 1, ss = LANE_LD, then the planes stored by the load
    map with the conjugate twiddle, or the natural-order store (thread idx:
    r = idx % LANE_ROWS, s = idx // LANE_ROWS -> bin s*n2 + t0 + r)."""
    planes = ar.shape[0]
    a = ar + 1j * ai
    if cross is not None:
        r = a * np.conj(cross[0] + 1j * cross[1])
        a = r / (np.abs(r) + 1e-6)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(128))
                / (n2 * 128))
    rows, cols = _lane_load_map()
    slots = rows * LANE_LD + cols
    assert np.unique(slots).size == slots.size == LANE_ROWS * 128
    idx = np.arange(LANE_ROWS * 128)
    nat_r, nat_s = idx % LANE_ROWS, idx // LANE_ROWS
    out = np.full((planes, n2 * 128) if natural else (planes, n2, 128),
                  np.nan, complex)
    for t0 in range(0, n2, LANE_ROWS):
        v = a[:, t0 + rows, cols]
        if twiddle and not conj:
            v = v * tw[t0 + rows, cols]
        buf = np.full((planes, LANE_ROWS * LANE_LD), np.nan, complex)
        buf[:, slots] = v
        buf, _ = block_fft_flat(buf, _strided(1, LANE_LD), 128, LANE_ROWS,
                                -1.0 if conj else 1.0)
        if natural:
            z = buf[:, nat_r * LANE_LD + nat_s]
            if twiddle and conj:
                z = z * np.conj(tw[t0 + nat_r, nat_s])
            out[:, nat_s * n2 + t0 + nat_r] = z
        else:
            z = buf[:, slots]
            if twiddle and conj:
                z = z * np.conj(tw[t0 + rows, cols])
            out[:, t0 + rows, cols] = z
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("n2", [64, 128, 256, 512, 1024])
def test_lane_dft_schedule_matches_fft(n2):
    """Every prologue and epilogue against np.fft along the lanes: plain,
    the forward long twiddle (planes and natural order), the conjugate DFT
    with the conjugate twiddle (planes and natural order) and with the
    whitening prologue, and the whitening alone."""
    rng = np.random.default_rng(n2)
    ar, ai, br, bi = (rng.standard_normal((2, n2, 128)) for _ in range(4))
    z = ar + 1j * ai
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(128))
                / (n2 * 128))
    r = z * np.conj(br + 1j * bi)
    white = r / (np.abs(r) + 1e-6)
    t, s = np.meshgrid(np.arange(n2), np.arange(128), indexing="ij")

    def nat(planes):
        flat = np.empty((planes.shape[0], n2 * 128), complex)
        flat[:, s * n2 + t] = planes
        return flat

    fwd_tw = np.fft.fft(z * tw, axis=2)
    inv_tw = 128 * np.fft.ifft(z, axis=2) * np.conj(tw)
    cases = [({}, np.fft.fft(z, axis=2)),
             ({"twiddle": True}, fwd_tw),
             ({"twiddle": True, "natural": True}, nat(fwd_tw)),
             ({"conj": True}, 128 * np.fft.ifft(z, axis=2)),
             ({"conj": True, "twiddle": True}, inv_tw),
             ({"conj": True, "twiddle": True, "natural": True}, nat(inv_tw)),
             ({"conj": True, "twiddle": True, "cross": (br, bi)},
              128 * np.fft.ifft(white, axis=2) * np.conj(tw)),
             ({"cross": (br, bi)}, np.fft.fft(white, axis=2))]
    for kw, want in cases:
        got = lane_dft_model(ar, ai, n2, **kw)
        assert np.abs(got - want).max() < 1e-9 * np.abs(want).max(), kw


def test_lane_dft_bank_and_store_maps():
    """block_fft's accesses at js = 1 and the odd row stride LANE_LD take
    one wavefront a half-warp (16 rows in 16 bank pairs); at the unpadded
    stride 128 they would take 16.  The natural-order store reads
    [r * LANE_LD + s] for 16 consecutive r a half-warp (one wavefront) and
    writes each s as one run of LANE_ROWS consecutive bins (256 bytes);
    the loads and the planes' stores are 512-byte rows."""
    buf = np.zeros((1, LANE_ROWS * LANE_LD), complex)
    _, reads = block_fft_flat(buf, _strided(1, LANE_LD), 128, LANE_ROWS)
    assert len(reads) == 2   # radix 8, then radix 16
    assert all(_stage_ways(r, LANE_THREADS) == 1 for r in reads)
    _, reads = block_fft_flat(np.zeros((1, LANE_ROWS * 128), complex),
                              _strided(1, 128), 128, LANE_ROWS)
    assert max(_stage_ways(r, LANE_THREADS) for r in reads) == 16
    idx = np.arange(LANE_ROWS * 128)
    r, s = idx % LANE_ROWS, idx // LANE_ROWS
    assert _ways(r * LANE_LD + s) == 1
    n2 = 512
    bins = (s * n2 + r).reshape(-1, LANE_ROWS)
    assert (np.diff(bins, axis=1) == 1).all()
    rows, cols = _lane_load_map()
    first = (rows * 128 + cols)[::4].reshape(-1, 32)  # a warp's float4s
    assert (np.diff(first, axis=1) == 4).all()


def _k10a_strip(n2):
    """Lanes a K10a block holds: 16 up to n2 = 256, 8 at 512, 4 at 1024
    (at most 256 threads a block, ``row_dft_strip``)."""
    return 16 if n2 <= 256 else 4096 // n2



def _mma_fragments(sgn):
    """m16n8k8 TF32 fragment maps of lane l (gid = l // 4, tig = l % 4):
    W16 as ``make_w16`` builds the A registers of the two k8 halves
    (register r: row gid + 8 (r & 1), column tig + 4 (r >> 1) of the half,
    W16^{row * col mod 16}), gathered into (2, 16, 8); B register b of
    half ks: row tig + 4b, column gid; accumulator register h: row
    gid + 8 (h >> 1), column 2 tig + (h & 1)."""
    lane = np.arange(32)
    gid, tig = lane // 4, lane % 4
    a = np.full((2, 16, 8), np.nan, complex)
    seen = np.zeros((2, 16, 8), int)
    for ks in range(2):
        for r in range(4):
            row, col = gid + 8 * (r & 1), tig + 4 * (r >> 1)
            a[ks, row, col] = _w16((row * (8 * ks + col)) & 15, sgn)
            np.add.at(seen[ks], (row, col), 1)
    assert (seen == 1).all()
    full = np.exp(-2j * np.pi * sgn * np.outer(np.arange(16), np.arange(16))
                  / 16)
    assert np.abs(np.concatenate([a[0], a[1]], 1) - full).max() < 1e-13
    c_row = gid[:, None] + 8 * (np.arange(4) >> 1)
    c_col = 2 * tig[:, None] + (np.arange(4) & 1)
    cells = np.zeros((16, 8), int)
    np.add.at(cells, (c_row, c_col), 1)
    assert (cells == 1).all()
    return a, gid, tig, c_row, c_col


def mma_stage(buf, at, L, S, p, stw, sgn):
    """K10a's radix-16 stage (``MmaRadix16``): warp w takes butterflies
    32w .. 32w + 31 (sequence fastest) as four n8 tiles; in tile j, lane
    (gid, tig) loads inputs m = tig + 4c (c < 4) of butterfly
    32w + 8j + gid, times the stage twiddle W_L^{m k L/(16p)}, into B
    register c & 1 of k8 half c >> 1; the product with W16 leaves output m
    = row of butterfly 32w + 8j + column in each accumulator register,
    stored at base + m p (butterflies 2 tig and 2 tig + 1 in neighbouring
    slots, one 16-byte store).  Returns the buffer and the read slots."""
    q = L // 16
    tasks = q * S
    assert tasks % 32 == 0
    warps = tasks // 32
    tstep = L // (p * 16)
    a, gid, tig, c_row, c_col = _mma_fragments(sgn)
    w = np.arange(warps)[:, None]
    out = buf.copy()
    written = np.zeros(buf.shape[-1], int)
    reads = np.empty((tasks, 16), int)
    for j in range(4):
        task = w * 32 + 8 * j + gid                      # (warps, 32)
        s, i = task % S, task // S
        k = i & (p - 1)
        b = np.full(buf.shape[:-1] + (warps, 2, 8, 8), np.nan, complex)
        for c in range(4):
            m = tig + 4 * c
            addr = at(i + m * q, s)
            reads[task, m] = addr
            v = buf[..., addr]
            if p > 1:
                v = v * _twiddle(stw, m * k * tstep, sgn)
            b[..., w, c >> 1, tig + 4 * (c & 1), gid] = v
        assert not np.isnan(b).any()
        acc = a[0] @ b[..., 0, :, :] + a[1] @ b[..., 1, :, :]
        for h in range(4):
            row, col = c_row[:, h], c_col[:, h]
            task = w * 32 + 8 * j + col
            s, i = task % S, task // S
            k = i & (p - 1)
            addr = at((i - k) * 16 + k + row * p, s)
            if h & 1:   # the upper half of the 16-byte store of h - 1
                assert (s % 2 == 1).all()
                assert (addr - 1 == at((i - k) * 16 + k + row * p, s - 1)
                        ).all()
            out[..., addr] = acc[..., w, row, col]
            np.add.at(written, addr.ravel(), 1)
    assert np.array_equal(np.sort(np.flatnonzero(written)),
                          np.sort(reads, None))
    assert written.max() == 1
    return out, reads


def row_dft_model(xr, xi, n2, inverse=False, rep=1, scale=1.0, out_r=None,
                  mode=0):
    """K10a on (B, rows_in, 128) planes: K10b's strips (``_k10a_strip``
    lanes, point j of lane s at j*S + s) and stage loop, every radix-16
    stage ``mma_stage``; rows >= rows_in zero; the input scaled on load;
    per rep one launch."""
    sgn = -1.0 if inverse else 1.0
    S = _k10a_strip(n2)
    cur = xr + (0 if xi is None else 1j * xi)
    for it in range(rep):
        planes, rows_in, lanes = cur.shape
        strips = np.zeros((planes, lanes // S, n2, S), complex)
        strips[:, :, :rows_in] = ((cur * (1e-3 if it else scale))
                                  .reshape(planes, rows_in, lanes // S, S)
                                  .transpose(0, 2, 1, 3))
        done, _ = block_fft_flat(strips.reshape(planes, lanes // S, -1),
                                 _strided(S, 1), n2, S, sgn, mma_stage)
        cur = (done.reshape(planes, lanes // S, n2, S).transpose(0, 2, 1, 3)
               .reshape(planes, n2, lanes))
    if mode == 0:
        return cur.real, cur.imag
    if mode == 1:
        return cur.real
    return out_r + cur.real


@pytest.mark.parametrize("n2", [64, 128, 256, 512, 1024])
def test_row_dft_schedule_matches_fft(n2):
    """K10a's fragment maps and stage twiddles: forward, zero_top with the
    input scale, the unscaled inverse, rep 3 and the real-part modes 1 and
    2 against np.fft along the rows, and the tensor stages' count (192
    TF32 MACs a point each: 24 m16n8k8 products a tile of 8 butterflies)."""
    rng = np.random.default_rng(n2)
    xr = rng.standard_normal((2, n2, 128))
    xi = rng.standard_normal((2, n2, 128))
    z = xr + 1j * xi
    want = np.fft.fft(z, axis=1)
    tol = 1e-9 * np.abs(want).max()
    yr, yi = row_dft_model(xr, xi, n2)
    assert np.abs(yr + 1j * yi - want).max() < tol
    yr, yi = row_dft_model(xr[:, :n2 // 2], None, n2, scale=0.5)
    assert np.abs(yr + 1j * yi - np.fft.fft(0.5 * xr[:, :n2 // 2], n=n2,
                                            axis=1)).max() < tol
    inv = n2 * np.fft.ifft(z, axis=1)
    yr, yi = row_dft_model(xr, xi, n2, inverse=True)
    assert np.abs(yr + 1j * yi - inv).max() < tol
    want3 = z
    for it in range(3):
        want3 = np.fft.fft(want3 * (1e-3 if it else 1.0), axis=1)
    yr, yi = row_dft_model(xr, xi, n2, rep=3)
    assert np.abs(yr + 1j * yi - want3).max() < 1e-9 * np.abs(want3).max()
    got = row_dft_model(xr, xi, n2, inverse=True, mode=1)
    assert np.abs(got - inv.real).max() < tol
    acc = rng.standard_normal((2, n2, 128))
    got = row_dft_model(xr, xi, n2, inverse=True, out_r=acc, mode=2)
    assert np.abs(got - (acc + inv.real)).max() < tol
    stages = (n2.bit_length() - 1) // 4
    assert stages == {64: 1, 128: 1, 256: 2, 512: 2, 1024: 2}[n2]
    # A fragment's four k-lanes read one lane's points n2/16 rows apart,
    # one bank: 4 wavefronts a half-warp (a layout that spreads them
    # measured slower on an H100; PERF.md, the K10a ablations).
    S = _k10a_strip(n2)
    _, reads = block_fft_flat(np.zeros((1, n2 * S), complex), _strided(S, 1),
                              n2, S, 1.0, mma_stage)
    lane = np.arange(32)
    for r in reads[-stages:]:   # the tensor stages: warp w, tile j, c
        for w in range(r.shape[0] // 32):
            for j in range(4):
                task = w * 32 + 8 * j + lane // 4
                for c in range(4):
                    assert _ways(r[task, lane % 4 + 4 * c]) == 4
    macs = 2 * 4 * 3 * 16 * 8 * 8 / (8 * 16)   # k8 halves x parts x terms
    assert macs == 192
    assert n2 * _k10a_strip(n2) // 16 <= 256   # threads a block


@pytest.mark.parametrize("strip,n2", [
    (64, 256), (32, 512), (16, 1024), (8, 1024), (8, 2048), (4, 2048),
    (4, 4096), (2, 4096)])
def test_row_strip_stride_is_conflict_free(strip, n2):
    """K4a's pass 2 and K4b's and K6's row pass hold their rows at sequence
    stride ``row_ld`` (n2 + 16 / strip up to 16 rows, n2 + 1 above): the
    radix-16 stages' reads (point i + m*L/16 of sequence s, task i*S + s)
    and their writes after the first stage ((i - k)*16 + k + m*p), and
    pass 2's epilogue reads (slot r fastest, then k2), take one wavefront
    a half-warp; at n2 + 1 strips narrower than 16 rows took up to 2 (2
    and 8 rows) or 4 (4 rows)."""
    assert n2 * strip <= cf.BLOCK_POINTS
    ld = cf.row_ld(strip, n2)
    threads = -(-n2 * strip // 16)       # ``fft_threads``: 16 points each
    q = n2 // 16
    task = np.arange(q * strip)
    s, i = task % strip, task // strip
    m = np.arange(16)
    for stride, want in ((ld, 1), (n2 + 1, min(strip, max(1, 16 // strip)))):
        reads = s[:, None] * stride + i[:, None] + m * q
        assert _stage_ways(reads, threads) == want, (stride, want)
        for p in (16, 256):
            if p < n2:
                k = i & (p - 1)
                writes = (s[:, None] * stride + ((i - k) * 16 + k)[:, None]
                          + m * p)
                assert _stage_ways(writes, threads) == want
        idx = np.arange(strip * (n2 // 2 + 1))
        epilogue = (idx % strip) * stride + idx // strip
        assert _stage_ways(epilogue[:, None], threads) == want
    assert ld == (n2 + 1 if strip >= 16 else n2 + 16 // strip)

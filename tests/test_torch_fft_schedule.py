"""A float64 numpy model of the on-chip FFT schedules of ``csrc/fft.cuh``,
K4a (``palt_fft_real``) and K10b (``palt_row_stages``), that follows the
kernels' index maps step by step, held against ``np.fft``.

The CUDA kernels cannot run here; the model repeats their arithmetic of
indices so that a wrong map shows before the card sees it:

- ``block_fft``: Stockham stages of radix 16 (one of radix 2, 4 or 8
  first where log2(L) is not a multiple of 4), butterfly i reading points
  i + m*L/R with the twiddle index e = m*k*L/(pR) (k = i mod p) into the
  half table, sign flipped for e >= L/2, and writing (i - k)*R + k + m*p;
  the 8- and 16-point DFTs split into DFT-4s in registers;
- K4a: the n1 x n2 split (``cuda_fft.fft_real_split``), pass 1 over strips
  of S = 16 columns (``kStrip``) with the twiddle W_n^{j2 k1} (e = j2*k1 <
  n) as W_n2^{e / n1} * W_n^{e mod n1}, pass 2's blocks of 8, 16 or 32
  rows k1 (``cuda_fft.fft_real_rows_strip``) and their partners n1 - k1 (row
  n1/2 in the slot of row 0's) and the k2 maps
  of the Hermitian split, DC and Nyquist; one block for n <= 4096;
- K10b: strips of S lanes, zero_top, the input scale, the
  conjugate twiddles of the inverse, output modes 0/1/2 and rep chains.
"""

import numpy as np
import pytest

from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf

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


def fft_real_model(x, n):
    """K4a on (rows, len) real rows -> (rows, n/2 + 1), and the count of
    writes to each output bin."""
    rows, length = x.shape
    packed = (rows + 1) // 2
    xp = np.zeros((2 * packed, n))
    xp[:rows, :length] = x
    z = xp[0::2] + 1j * xp[1::2]                      # packed while loading
    bins = n // 2 + 1
    out = np.zeros((2 * packed, bins), complex)
    writes = np.zeros((2 * packed, bins), int)
    n1, n2 = cf.fft_real_split(n)
    tab = _half_table(n)
    if n1 == 1:                                       # fft_real_block
        zf = block_fft(z[:, :, None])[..., 0]
        k = np.arange(bins)
        zk, zm = zf[:, k], zf[:, (n - k) & (n - 1)]
        out[0::2], out[1::2] = _split_bin(zk, zm, 0), _split_bin(zk, zm, 1)
        writes += 1
        return out[:rows], writes[:rows]
    assert n1 * n2 == n and n1 >= n2 and n1 <= 1024 and n1 % 32 == 0
    # Pass 1 (fft_real_cols): strips c0 = b*S of columns j2 = c0 + s; the
    # strip holds point (j1, s) = z[n2*j1 + c0 + s].
    strips = z.reshape(packed, n1, n2 // S, S).transpose(0, 2, 1, 3)
    cols = block_fft(strips)                          # (packed, n2/S, n1, S)
    k1 = np.arange(n1)[:, None]
    j2 = (np.arange(n2 // S)[:, None, None] * S + np.arange(S))
    e = j2 * k1                                       # (n2/S, n1, S), < n
    assert e.max() < n
    lo = tab[:n1]                                     # W_n^r, r < n1
    hi = _twiddle(tab, np.arange(n2) * n1)            # W_n2^a, a < n2
    yv = cols * hi[e >> (n1.bit_length() - 1)] * lo[e & (n1 - 1)]
    y = yv.transpose(0, 2, 1, 3).reshape(packed, n1, n2)  # Y[k1, j2]
    # Pass 2 (fft_real_rows): block b holds rows pair_row(b, r), r < S2,
    # all blocks at once; then each (block, slot r, k2) of the epilogue.
    S2 = cf.fft_real_rows_strip(n2, packed)
    pairs = S2 // 2
    nb, h2 = n1 // S2, n2 // 2
    slot_rows = np.array([[_pair_row(b, r, n1, pairs) for r in range(S2)]
                          for b in range(nb)])             # (nb, S2)
    buf = block_fft(y[:, slot_rows, :].transpose(0, 1, 3, 2))  # (.,nb,n2,S)
    b = np.arange(nb)[:, None, None]
    r = np.arange(S2)[None, :, None]
    k2 = np.arange(h2 + 1)[None, None, :]
    row = slot_rows[:, :, None] + 0 * k2
    live = (k2 < h2) | (row == 0)          # bin n/2 is row 0's alone
    pr = np.where((row == 0) | (row == n1 // 2), r,
                  np.where(r < pairs, r + pairs, r - pairs)) + 0 * k2
    pk = np.where(row == 0, (n2 - k2) & (n2 - 1), n2 - 1 - k2)
    b, r, k2 = (np.broadcast_to(a, row.shape) for a in (b, r, k2))
    zk = buf[:, b[live], k2[live], r[live]]
    zm = buf[:, b[live], pk[live], pr[live]]
    k = (row + n1 * k2)[live]
    out[0::2, k] = _split_bin(zk, zm, 0)
    out[1::2, k] = _split_bin(zk, zm, 1)
    np.add.at(writes, (slice(None), k), 1)
    return out[:rows], writes[:rows]


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
    assert cf.fft_real_split(cf.FFT_REAL_MAX) == (1024, 1024)


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

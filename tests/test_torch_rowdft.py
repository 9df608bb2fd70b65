"""K10's port (``pyaudiolocalization_tpu_torch/ops/rowdft.py``) against the
TPU package's A/B tool ``tools/mxu_rowdft_bench.py``, run in Pallas
interpret mode on the CPU.

The tool's outputs hold row bins in its permuted orders (``_t_perm`` for
the matrix schedule, bit reversal for the butterfly stages) and the full
forward's bin ``s * n2 + perm[row]`` at plane position [row, s]; the port
returns natural order, so each comparison maps the tool's rows first, as
the tool's own ``check`` does (:436-451).  Tolerances are the tool's:
2e-4 of the maximum for transforms, 2e-3 for the chain, in float32.  The
float64 twins are held against numpy's FFT at 1e-12, and a numpy
emulation of TF32 rounding holds the 3xTF32 design of K10a's radix-16
products.
"""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
from pyaudiolocalization_tpu_torch.ops import rowdft as rd

TOOL = Path(__file__).resolve().parents[1] / "tools" / "mxu_rowdft_bench.py"
SMALL = (64, 128)
ALL_N2 = (64, 128, 256, 512, 1024)
B = 2


_TOOL_CACHE_KEYS = ("jax_compilation_cache_dir",
                    "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def tool():
    """The tool, loaded from its path.  On import it creates a directory
    for jax's persistent compilation cache and points the cache there; the
    load runs with ``os.makedirs`` stubbed and those two settings skipped,
    so it writes nothing and jax's settings stay the session's."""
    saved = [getattr(jax.config, key) for key in _TOOL_CACHE_KEYS]
    update = jax.config.update

    def update_others(name, value):
        if name not in _TOOL_CACHE_KEYS:
            update(name, value)

    spec = importlib.util.spec_from_file_location("mxu_rowdft_bench", TOOL)
    module = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "makedirs", lambda *args, **kwargs: None)
        mp.setattr(jax.config, "update", update_others)
        spec.loader.exec_module(module)
    assert [getattr(jax.config, key) for key in _TOOL_CACHE_KEYS] == saved
    return module


def _inputs(n2, seed=0):
    rng = np.random.default_rng(seed + n2)
    x = rng.standard_normal((B, n2, 128)).astype(np.float32)
    xi = rng.standard_normal((B, n2, 128)).astype(np.float32)
    return x, xi


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _c(planes):
    return planes[0].numpy() + 1j * planes[1].numpy()


def _jc(planes):
    return np.asarray(planes[0]) + 1j * np.asarray(planes[1])


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _bitrev(n2):
    bits = int(np.log2(n2))
    r = np.zeros(n2, np.int64)
    t = np.arange(n2)
    for _ in range(bits):
        r = (r << 1) | (t & 1)
        t >>= 1
    return r


# ---------------------------------------------------------------------------
# Twins against the tool (interpret mode, float32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n2", SMALL)
def test_row_dft_matches_tool(tool, n2):
    x, xi = _inputs(n2)
    want = _c(rd.row_dft_plain(_t(x), _t(xi)))
    got = _jc(tool.run_rowdft(jnp.asarray(x), jnp.asarray(xi),
                              interpret=True))
    assert _rel(got, want[:, tool._t_perm(n2)]) < 2e-4
    got = _jc(tool.run_stages(jnp.asarray(x), jnp.asarray(xi),
                              interpret=True))
    assert _rel(got, want[:, _bitrev(n2)]) < 2e-4


@pytest.mark.parametrize("n2", SMALL)
def test_row_inverse_matches_tool(tool, n2):
    """The tool's inverse consumes the _t_perm order; the port's takes the
    same spectrum in natural order.  Both return natural rows, unscaled."""
    x, xi = _inputs(n2, 1)
    perm = tool._t_perm(n2)
    got = _jc(tool.run_rowinv(jnp.asarray(x[:, perm]),
                              jnp.asarray(xi[:, perm]), interpret=True))
    want = _c(rd.row_dft_plain(_t(x), _t(xi), inverse=True))
    assert _rel(got, want) < 2e-4
    back = _c(rd.row_dft_plain(*rd.row_dft_plain(_t(x), _t(xi)),
                               inverse=True))
    assert _rel(back / n2, x + 1j * xi) < 2e-6


@pytest.mark.parametrize("n2", SMALL)
def test_rep_chain_matches_tool(tool, n2):
    """rep = 8 chains transforms with x1e-3 between them.  The tool chains
    in its _t_perm order; the port in natural order.  The tool's chain is
    rebuilt from the port's rep-1 twin and the permutation, and the port's
    rep-8 twin is its natural chain."""
    x, xi = _inputs(n2, 2)
    perm = tool._t_perm(n2)
    got = _jc(tool.run_rowdft(jnp.asarray(x), jnp.asarray(xi),
                              interpret=True, rep=8))
    z = x + 1j * xi
    nat = z.copy()
    for it in range(8):
        scale = 1e-3 if it else 1.0
        z = _c(rd.row_dft_plain(_t((z * scale).real.astype(np.float32)),
                                _t((z * scale).imag.astype(np.float32))))
        z = z[:, perm]
        nat = np.fft.fft(nat * scale, axis=1)
    assert _rel(got, z) < 2e-4
    assert _rel(_c(rd.row_dft_plain(_t(x), _t(xi), rep=8)), nat) < 2e-4


@pytest.mark.parametrize("n2", SMALL)
def test_lane_dft_matches_tool(tool, n2):
    x, xi = _inputs(n2, 3)
    got = _jc(tool.run_lane(jnp.asarray(x), jnp.asarray(xi),
                            interpret=True))
    assert _rel(got, _c(rd.lane_dft_plain(_t(x), _t(xi)))) < 2e-4


@pytest.mark.parametrize("zero_top", [False, True])
@pytest.mark.parametrize("body", ["full", "mxu", "mxu2"])
@pytest.mark.parametrize("n2", SMALL)
def test_full_forward_matches_tool(tool, n2, body, zero_top):
    """``run_fwd_full`` (stages), ``run_fwd_mxu`` and ``run_fwd_mxu2``
    against ``fft_four_step_plain``: the tool's plane [row, s] holds bin
    s * n2 + perm[row]."""
    x, _ = _inputs(n2, 4)
    if zero_top:
        x = np.ascontiguousarray(x[:, :n2 // 2])
    run = {"full": tool.run_fwd_full, "mxu": tool.run_fwd_mxu,
           "mxu2": tool.run_fwd_mxu2}[body]
    got = _jc(run(jnp.asarray(x), zero_top, interpret=True))
    want = rd.fft_four_step_plain(_t(x), zero_top).numpy()
    assert want.shape == (B, n2 * 128)
    perm = _bitrev(n2) if body == "full" else tool._t_perm(n2)
    k = np.arange(128)[None, :] * n2 + perm[:, None]
    assert _rel(got, want[:, k]) < 2e-4


@pytest.mark.parametrize("schedule", ["stages", "mxu"])
@pytest.mark.parametrize("n2", SMALL)
def test_chain_matches_tool(tool, n2, schedule):
    x, _ = _inputs(n2, 5)
    run = tool.run_chain_stages if schedule == "stages" else tool.run_chain_mxu
    got = np.asarray(run(jnp.asarray(x), interpret=True)[0])
    want = rd.chain_plain(_t(x)).numpy()
    assert got.shape == want.shape == (B, n2, 128)
    assert _rel(got, want) < 2e-3


def test_chain_on_four_planes_matches_tool_steps(tool):
    """The chain on four planes of their own, whose output is not ~0 away
    from lag 0: the tool's chain cannot take them (it scales one plane), so
    it is rebuilt from the tool's kernels in its own layout: ``run_fwd_mxu``
    for the four forwards, the whitened cross spectrum, the conjugate lane
    DFT as conj(``run_lane``(conj(.))), the conjugate of ``_longtw_perm``,
    and ``run_rowinv``, whose rows come back natural."""
    n2 = 64
    rng = np.random.default_rng(8)
    x4 = rng.standard_normal((4, B, n2, 128)).astype(np.float32)
    spec = _jc(tool.run_fwd_mxu(jnp.asarray(x4.reshape(4 * B, n2, 128)),
                                False, interpret=True)).reshape(4, B, n2, 128)
    white = np.stack([spec[a] * np.conj(spec[b]) for a, b in rd.CHAIN_PAIRS])
    white = (white / (np.abs(white) + rd.CHAIN_EPS)).reshape(-1, n2, 128)
    white = white.astype(np.complex64)
    lane = np.conj(_jc(tool.run_lane(jnp.asarray(white.real),
                                     jnp.asarray(-white.imag),
                                     interpret=True)))
    twr, twi = tool._longtw_perm(n2 * 128)
    e = lane * (twr - 1j * twi)
    yr, _ = tool.run_rowinv(jnp.asarray(e.real.astype(np.float32)),
                            jnp.asarray(e.imag.astype(np.float32)),
                            interpret=True)
    got = np.asarray(yr).reshape(3, B, n2, 128).sum(0)
    want = rd.chain_plain(_t(x4)).numpy()
    assert got.shape == want.shape == (B, n2, 128)
    assert np.abs(want).max() < 100 * np.median(np.abs(want))
    assert _rel(got, want) < rd.CHAIN_TOL


ROWDFT_CU = (Path(__file__).resolve().parents[1] / "pyaudiolocalization_tpu_torch"
             / "csrc" / "rowdft.cu")


def _kernel_w16(inverse=False):
    """W16 (its conjugate for the inverse) as K10a builds it on the card,
    W16^e = (kCos16[e], -kCos16[(e + 12) mod 16]) from the float32 table
    ``kCos16`` in csrc/rowdft.cu, as a (16, 16) complex64 matrix W16^{mk}."""
    text = ROWDFT_CU.read_text()
    body = text[text.index("kCos16[16] = {"):]
    body = body[body.index("{") + 1:body.index("}")]
    cos = np.array([float(v.strip().rstrip("f")) for v in body.split(",")],
                   np.float32)
    assert cos.shape == (16,)
    e = np.outer(np.arange(16), np.arange(16)) % 16
    sgn = np.float32(-1.0 if inverse else 1.0)
    return (cos[e] + 1j * (-sgn * cos[(e + 12) % 16])).astype(np.complex64)


def _half_twiddles(n):
    """``cuda_fft._twiddles(n)`` as complex64: exp(-2 pi i m / n), m < n/2,
    the stage twiddles K10a, K10b and K10c read."""
    tab = cf._twiddles(n, "cpu").numpy()
    return (tab[:, 0] + 1j * tab[:, 1]).astype(np.complex64)


def _from_half(tab, e):
    """exp(-2 pi i e / n) from the half table (``sub_twiddle``)."""
    half = tab.shape[0]
    return np.where(e < half, tab[e % half], -tab[e % half])


@pytest.mark.parametrize("n2", ALL_N2)
def test_host_constants_match_tool(tool, n2):
    """The constants the kernels read, against the tool's (both made in
    float64, by other products, to float32 rounding): K10a's W16 and its
    conjugate against the tool's lane matrix W_128 (W16^{mk} is
    W_128^{8mk}) and its DFT-8 constants; the stage twiddles
    ``_twiddles(n2)`` of K10a and K10b against the tool's butterfly stage
    twiddles, and ``_twiddles(128)`` of K10c gathered into the tool's lane
    matrix; the long twiddle against the tool's after its row order."""
    *_, w1r, w1i = tool._bfly_consts(n2 * 128)
    w1 = w1r + 1j * w1i
    w16 = _kernel_w16()
    eight = 8 * np.arange(16)
    assert np.abs(w16 - w1[np.ix_(eight, np.arange(16))]).max() < 2e-7
    assert np.abs(_kernel_w16(inverse=True) - np.conj(w16)).max() == 0
    w8 = np.array([c + 1j * d for c, d in tool._W8])
    assert np.abs(w16[1, ::2][:8] - w8).max() < 2e-7
    tab = _half_twiddles(128)
    e = np.outer(np.arange(128), np.arange(128)) % 128
    assert np.abs(_from_half(tab, e) - w1).max() < 2e-7
    # The tool's stage m (m = n2, n2/2, ..., 2) multiplies row q's second
    # half-block entry j = q mod m - m/2 by W_m^j = W_n2^{j n2/m}.
    mask, str_, sti, *_ = tool._bfly_consts(n2 * 128)
    tab = _half_twiddles(n2)
    q = np.arange(n2)
    for stage, m in enumerate(2 ** np.arange(int(np.log2(n2)), 0, -1)):
        j = q % m - m // 2
        low = q % m < m // 2
        want = str_[stage, :, 0] + 1j * sti[stage, :, 0]
        got = np.where(low, 1.0, tab[np.where(low, 0, j) * (n2 // m)])
        assert np.abs(got - want).max() < 2e-7
    lr, li = rd.long_twiddle(n2)
    pr, pi = tool._longtw_perm(n2 * 128)
    perm = tool._t_perm(n2)
    assert np.array_equal(lr[perm], pr) and np.array_equal(li[perm], pi)


# ---------------------------------------------------------------------------
# Float64 twins against numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n2", ALL_N2)
def test_float64_twins_match_numpy(n2):
    rng = np.random.default_rng(n2)
    x = rng.standard_normal((B, n2, 128))
    xi = rng.standard_normal((B, n2, 128))
    z = x + 1j * xi
    assert _rel(_c(rd.row_dft_plain(_t(x), _t(xi))),
                np.fft.fft(z, axis=1)) < 1e-12
    assert _rel(_c(rd.row_dft_plain(_t(x), _t(xi), inverse=True)),
                np.fft.ifft(z, axis=1) * n2) < 1e-12
    half = np.ascontiguousarray(x[:, :n2 // 2])
    assert _rel(_c(rd.row_dft_plain(_t(half), zero_top=True)),
                np.fft.fft(half, n=n2, axis=1)) < 1e-12
    # The four steps: row DFT, twiddle + lane DFT = the flat row's DFT.
    flat = x.reshape(B, -1)
    spec = np.fft.fft(flat, axis=1)
    planes = rd.lane_dft_plain(*rd.row_dft_plain(_t(x)), twiddle=True)
    k = np.arange(128)[None, :] * n2 + np.arange(n2)[:, None]
    assert _rel(_c(planes), spec[:, k]) < 1e-12
    assert _rel(rd.fft_four_step_plain(_t(x)).numpy(), spec) < 1e-12
    assert _rel(rd.fft_four_step_plain(_t(half), zero_top=True).numpy(),
                np.fft.fft(half.reshape(B, -1), n=n2 * 128, axis=1)) < 1e-12
    # ... and the conjugate lane DFT + twiddle, then the inverse row DFT,
    # undo them unscaled.
    back = rd.row_dft_plain(*rd.lane_dft_plain(*planes, conj=True,
                                               twiddle=True), inverse=True)
    assert _rel(_c(back) / (n2 * 128), x) < 1e-12
    # The chain through the twins' steps, as the kernels run it.
    specs = [rd.lane_dft_plain(*rd.row_dft_plain(_t(x * (1 + 0.25 * m))),
                               twiddle=True) for m in range(4)]
    acc = 0.0
    for a, b in rd.CHAIN_PAIRS:
        r = _c(specs[a]) * np.conj(_c(specs[b]))
        w = r / (np.abs(r) + rd.CHAIN_EPS)
        acc = acc + _c(rd.row_dft_plain(*rd.lane_dft_plain(
            _t(w.real), _t(w.imag), conj=True, twiddle=True),
            inverse=True)).real
    want = sum(np.fft.ifft(
        (lambda r: r / (np.abs(r) + rd.CHAIN_EPS))(
            np.fft.fft(flat * (1 + 0.25 * a))
            * np.conj(np.fft.fft(flat * (1 + 0.25 * b)))), axis=1).real
        * n2 * 128 for a, b in rd.CHAIN_PAIRS).reshape(x.shape)
    assert _rel(acc, want) < 1e-12
    assert _rel(rd.chain_plain(_t(x)).numpy(), want) < 1e-12
    # Four planes of their own, and the whitened cross spectrum's lane DFT.
    x4 = np.stack([x, xi, x * xi, x - xi])
    specs = np.fft.fft(x4.reshape(4, B, -1), axis=-1)
    want = sum(np.fft.ifft(
        (lambda r: r / (np.abs(r) + rd.CHAIN_EPS))(
            specs[a] * np.conj(specs[b])), axis=-1).real * n2 * 128
        for a, b in rd.CHAIN_PAIRS).reshape(x.shape)
    assert _rel(rd.chain_plain(_t(x4)).numpy(), want) < 1e-12
    r = z * np.conj(xi + 1j * x)
    r = r / (np.abs(r) + rd.CHAIN_EPS)
    assert _rel(_c(rd.lane_dft_plain(_t(x), _t(xi), cross=(_t(xi), _t(x)))),
                np.fft.fft(r, axis=2)) < 1e-12


# ---------------------------------------------------------------------------
# The wrappers on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_take_the_twins_on_the_cpu():
    x, xi = (_t(a) for a in _inputs(64, 6))
    cf.reset_launches()
    for fn in (rd.row_dft, rd.row_stages):
        for kw in ({}, {"inverse": True}, {"rep": 3}):
            got = fn(x, xi, **kw)
            want = rd.row_dft_plain(x, xi, **kw)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        half = x[:, :32].contiguous()
        got = fn(half, zero_top=True)
        want = rd.row_dft_plain(half, zero_top=True)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for kw in ({}, {"conj": True, "twiddle": True}, {"cross": (xi, x)}):
        got = rd.lane_dft(x, xi, **kw)
        want = rd.lane_dft_plain(x, xi, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for schedule in ("mxu", "stages"):
        assert torch.equal(rd.fft_four_step(x, schedule),
                           rd.fft_four_step_plain(x))
        assert torch.equal(rd.chain(x, schedule), rd.chain_plain(x))
        x4 = torch.stack([x, xi, x, xi])
        assert torch.equal(rd.chain(x4, schedule), rd.chain_plain(x4))
    assert all(cf.LAUNCHES[k] == 0 for k in ("row_dft", "row_stages",
                                              "lane_dft"))


@pytest.mark.parametrize("case", ["n2_small", "n2_large", "n2_odd",
                                  "float64", "strided", "width",
                                  "mismatch", "schedule", "chain_planes",
                                  "cross_shape"])
def test_wrappers_raise(case):
    x, xi = (_t(a) for a in _inputs(64, 7))
    with pytest.raises(ValueError):
        if case == "n2_small":
            rd.row_dft(x[:, :32].contiguous())
        elif case == "n2_large":
            rd.row_stages(torch.zeros((1, 2048, 128)))
        elif case == "n2_odd":
            rd.lane_dft(torch.zeros((1, 96, 128)), torch.zeros((1, 96, 128)))
        elif case == "float64":
            rd.fft_four_step(x.double())
        elif case == "strided":
            rd.row_dft(x.transpose(0, 1).contiguous().transpose(0, 1))
        elif case == "width":
            rd.chain(torch.zeros((1, 64, 64)))
        elif case == "mismatch":
            rd.row_stages(x, xi[:1].contiguous())
        elif case == "chain_planes":
            rd.chain(torch.stack([x, xi, x]))
        elif case == "cross_shape":
            rd.lane_dft(x, xi, cross=(x[:, :32].contiguous(), xi))
        else:
            rd.chain(x, schedule="radix4")


# ---------------------------------------------------------------------------
# The 3xTF32 design of K10a's radix-16 products, emulated
# ---------------------------------------------------------------------------

def _tf32(a):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _emulated_row_dft(x, n2, terms):
    """K10a's schedule in numpy: ``block_fft``'s stages along the rows, the
    radix-2, 4 or 8 first stage in float32, then each radix-16 stage's
    inputs times the stage twiddle (from ``_twiddles(n2)``) in float32 and
    the product with the kernel's W16 with its operands in TF32, ``terms``
    of hi*hi, lo*hi, hi*lo summed (the kernel's ``kTerms``: 3 is 3xTF32,
    2 drops the data's lo, 1 is plain TF32)."""
    w16 = _kernel_w16()
    tab = _half_twiddles(n2)

    def parts(a):
        hi = _tf32(a)
        return hi.astype(np.float64), _tf32(a - hi).astype(np.float64)

    def dot(a, b):
        (ah, al), (bh, bl) = parts(a), parts(b)
        y = np.matmul(ah, bh)
        if terms > 1:
            y = y + np.matmul(al, bh)
        if terms > 2:
            y = y + np.matmul(ah, bl)
        return y

    cur = x.astype(np.complex64)
    p = 1 << ((n2.bit_length() - 1) & 3)
    if p > 1:   # point i + m q of butterfly i, out to i p + m
        q = n2 // p
        wp = np.exp(-2j * np.pi * np.outer(np.arange(p), np.arange(p)) / p)
        v = cur.reshape(B, p, q, 128)
        y = np.einsum("am,bmqc->bqac", wp.astype(np.complex64), v)
        cur = y.reshape(B, n2, 128).astype(np.complex64)
    while p < n2:
        q = n2 // 16
        i = np.arange(q)
        k = i & (p - 1)
        tw = _from_half(tab, np.outer(np.arange(16), k) * (n2 // (16 * p)))
        v = (cur.reshape(B, 16, q, 128) * tw[None, :, :, None]).astype(
            np.complex64)
        vr = v.real.transpose(1, 0, 2, 3).reshape(16, -1)
        vi = v.imag.transpose(1, 0, 2, 3).reshape(16, -1)
        yr = dot(w16.real, vr) - dot(w16.imag, vi)
        yi = dot(w16.real, vi) + dot(w16.imag, vr)
        y = (yr + 1j * yi).astype(np.complex64).reshape(16, B, q, 128)
        out = np.empty_like(cur)
        for m in range(16):
            out[:, (i - k) * 16 + k + m * p] = y[m]
        cur = out
        p *= 16
    return cur


@pytest.mark.parametrize("n2", [64, 1024])
def test_three_tf32_split_meets_the_limit(n2):
    """Plain TF32 products miss float32 accuracy by orders of magnitude
    (>= 1e-4 of the maximum, near the tool's 2e-4 limit), and dropping one
    of the three products (the data's lo) misses the card checks' limit;
    the 3xTF32 split keeps the row DFT within 1e-6."""
    rng = np.random.default_rng(n2)
    x = (rng.standard_normal((B, n2, 128))
         + 1j * rng.standard_normal((B, n2, 128))).astype(np.complex64)
    want = np.fft.fft(x.astype(np.complex128), axis=1)
    plain, two, split = (_rel(_emulated_row_dft(x, n2, t), want)
                         for t in (1, 2, 3))
    assert plain >= 1e-4, plain
    assert two > 2 * rd.TRANSFORM_TOL, two
    assert split <= 1e-6, split


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    vals = np.array([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, 1 + 2.0 ** -12,
                     -(1 + 2.0 ** -11)], np.float32)
    got = _tf32(vals)
    assert got[0] == one + ulp            # tie, away from zero
    assert got[1] == one + 2 * ulp        # tie, away from zero
    assert got[2] == one                  # below half an ulp
    assert got[3] == -(one + ulp)         # ties away for negatives too

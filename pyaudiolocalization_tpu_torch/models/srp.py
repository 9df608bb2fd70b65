"""SRP-PHAT: steered-response-power localization over a candidate grid
(counterpart of the JAX package's models/srp.py).

For every candidate position x, sum each pair's whitened correlation at
that position's expected lag

    SRP(x) = sum_p corr_p[ fs * (|x - mic_i| - |x - mic_j|) / c ]

(fractional lags interpolated linearly) and take the argmax: a coarse grid
over the search box on a max-pooled correlation, a fine re-grid of +-1.5
coarse cells around the peak on the raw correlation, then sub-cell
quadratic refinement.  Correlations are in circular order, exactly as
``ops/gccphat.gcc_phat_all_pairs`` returns them.

Every function takes a leading scene axis written out (the JAX package
``vmap``s one scene): correlations (..., P, nfft), mic positions
(..., M, 3) and candidate points (..., G, 3) broadcast against each other;
the search box is one box for every scene, (3,), or one per scene,
(..., 3).  The JAX package's windowed ``srp_map`` sums a hat kernel of
shape (G, P, 2L+1) that XLA fuses away; torch would materialize it
(57 MB a scene for the 24^3 grid of a 6-pair sweep at 16 kHz, 320 MB for
28 pairs at 44.1 kHz).  Here it is the same sum as a two-tap
interpolation: the hat weights are non-zero only at floor(idx) and
floor(idx) + 1, so each (point, pair) reads two window samples, and the
map of G points over B scenes holds O(B * G * (M + P)) values.  No TPU
kernel ran here; this is plain PyTorch on either device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import solver as solver_ops

#: Stage-1 grid cells per axis (the JAX package's default and the one its
#: api and sweep use).
COARSE_N = 24


class SrpResult(NamedTuple):
    position: torch.Tensor   # (..., 3)
    power: torch.Tensor      # (...,) SRP value at the estimate
    coarse: torch.Tensor     # (..., 3) stage-1 cell center (diagnostics)


class MultiSrpResult(NamedTuple):
    positions: torch.Tensor  # (..., K, 3) in coarse extraction order
    powers: torch.Tensor     # (..., K) fine-stage SRP values


def _axis_grid(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) cell centres of each interval [lo, hi] (lo, hi (...))."""
    steps = (torch.arange(n, dtype=lo.dtype, device=lo.device) + 0.5) / n
    return lo[..., None] + steps * (hi - lo)[..., None]


def _grid_points(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n^3, 3) cell-centre lattice over the box [lo, hi] (lo, hi
    (..., 3)), x slowest and z fastest (``meshgrid(indexing='ij')``)."""
    ax = [_axis_grid(lo[..., d], hi[..., d], n) for d in range(3)]
    lead = ax[0].shape[:-1]
    gx = ax[0][..., :, None, None].expand(lead + (n, n, n))
    gy = ax[1][..., None, :, None].expand(lead + (n, n, n))
    gz = ax[2][..., None, None, :].expand(lead + (n, n, n))
    return torch.stack([gx, gy, gz], -1).reshape(lead + (n ** 3, 3))


def _take_value(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (..., G) at idx (...) -> (...); the leading axes broadcast."""
    lead = tuple(np.broadcast_shapes(values.shape[:-1], idx.shape))
    return torch.gather(values.expand(lead + values.shape[-1:]), -1,
                        idx.expand(lead)[..., None])[..., 0]


def _take_point(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (..., G, 3) at idx (...) -> (..., 3); the leading axes
    broadcast."""
    lead = tuple(np.broadcast_shapes(points.shape[:-2], idx.shape))
    index = idx.expand(lead)[..., None, None].expand(lead + (1, 3))
    return torch.gather(points.expand(lead + points.shape[-2:]), -2,
                        index)[..., 0, :]


# ---------------------------------------------------------------------------
# Shared grid-search machinery
# ---------------------------------------------------------------------------

def quadratic_peak_offset(fine_val: torch.Tensor, k: torch.Tensor,
                          fine_n: int, spacing: torch.Tensor) -> torch.Tensor:
    """Sub-cell 3-axis parabolic peak interpolation on a fine-lattice map:
    a parabola through the argmax ``k`` and its two neighbours on each axis.
    Boundary argmaxes and non-concave fits keep a zero offset; offsets are
    clamped to half a cell.  fine_val (..., fine_n^3), k (...), spacing
    (..., 3) -> (..., 3) position correction."""
    strides = torch.tensor([fine_n * fine_n, fine_n, 1], device=k.device)
    kk = k[..., None]
    idx3 = torch.div(kk, strides, rounding_mode="floor") % fine_n
    size = fine_val.shape[-1]
    f0 = _take_value(fine_val, k)[..., None]
    km = torch.clamp(kk - strides, 0, size - 1)
    kp = torch.clamp(kk + strides, 0, size - 1)
    f_m = torch.gather(fine_val, -1, km)
    f_p = torch.gather(fine_val, -1, kp)
    interior = (idx3 > 0) & (idx3 < fine_n - 1)
    denom = f_m - 2.0 * f0 + f_p
    off = torch.where(interior & (denom < 0.0),
                      0.5 * (f_m - f_p) / torch.where(
                          denom < 0.0, denom, torch.full_like(denom, -1.0)),
                      torch.zeros_like(denom))
    return torch.clamp(off, -0.5, 0.5) * spacing


def _fine_stage(fine_fn, center: torch.Tensor, cell: torch.Tensor,
                fine_n: int):
    """Fine re-grid of +-1.5 cells around ``center`` (..., 3): (position
    with the quadratic offset, its fine-map value)."""
    fine_pts = _grid_points(center - 1.5 * cell, center + 1.5 * cell, fine_n)
    fine_val = fine_fn(fine_pts)
    k = torch.argmax(fine_val, -1)
    pos = _take_point(fine_pts, k) + quadratic_peak_offset(
        fine_val, k, fine_n, 3.0 * cell / fine_n)
    return pos, _take_value(fine_val, k)


def two_stage_search(coarse_fn, fine_fn, lower: torch.Tensor,
                     upper: torch.Tensor, coarse_n: int, fine_n: int):
    """Coarse argmax over the box, then a fine re-grid of +-1.5 coarse
    cells around the peak, then sub-cell parabolic peak interpolation.
    ``coarse_fn`` / ``fine_fn`` map (..., G, 3) points to (..., G) values.
    Returns (pos, power, center, cell); ``pos`` is not clipped to the box
    (the fine grid extends half a cell beyond it)."""
    pts = _grid_points(lower, upper, coarse_n)
    vals = coarse_fn(pts)
    center = _take_point(pts, torch.argmax(vals, -1))
    cell = (upper - lower) / coarse_n
    pos, power = _fine_stage(fine_fn, center, cell, fine_n)
    return pos, power, center, cell


def suppressed_multi_search(coarse_fn, fine_fn, lower: torch.Tensor,
                            upper: torch.Tensor, coarse_n: int, fine_n: int,
                            num_sources: int,
                            min_separation: Optional[float]):
    """Iterative argmax + spatial suppression over the coarse map (radius
    three coarse cells, or ``min_separation``), then the fine stage around
    each extracted peak.  Returns (positions (..., K, 3) clipped to the
    box, powers (..., K)) in coarse extraction order."""
    pts = _grid_points(lower, upper, coarse_n)
    vals = coarse_fn(pts)
    cell = (upper - lower) / coarse_n
    radius = (3.0 * torch.amax(cell, -1)[..., None]
              if min_separation is None else float(min_separation))
    positions, powers = [], []
    for _ in range(num_sources):
        center = _take_point(pts, torch.argmax(vals, -1))
        close = torch.linalg.norm(pts - center[..., None, :],
                                  dim=-1) <= radius
        vals = torch.where(close, torch.full_like(vals, -float("inf")), vals)
        pos, power = _fine_stage(fine_fn, center, cell, fine_n)
        positions.append(pos)
        powers.append(power)
    positions = torch.stack(positions, -2)
    return (torch.minimum(torch.maximum(positions, lower[..., None, :]),
                          upper[..., None, :]),
            torch.stack(powers, -1))


# ---------------------------------------------------------------------------
# The SRP map
# ---------------------------------------------------------------------------

def _expected_lags(points, mic_positions, pairs_i, pairs_j, fs, c):
    """(..., G, P) expected peak lags in samples: lag -(arrival_j -
    arrival_i) * fs (the sign of models/tdoa.py)."""
    d = torch.linalg.norm(points[..., :, None, :]
                          - mic_positions[..., None, :, :], dim=-1)
    pi = torch.as_tensor(np.asarray(pairs_i), dtype=torch.long,
                         device=points.device)
    pj = torch.as_tensor(np.asarray(pairs_j), dtype=torch.long,
                         device=points.device)
    tau = -(d[..., pj] - d[..., pi]) / c
    return tau * fs


def _gather_lags(corr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """corr (..., P, L) read at integer indices idx (..., G, P) of each
    pair's row -> (..., G, P)."""
    num_pairs, length = corr.shape[-2:]
    lead = tuple(np.broadcast_shapes(corr.shape[:-2], idx.shape[:-2]))
    rows = torch.arange(num_pairs, device=idx.device) * length
    flat = corr.reshape(corr.shape[:-2] + (num_pairs * length,))
    flat = flat.expand(lead + (num_pairs * length,))
    grid = (idx + rows).expand(lead + idx.shape[-2:])
    out = torch.gather(flat, -1, grid.reshape(lead + (-1,)))
    return out.reshape(grid.shape)


def srp_map(corr: torch.Tensor, points: torch.Tensor,
            mic_positions: torch.Tensor, pairs_i, pairs_j, fs: float, c,
            max_lag: Optional[int] = None,
            pre_windowed: bool = False) -> torch.Tensor:
    """SRP value for each candidate point: corr (..., P, nfft) circular
    correlations (or, with ``pre_windowed``, the centred (..., P, 2L+1)
    windows of ``_center_window``), points (..., G, 3) -> (..., G).
    Fractional expected lags are interpolated linearly between
    neighbouring correlation samples.

    With ``max_lag`` L (a bound on |expected lag| in samples) the
    correlation is read on its centred +-L window, where the JAX package
    sums the hat kernel max(0, 1 - |idx - ell|) over all 2L+1 window
    samples; only ell = floor(idx) and floor(idx) + 1 carry weight, so this
    is the same sum read as two taps (a tap outside the window weighs
    zero, as there).  Without ``max_lag`` the circular gather runs."""
    nfft = corr.shape[-1]
    if max_lag is not None and max_lag < 1:
        raise ValueError("max_lag must be >= 1 (or None for the gather path)")
    lag = _expected_lags(points, mic_positions, pairs_i, pairs_j, fs, c)
    lag0 = torch.floor(lag)
    frac = lag - lag0
    if max_lag is not None and (pre_windowed or 2 * max_lag + 1 <= nfft):
        if pre_windowed:
            if corr.shape[-1] != 2 * max_lag + 1:
                raise ValueError("pre_windowed corr must have length "
                                 "2*max_lag+1")
            win = corr
        else:
            win = _center_window(corr, max_lag)
        width = 2 * max_lag + 1
        i0 = lag0.to(torch.long) + max_lag                    # window coords
        i1 = i0 + 1
        ok0 = (i0 >= 0) & (i0 < width)
        ok1 = (i1 >= 0) & (i1 < width)
        zero = torch.zeros_like(frac)
        v0 = _gather_lags(win, torch.clamp(i0, 0, width - 1))
        v1 = _gather_lags(win, torch.clamp(i1, 0, width - 1))
        return torch.sum(torch.where(ok0, v0 * (1.0 - frac), zero)
                         + torch.where(ok1, v1 * frac, zero), -1)
    i0 = torch.remainder(lag0.to(torch.long), nfft)
    i1 = torch.remainder(i0 + 1, nfft)
    v0 = _gather_lags(corr, i0)
    v1 = _gather_lags(corr, i1)
    return torch.sum(v0 * (1.0 - frac) + v1 * frac, -1)


def max_pool_corr(corr: torch.Tensor, w: int) -> torch.Tensor:
    """Circular sliding maximum of width 2w+1 along the last axis: coarse
    cells straddle the 1-2-sample-wide whitened peaks, so the coarse stage
    reads the correlation pooled to a cell's lag footprint."""
    pooled = corr
    for s in range(1, max(0, w) + 1):
        pooled = torch.maximum(pooled, torch.maximum(
            torch.roll(corr, s, dims=-1), torch.roll(corr, -s, dims=-1)))
    return pooled


def _center_window(corr: torch.Tensor, half: int) -> torch.Tensor:
    """Centred +-half lag slice of a circular correlation (lag 0 mid)."""
    return torch.cat([corr[..., corr.shape[-1] - half:],
                      corr[..., :half + 1]], -1)


def _pooled_window(corr: torch.Tensor, ml: int, w: int) -> torch.Tensor:
    """Centred +-ml slice of ``max_pool_corr(corr, w)``, pooled on the
    +-(ml + w) slice only (its circular rolls reach no further than w
    into the trimmed ends)."""
    if w <= 0:
        return _center_window(corr, ml)
    sl = _center_window(corr, ml + w)
    return max_pool_corr(sl, w)[..., w:-w]


def _resolve_max_lag(max_lag_samples, mic_positions, fs, c) -> int:
    """|lag| bound (samples) for the windowed map, with 2 samples of
    margin: the given bound, else the mic-array diameter over c (any
    point's |tau| is at most its pair's mic distance over c).  With a
    scene axis the widest array counts."""
    if max_lag_samples is not None:
        return int(max_lag_samples) + 2
    mics = torch.as_tensor(mic_positions).detach().cpu().double().numpy()
    mics = mics.reshape((-1,) + mics.shape[-2:])
    diam = float(np.max(np.linalg.norm(
        mics[:, :, None, :] - mics[:, None, :, :], axis=-1)))
    return int(np.ceil(diam * fs / float(c))) + 2


def _resolve_pool(pool_samples, lower, upper, coarse_n, fs, c) -> int:
    """Max-pool half-width: the given one, else a coarse cell's covering
    radius (0.866 of its widest edge) in samples of travel time."""
    if pool_samples is not None:
        return int(pool_samples)
    extent = np.asarray(torch.as_tensor(upper).detach().cpu(), float) \
        - np.asarray(torch.as_tensor(lower).detach().cpu(), float)
    cell = float(np.max(extent)) / coarse_n
    return max(1, int(np.ceil(0.866 * cell * fs / float(c))))


def _box(lower, upper, like: torch.Tensor):
    return (torch.as_tensor(lower, dtype=like.dtype, device=like.device),
            torch.as_tensor(upper, dtype=like.dtype, device=like.device))


def _map_fns(corr, mic_positions, pairs_i, pairs_j, fs, c, w, ml):
    """(coarse_fn, fine_fn, raw correlation source) of one search: the
    coarse map reads the pooled correlation, the fine map the raw one,
    both on the centred window when it fits the transform."""
    windowed = 2 * (ml + w) + 1 <= corr.shape[-1]
    if windowed:
        coarse_src = _pooled_window(corr, ml, w)
        fine_src = _center_window(corr, ml)
    else:
        coarse_src, fine_src = max_pool_corr(corr, w), corr

    def coarse_fn(p):
        return srp_map(coarse_src, p, mic_positions, pairs_i, pairs_j, fs, c,
                       max_lag=ml, pre_windowed=windowed)

    def fine_fn(p):
        return srp_map(fine_src, p, mic_positions, pairs_i, pairs_j, fs, c,
                       max_lag=ml, pre_windowed=windowed)

    return coarse_fn, fine_fn


def srp_phat_locate(corr: torch.Tensor, mic_positions: torch.Tensor,
                    pairs_i, pairs_j, fs: float, c, lower, upper,
                    coarse_n: int = COARSE_N, fine_n: int = 12,
                    refine: bool = True,
                    pool_samples: Optional[int] = None,
                    max_lag_samples: Optional[int] = None) -> SrpResult:
    """Two-stage SRP-PHAT grid search over the box [lower, upper]: a
    coarse_n^3 lattice on the max-pooled correlation, a fine_n^3 lattice
    over +-1.5 coarse cells around its peak on the raw correlation, then
    (``refine``) a per-axis quadratic fit through the fine peak and its
    neighbours one fine step away, clipped to the box.  corr (..., P,
    nfft), mic_positions (..., M, 3)."""
    lower, upper = _box(lower, upper, corr)
    w = _resolve_pool(pool_samples, lower, upper, coarse_n, fs, c)
    ml = _resolve_max_lag(max_lag_samples, mic_positions, fs, c)
    return _srp_locate(corr, mic_positions, pairs_i, pairs_j, fs, c, lower,
                       upper, coarse_n, fine_n, refine, w, ml)


def _srp_locate(corr, mic_positions, pairs_i, pairs_j, fs, c, lower, upper,
                coarse_n, fine_n, refine, w, ml) -> SrpResult:
    coarse_fn, fine_fn = _map_fns(corr, mic_positions, pairs_i, pairs_j, fs,
                                  c, w, ml)
    pos, power, center, cell = two_stage_search(coarse_fn, fine_fn, lower,
                                                upper, coarse_n, fine_n)
    if refine:
        pos, power = axis_refine(fine_fn, pos, cell, fine_n, lower, upper)
    return SrpResult(pos, power, center)


def axis_refine(fine_fn, pos: torch.Tensor, cell: torch.Tensor, fine_n: int,
                lower: torch.Tensor, upper: torch.Tensor):
    """Per-axis quadratic fit through (pos - h, pos, pos + h), h one fine
    step, axis by axis (steps clamped to one h), then clipped to the box;
    returns (position, its fine-map value)."""
    h = 3.0 * cell / fine_n
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    for d in range(3):
        step = (h[..., d:d + 1] * eye[d])[..., None, :]       # (..., 1, 3)
        probe = pos[..., None, :] + torch.cat([-step, 0.0 * step, step], -2)
        vm, v0, vp = fine_fn(probe).unbind(-1)
        denom = vm - 2.0 * v0 + vp
        delta = torch.where(
            torch.abs(denom) > 1e-12,
            0.5 * (vm - vp) / torch.where(denom == 0, torch.ones_like(denom),
                                          denom),
            torch.zeros_like(denom))
        delta = torch.clamp(delta, -1.0, 1.0) * h[..., d]
        pos = pos + delta[..., None] * eye[d]
    pos = torch.minimum(torch.maximum(pos, lower), upper)
    return pos, fine_fn(pos[..., None, :])[..., 0]


def srp_phat_locate_multi(corr: torch.Tensor, mic_positions: torch.Tensor,
                          pairs_i, pairs_j, fs: float, c, lower, upper,
                          num_sources: int, coarse_n: int = COARSE_N,
                          fine_n: int = 12,
                          min_separation: Optional[float] = None,
                          pool_samples: Optional[int] = None,
                          max_lag_samples: Optional[int] = None,
                          suppression: str = "spatial",
                          claim_lags: float = 4.0) -> MultiSrpResult:
    """Localize up to ``num_sources`` simultaneous sources.

    ``suppression='spatial'``: one coarse map, iterative argmax with a
    ``min_separation`` ball (default three coarse cells) suppressed around
    each peak, then the single-source fine stage around each peak; entries
    in coarse extraction order, powers from the fine stage, positions
    clipped to the box.  ``suppression='claim'``: K full single-source
    searches; after each, +-``claim_lags`` samples around the found
    position's lag are zeroed on every pair (circular distance) before the
    next search, which removes the mixed-pair ghosts a spatial ball cannot
    (see the JAX package's docstring)."""
    if suppression not in ("spatial", "claim"):
        raise ValueError("suppression must be 'spatial' or 'claim'")
    lower, upper = _box(lower, upper, corr)
    ml = _resolve_max_lag(max_lag_samples, mic_positions, fs, c)
    w = _resolve_pool(pool_samples, lower, upper, coarse_n, fs, c)
    if suppression == "spatial":
        coarse_fn, fine_fn = _map_fns(corr, mic_positions, pairs_i, pairs_j,
                                      fs, c, w, ml)
        positions, powers = suppressed_multi_search(
            coarse_fn, fine_fn, lower, upper, coarse_n, fine_n, num_sources,
            min_separation)
        return MultiSrpResult(positions, powers)
    nfft = corr.shape[-1]
    lag_np = np.arange(nfft)
    lag_axis = torch.as_tensor(np.where(lag_np <= nfft // 2, lag_np,
                                        lag_np - nfft), dtype=corr.dtype,
                               device=corr.device)
    pi = torch.as_tensor(np.asarray(pairs_i), dtype=torch.long,
                         device=corr.device)
    pj = torch.as_tensor(np.asarray(pairs_j), dtype=torch.long,
                         device=corr.device)
    mics = torch.as_tensor(mic_positions, dtype=corr.dtype,
                           device=corr.device)
    cur = corr
    positions, powers = [], []
    for _ in range(num_sources):
        res = _srp_locate(cur, mic_positions, pairs_i, pairs_j, fs, c, lower,
                          upper, coarse_n, fine_n, True, w, ml)
        d = torch.linalg.norm(res.position[..., None, :] - mics, dim=-1)
        lag_p = (d[..., pi] - d[..., pj]) * fs / c
        diff = torch.remainder(lag_axis - lag_p[..., None] + nfft / 2.0,
                               float(nfft)) - nfft / 2.0  # circular distance
        cur = cur * (torch.abs(diff) > claim_lags).to(corr.dtype)
        positions.append(res.position)
        powers.append(res.power)
    return MultiSrpResult(torch.stack(positions, -2), torch.stack(powers, -1))


def lm_polish(srp: SrpResult, mic_positions, pairs_i, pairs_j, tdoas, c,
              weights, cell: float):
    """'srp+lm': LM on the measured TDOAs from the SRP fix, kept only
    where it lands within ``cell`` (a coarse cell's diagonal) of it —
    reflection peaks can corrupt the TDOAs, and an unconstrained LM walks
    far from the SRP optimum.  Returns (position, cost): the LM cost where
    the polish is kept, the negated SRP power where it is not."""
    lower, upper = solver_ops.dynamic_bounds(mic_positions, tdoas, c)
    lm = solver_ops.lm_solve(srp.position, mic_positions, pairs_i, pairs_j,
                             tdoas, c, weights, lower, upper)
    near = torch.linalg.norm(lm.x - srp.position, dim=-1) <= cell
    return (torch.where(near[..., None], lm.x, srp.position),
            torch.where(near, lm.cost, -srp.power))

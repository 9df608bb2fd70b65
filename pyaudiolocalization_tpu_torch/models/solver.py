"""TDOA source-position solver: weighted residuals with the closed-form
Jacobian, clustered initial guesses, bounds, and a bounded multi-start
Levenberg-Marquardt (counterpart of the JAX package's models/solver.py;
reference: utils.py:304-405, main.py:261-274).

Restarts are a batch dimension: every guess iterates in lock-step and a
finished restart keeps its state.  Scenes are another: mic positions
(B, M, 3) with TDOAs (B, P) solve B independent problems in the same
lock-step loop (the JAX package's ``vmap`` over scenes written out), which
stops when every start of every scene is done; unbatched calls run the
same code with B = 1.  The differential-evolution fallback, the robust LM
and L-BFGS-B belong to later slices.

Sign convention: r = (||x - mic_j|| - ||x - mic_i||) - c * td
(utils.py:398-404); physical mode feeds td = -(peak lag)/fs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import cluster as cluster_ops


def _index(idx: Sequence[int], device) -> torch.Tensor:
    return torch.as_tensor(list(idx), dtype=torch.long, device=device)


def tdoa_residuals(x: torch.Tensor, mic_positions: torch.Tensor,
                   pairs_i: Sequence[int], pairs_j: Sequence[int],
                   tdoas: torch.Tensor, c, weights: torch.Tensor
                   ) -> torch.Tensor:
    """r_p = w_p * ((d_j - d_i) - c * td_p); x (..., 3) -> (..., P)."""
    d = torch.linalg.norm(x[..., None, :] - mic_positions, dim=-1)
    pi = _index(pairs_i, x.device)
    pj = _index(pairs_j, x.device)
    return weights * ((d[..., pj] - d[..., pi]) - c * tdoas)


def tdoa_residuals_and_jac(x, mic_positions, pairs_i, pairs_j, tdoas, c,
                           weights):
    """Residuals (..., P) and the closed-form Jacobian (..., P, 3):
    dr/dx = w * ((x - mic_j)/d_j - (x - mic_i)/d_i)."""
    diff = x[..., None, :] - mic_positions                    # (..., M, 3)
    d = torch.linalg.norm(diff, dim=-1)
    unit = diff / torch.clamp(d, min=1e-12)[..., None]
    pi = _index(pairs_i, x.device)
    pj = _index(pairs_j, x.device)
    r = weights * ((d[..., pj] - d[..., pi]) - c * tdoas)
    jac = weights[..., None] * (unit[..., pj, :] - unit[..., pi, :])
    return r, jac


def pair_guesses(mic_positions: torch.Tensor, pairs_i, pairs_j,
                 tdoas: torch.Tensor, c
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hyperbola-midpoint guess per pair (utils.py:321-334): from the pair
    midpoint, step (c|td|)/2 along -(mic_j - mic_i) when td > 0, else +.
    mics (..., M, 3), tdoas (..., P) -> (guesses (..., P, 3), valid
    (..., P)); coincident mics are masked."""
    mi = mic_positions[..., _index(pairs_i, mic_positions.device), :]
    mj = mic_positions[..., _index(pairs_j, mic_positions.device), :]
    direction = mj - mi
    norm = torch.linalg.norm(direction, dim=-1)
    valid = norm > 0
    unit = direction / torch.where(valid, norm,
                                   torch.ones_like(norm))[..., None]
    midpoint = (mi + mj) / 2.0
    offset = (c * torch.abs(tdoas)) / 2.0
    sign = torch.where(tdoas > 0, -1.0, 1.0).to(tdoas.dtype)
    return midpoint + sign[..., None] * offset[..., None] * unit, valid


def heuristic_initial_guesses(mic_positions: torch.Tensor, pairs_i, pairs_j,
                              tdoas: torch.Tensor, c,
                              generator: Optional[torch.Generator] = None,
                              clustering_method: str = "kmeans",
                              max_clusters: int = 5,
                              seed_indices: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clustered initial guesses + the mic centroid
    (heuristic_initialization_adaptive, utils.py:304-362): k-means for every
    k = 1..max_clusters, the silhouette-selected k (strict improvement,
    utils.py:273-302), then the centroid unless already present.  mics
    (..., M, 3), tdoas (..., P), seed_indices (..., max_clusters) ->
    (guesses (..., max_clusters + 1, 3), valid); invalid rows hold the
    centroid."""
    if clustering_method != "kmeans":
        raise NotImplementedError(
            f"clustering_method={clustering_method!r} is not ported yet; "
            "DBSCAN follows in a later slice")
    if mic_positions.dim() == 2:
        g, v = heuristic_initial_guesses(
            mic_positions[None], pairs_i, pairs_j, tdoas[None], c, generator,
            clustering_method, max_clusters,
            None if seed_indices is None
            else torch.as_tensor(seed_indices)[None])
        return g[0], v[0]
    dev = mic_positions.device
    batch = mic_positions.shape[0]
    rows = torch.arange(batch, device=dev)
    centroid = torch.mean(mic_positions, 1)                      # (B, 3)
    points, pvalid = pair_guesses(mic_positions, pairs_i, pairs_j, tdoas, c)
    n = points.shape[1]
    n_valid = torch.sum(pvalid, 1)
    km = cluster_ops.kmeans_multi(points, max_clusters, generator, iters=10,
                                  valid=pvalid, seed_indices=seed_indices)
    scores = torch.stack([
        cluster_ops.silhouette_score(points, km.labels[:, v], max_clusters,
                                     pvalid)
        for v in range(max_clusters)], 1)                        # (B, K)
    best_k = torch.ones(batch, dtype=torch.long, device=dev)
    best_score = torch.full((batch,), -1.0, dtype=points.dtype, device=dev)
    for k in range(2, min(max_clusters, n) + 1):
        better = (k <= n_valid) & (scores[:, k - 1] > best_score)
        best_k = torch.where(better, k, best_k)
        best_score = torch.where(better, scores[:, k - 1], best_score)
    num = torch.where(n_valid < 2, 1, best_k)
    k_cols = torch.arange(max_clusters, device=dev)
    stacked_valid = k_cols[None, :] <= k_cols[:, None]
    stacked = torch.where(stacked_valid[None, :, :, None], km.centers,
                          centroid[:, None, None, :])
    sel = torch.clamp(num - 1, 0, max_clusters - 1)
    guesses = stacked[rows, sel]                                 # (B, K, 3)
    gvalid = stacked_valid[sel]                                  # (B, K)

    # No valid pair guesses at all -> centroid only (utils.py:316-317).
    any_pairs = torch.any(pvalid, 1)
    guesses = torch.where(any_pairs[:, None, None], guesses,
                          centroid[:, None, :].expand_as(guesses))
    gvalid = torch.where(any_pairs[:, None], gvalid, (k_cols < 1)[None])

    # Always append the centroid unless already present (utils.py:358-361).
    present = torch.any(gvalid & torch.all(
        torch.abs(guesses - centroid[:, None, :]) <= 1e-6, -1), 1)
    guesses = torch.cat([guesses, centroid[:, None, :]], 1)
    gvalid = torch.cat([gvalid, ~present[:, None]], 1)
    guesses = torch.where(gvalid[..., None], guesses, centroid[:, None, :])
    return guesses, gvalid


def dynamic_bounds(mic_positions: torch.Tensor, tdoas: torch.Tensor, c,
                   buffer: float = 5.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extended per-axis box (dynamic_bounds_extended, utils.py:364-382):
    mic min/max -/+ (buffer + max(75th pct of c|td|, 1.0)); the percentile
    runs over the pair axis, mics (..., M, 3), tdoas (..., P) -> (..., 3)."""
    margin_extra = torch.quantile(c * torch.abs(tdoas), 0.75, dim=-1)
    margin = (buffer + torch.clamp(margin_extra, min=1.0))[..., None]
    lower = torch.amin(mic_positions, -2) - margin
    upper = torch.amax(mic_positions, -2) + margin
    return lower, upper


class LMResult(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor


def _solve3(a_mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 solve (Cramer via cofactors)."""
    a, b, c = a_mat[..., 0, 0], a_mat[..., 0, 1], a_mat[..., 0, 2]
    d, e, f = a_mat[..., 1, 0], a_mat[..., 1, 1], a_mat[..., 1, 2]
    g, h, i = a_mat[..., 2, 0], a_mat[..., 2, 1], a_mat[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    x0 = co_a * rhs[..., 0] + (c * h - b * i) * rhs[..., 1] \
        + (b * f - c * e) * rhs[..., 2]
    x1 = co_b * rhs[..., 0] + (a * i - c * g) * rhs[..., 1] \
        + (c * d - a * f) * rhs[..., 2]
    x2 = co_c * rhs[..., 0] + (b * g - a * h) * rhs[..., 1] \
        + (a * e - b * d) * rhs[..., 2]
    return torch.stack([x0, x1, x2], -1) / det[..., None]


def lm_solve(x0: torch.Tensor, mic_positions, pairs_i, pairs_j, tdoas, c,
             weights, lower, upper, iters: int = 60, lam0: float = 1e-3,
             ftol: float = 1e-6, xtol: float = 1e-6,
             gtol: float = 1e-6) -> LMResult:
    """Projected Levenberg-Marquardt on the weighted TDOA system for a batch
    of starts x0 (..., 3); cost = 0.5 * sum(r^2) (scipy's convention).
    Stops a start on scipy's least_squares rules (ftol/xtol/gtol = 1e-6,
    main.py:262-273), when damping piles up, or after ``iters`` steps."""

    def cost_fn(x):
        r = tdoa_residuals(x, mic_positions, pairs_i, pairs_j, tdoas, c,
                           weights)
        return 0.5 * torch.sum(r * r, -1)

    x = torch.clamp(x0, lower, upper)
    lam = torch.full(x.shape[:-1], lam0, dtype=x.dtype, device=x.device)
    cost = cost_fn(x)
    done = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        r, jac = tdoa_residuals_and_jac(x, mic_positions, pairs_i, pairs_j,
                                        tdoas, c, weights)
        jtj = jac.transpose(-1, -2) @ jac
        jtr = (jac.transpose(-1, -2) @ r[..., None])[..., 0]
        diag = torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=1e-12)
        a_mat = jtj + lam[..., None, None] * (diag[..., None, :] * eye)
        delta = _solve3(a_mat, -jtr)
        x_new = torch.clamp(x + delta, lower, upper)
        new_cost = cost_fn(x_new)
        accept = new_cost < cost
        step = torch.linalg.norm(x_new - x, dim=-1)
        conv_f = accept & ((cost - new_cost) <= ftol * cost)
        conv_x = accept & (step <= xtol * (xtol + torch.linalg.norm(x,
                                                                     dim=-1)))
        conv_g = torch.amax(torch.abs(jtr), -1) <= gtol
        stuck = lam >= 1e12
        live = ~done
        take = live & accept
        x = torch.where(take[..., None], x_new, x)
        cost = torch.where(take, new_cost, cost)
        lam = torch.where(live, torch.where(
            accept, torch.clamp(lam / 3.0, min=1e-12),
            torch.clamp(lam * 2.0, max=1e12)), lam)
        done = done | conv_f | conv_x | conv_g | stuck
        if bool(torch.all(done)):
            break
    return LMResult(x, cost)


def multi_start_lm(guesses: torch.Tensor, mic_positions, pairs_i, pairs_j,
                   tdoas, c, weights, lower, upper,
                   iters: int = 60) -> LMResult:
    """All restarts at once + argmin-cost selection (the reference's restart
    loop, main.py:261-274); a NaN cost loses.  guesses (G, 3) with mics
    (M, 3), or (B, G, 3) with mics (B, M, 3), tdoas / weights (B, P) and
    bounds (B, 3) -> x (..., 3), cost (...)."""
    batched = guesses.dim() == 3
    if batched:
        mic_positions, tdoas, weights, lower, upper = (
            t[:, None] for t in (mic_positions, tdoas, weights, lower,
                                 upper))
    res = lm_solve(guesses, mic_positions, pairs_i, pairs_j, tdoas, c,
                   weights, lower, upper, iters)
    cost = torch.where(torch.isnan(res.cost),
                       torch.full_like(res.cost, float("inf")), res.cost)
    best = torch.argmin(cost, -1)
    if not batched:
        return LMResult(res.x[best], cost[best])
    rows = torch.arange(guesses.shape[0], device=guesses.device)
    return LMResult(res.x[rows, best], cost[rows, best])

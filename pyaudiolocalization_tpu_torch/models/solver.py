"""TDOA source-position solver: weighted residuals with the closed-form
Jacobian, clustered initial guesses, bounds, and a bounded multi-start
Levenberg-Marquardt (counterpart of the JAX package's models/solver.py;
reference: utils.py:304-405, main.py:261-274).

Restarts are a batch dimension: every guess iterates in lock-step and a
finished restart keeps its state.  Scenes are another: mic positions
(B, M, 3) with TDOAs (B, P) solve B independent problems in the same
lock-step loop (the JAX package's ``vmap`` over scenes written out), which
stops when every start of every scene is done; unbatched calls run the
same code with B = 1.  The outlier-robust LM solves its leave-k-out pair
subsets as one more such axis.  The fallback for a failed LM — the
differential evolution with its L-BFGS-B polish (gradients from
``torch.autograd``) — is host-paced, like scipy's, for one problem; the
sweep's 'de' solver runs their batched forms (``differential_evolution_
batched``, ``lbfgsb_minimize_batched``), one problem a scene, in which a
converged scene freezes exactly where the JAX package's vmapped
``while_loop`` freezes it.

Sign convention: r = (||x - mic_j|| - ||x - mic_i||) - c * td
(utils.py:398-404); physical mode feeds td = -(peak lag)/fs.
"""

from __future__ import annotations

import itertools
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.quantile import median_nonneg
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


def optimal_cluster_count(points: torch.Tensor, valid: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          max_clusters: int = 5, method: str = "kmeans",
                          eps: float = 0.001, min_samples: int = 2,
                          seed_indices: Optional[Mapping[int, Sequence[int]]]
                          = None) -> int:
    """Silhouette-selected cluster count (utils.py:273-302) of (n, d)
    points.  'kmeans': k-means (25 Lloyd iterations) for each k in
    2..min(max_clusters, n) with its own k-means++ seeds from
    ``generator`` (or ``seed_indices[k]``, the k seed indices), the best
    score by strict improvement, 1 below two valid points; 'dbscan': its
    cluster count when its silhouette over clustered points is positive,
    else 1."""
    if method not in ("kmeans", "dbscan"):
        raise ValueError("Unknown clustering method. Use 'kmeans' or "
                         "'dbscan'.")
    n = points.shape[0]
    n_valid = int(torch.sum(valid))
    if method == "dbscan":
        res = cluster_ops.dbscan(points, eps, min_samples, valid)
        in_cluster = (res.labels >= 0) & valid
        score = cluster_ops.silhouette_score(
            points, torch.clamp(res.labels, min=0), n, in_cluster)
        enough = int(torch.sum(in_cluster)) >= 2
        return int(res.num_clusters) if enough and float(score) > 0 else 1
    best_k, best_score = 1, -1.0
    for k in range(2, min(max_clusters, n) + 1):
        km = cluster_ops.kmeans(
            points, k, generator, valid=valid,
            seed_indices=None if seed_indices is None else seed_indices[k])
        score = float(cluster_ops.silhouette_score(points, km.labels, k,
                                                   valid))
        if k <= n_valid and score > best_score:
            best_k, best_score = k, score
    return 1 if n_valid < 2 else best_k

def heuristic_initial_guesses(mic_positions: torch.Tensor, pairs_i, pairs_j,
                              tdoas: torch.Tensor, c,
                              generator: Optional[torch.Generator] = None,
                              clustering_method: str = "kmeans",
                              max_clusters: int = 5,
                              seed_indices: Optional[torch.Tensor] = None,
                              eps: float = 0.001, min_samples: int = 2
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clustered initial guesses + the mic centroid
    (heuristic_initialization_adaptive, utils.py:304-362).  'kmeans':
    k-means for every k = 1..max_clusters and the silhouette-selected k
    (strict improvement, utils.py:273-302), G = max_clusters rows;
    'dbscan' (``eps``, ``min_samples``): the mean of each cluster, G = P
    rows; any other method: the centroid alone (utils.py:355-356).  Then
    the centroid unless already present.  mics (..., M, 3), tdoas (..., P),
    seed_indices (..., max_clusters) -> (guesses (..., G + 1, 3), valid);
    invalid rows hold the centroid."""
    if mic_positions.dim() == 2:
        g, v = heuristic_initial_guesses(
            mic_positions[None], pairs_i, pairs_j, tdoas[None], c, generator,
            clustering_method, max_clusters,
            None if seed_indices is None
            else torch.as_tensor(seed_indices)[None], eps, min_samples)
        return g[0], v[0]
    dev = mic_positions.device
    batch = mic_positions.shape[0]
    centroid = torch.mean(mic_positions, 1)                      # (B, 3)
    points, pvalid = pair_guesses(mic_positions, pairs_i, pairs_j, tdoas, c)
    if clustering_method == "kmeans":
        guesses, gvalid = _kmeans_guesses(points, pvalid, centroid,
                                          generator, max_clusters,
                                          seed_indices)
    elif clustering_method == "dbscan":
        res = cluster_ops.dbscan(points, eps, min_samples, pvalid)
        ids = torch.arange(points.shape[1], device=dev)
        onehot = ((res.labels[..., None] == ids) & (res.labels >= 0)[..., None]
                  & pvalid[..., None])                           # (B, P, P)
        counts = torch.sum(onehot, 1)                            # (B, P)
        sums = onehot.transpose(1, 2).to(points.dtype) @ points  # (B, P, 3)
        gvalid = counts > 0
        means = sums / torch.clamp(counts, min=1)[..., None]
        guesses = torch.where(gvalid[..., None], means, centroid[:, None, :])
    else:
        guesses = centroid[:, None, :]
        gvalid = torch.ones((batch, 1), dtype=torch.bool, device=dev)

    # No valid pair guesses at all -> centroid only (utils.py:316-317).
    any_pairs = torch.any(pvalid, 1)
    guesses = torch.where(any_pairs[:, None, None], guesses,
                          centroid[:, None, :].expand_as(guesses))
    first = torch.arange(guesses.shape[1], device=dev) < 1
    gvalid = torch.where(any_pairs[:, None], gvalid, first[None])

    # Always append the centroid unless already present (utils.py:358-361).
    present = torch.any(gvalid & torch.all(
        torch.abs(guesses - centroid[:, None, :]) <= 1e-6, -1), 1)
    guesses = torch.cat([guesses, centroid[:, None, :]], 1)
    gvalid = torch.cat([gvalid, ~present[:, None]], 1)
    guesses = torch.where(gvalid[..., None], guesses, centroid[:, None, :])
    return guesses, gvalid


def _kmeans_guesses(points, pvalid, centroid, generator, max_clusters,
                    seed_indices):
    """The silhouette-selected k-means centers per scene, (B, K, 3) with
    their validity (rows past the chosen k hold the centroid)."""
    dev = points.device
    batch, n = points.shape[:2]
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
    rows = torch.arange(batch, device=dev)
    return stacked[rows, sel], stacked_valid[sel]


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


def _take(t: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """t at index idx along ``dim`` (idx has t's shape without ``dim`` and
    without any trailing axes after it)."""
    dim = dim % t.dim()
    index = idx.unsqueeze(dim)
    index = index.reshape(index.shape + (1,) * (t.dim() - index.dim()))
    index = index.expand(t.shape[:dim] + (1,) + t.shape[dim + 1:])
    return torch.gather(t, dim, index).squeeze(dim)


def multi_start_lm(guesses: torch.Tensor, mic_positions, pairs_i, pairs_j,
                   tdoas, c, weights, lower, upper,
                   iters: int = 60) -> LMResult:
    """All restarts at once + argmin-cost selection (the reference's restart
    loop, main.py:261-274); a NaN cost loses.  guesses (G, 3) with mics
    (M, 3), or (..., G, 3) with mics (..., M, 3), tdoas / weights (..., P)
    and bounds (..., 3) -> x (..., 3), cost (...)."""
    if guesses.dim() > 2:
        mic_positions = mic_positions.unsqueeze(-3)
        tdoas, weights, lower, upper = (
            t.unsqueeze(-2) for t in (tdoas, weights, lower, upper))
    res = lm_solve(guesses, mic_positions, pairs_i, pairs_j, tdoas, c,
                   weights, lower, upper, iters)
    cost = torch.where(torch.isnan(res.cost),
                       torch.full_like(res.cost, float("inf")), res.cost)
    best = torch.argmin(cost, -1)
    return LMResult(_take(res.x, best, -2), _take(cost, best, -1))


def multi_start_lm_robust(guesses: torch.Tensor, mic_positions, pairs_i,
                          pairs_j, tdoas, c, weights, lower, upper,
                          iters: int = 60,
                          huber_k: float = 1.345) -> LMResult:
    """Outlier-robust LM (the JAX package's least-median-of-squares
    consensus): every pair subset with k pairs left out (k = 2 for P >= 6,
    1 for P >= 4, else 0) is solved from ``guesses`` (G, 3), the subsets as
    one leading batch axis of the multi-start LM; the fix whose median
    absolute residual over ALL pairs is least wins, and one Huber-weighted
    refit from it (MAD scale floored at 1 mm) gives the answer.  Scenes
    are leading axes as in ``multi_start_lm``: guesses (..., G, 3) with
    mics (..., M, 3), tdoas / weights (..., P) and bounds (..., 3); the
    least-median fix is selected on the device, with no host read."""
    p = len(pairs_i)
    drop = 2 if p >= 6 else (1 if p >= 4 else 0)
    if drop == 0:
        return multi_start_lm(guesses, mic_positions, pairs_i, pairs_j,
                              tdoas, c, weights, lower, upper, iters)
    combos = list(itertools.combinations(range(p), drop))
    masks = np.ones((len(combos), p))
    for row, gone in enumerate(combos):
        masks[row, list(gone)] = 0.0
    lead = guesses.shape[:-2]
    masks = torch.as_tensor(masks, dtype=tdoas.dtype, device=tdoas.device)
    subsets = masks.shape[0]
    masks = masks.reshape((subsets,) + (1,) * len(lead) + (p,))

    def per_subset(t):
        return t[None].expand((subsets,) + tuple(t.shape))

    best = multi_start_lm(per_subset(guesses), per_subset(mic_positions),
                          pairs_i, pairs_j, per_subset(tdoas), c,
                          per_subset(weights) * masks, per_subset(lower),
                          per_subset(upper), iters)              # (S, ..., 3)
    ones = torch.ones_like(tdoas)
    r = torch.abs(tdoa_residuals(best.x, mic_positions, pairs_i, pairs_j,
                                 tdoas, c, ones))                # (S, ..., P)
    med = median_nonneg(r)                                       # (S, ...)
    i = torch.argmin(med, 0)
    x = _take(best.x, i, 0)
    r = torch.abs(tdoa_residuals(x, mic_positions, pairs_i, pairs_j, tdoas,
                                 c, ones))
    s = torch.clamp(_take(med, i, 0) / 0.6745, min=1e-3)[..., None]
    w = weights * torch.clamp(huber_k * s / torch.clamp(r, min=1e-12),
                              max=1.0)
    return multi_start_lm(x[..., None, :], mic_positions, pairs_i, pairs_j,
                          tdoas, c, w, lower, upper, iters)


# ---------------------------------------------------------------------------
# Box-constrained L-BFGS-B (the DE polish: scipy's differential_evolution
# with polish=True refines with L-BFGS-B, main.py:281-292)
# ---------------------------------------------------------------------------

class LBFGSBResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor


def _gradient(objective, x: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(objective(xg), xg)
    return g.detach()


def lbfgsb_minimize(objective, x0: torch.Tensor, lower: torch.Tensor,
                    upper: torch.Tensor, history: int = 10,
                    maxiter: int = 100, pgtol: float = 1e-5,
                    ftol: float = 2.220446049250313e-09) -> LBFGSBResult:
    """Projected L-BFGS for box constraints (the JAX package's
    ``lbfgsb_minimize``): the two-loop recursion over a ring of (s, y)
    pairs with active-set gradient masking, a projected-Armijo
    backtracking search, and scipy's L-BFGS-B stopping rules
    (projected-gradient inf-norm <= pgtol, or relative decrease <= ftol).
    ``objective`` maps (dim,) to a scalar tensor; gradients come from
    ``torch.autograd``.  Host-paced: it serves the rare LM failure."""
    dtype = x0.dtype if x0.is_floating_point() else torch.float32
    x = torch.clamp(x0.to(dtype), lower, upper)
    tiny = torch.finfo(dtype).tiny
    dim = x.shape[0]
    m = history
    s_hist = torch.zeros((m, dim), dtype=dtype, device=x.device)
    y_hist = torch.zeros_like(s_hist)
    rho = [0.0] * m
    head = count = 0

    def proj(v):
        return torch.clamp(v, lower, upper)

    def direction(g):
        q = g.clone()
        alpha = [0.0] * m
        order = [(head - 1 - k) % m for k in range(m)]   # newest -> oldest
        for i in order[:count]:
            alpha[i] = rho[i] * float(torch.dot(s_hist[i], q))
            q = q - alpha[i] * y_hist[i]
        newest = (head - 1) % m
        gamma = 1.0
        if count > 0:
            gamma = float(torch.dot(s_hist[newest], y_hist[newest])) / max(
                float(torch.dot(y_hist[newest], y_hist[newest])), tiny)
        r = gamma * q
        for i in reversed(order[:count]):
            b = rho[i] * float(torch.dot(y_hist[i], r))
            r = r + (alpha[i] - b) * s_hist[i]
        return -r

    def line_search(f, d):
        a = 1.0
        for _ in range(30):
            xa = proj(x + a * d)
            fa = objective(xa).detach()
            drop = float(torch.sum((x - xa) ** 2)) / max(a, tiny)
            if bool(torch.isfinite(fa)) and float(fa) <= float(f) - 1e-4 * drop:
                return True, xa, fa
            a *= 0.5
        return False, x, f

    f = objective(x).detach()
    g = _gradient(objective, x)
    for _ in range(maxiter):
        active = ((x <= lower) & (g > 0)) | ((x >= upper) & (g < 0))
        gm = torch.where(active, torch.zeros_like(g), g)
        d = torch.where(active, torch.zeros_like(g), direction(gm))
        if not float(torch.dot(d, gm)) < 0:
            d = -gm           # curvature is junk: steepest descent
        ok, xn, fn = line_search(f, d)
        gn = _gradient(objective, xn)
        s, y = xn - x, gn - g
        sy = float(torch.dot(s, y))
        if ok and sy > 1e-10 * float(torch.linalg.norm(s)) * float(
                torch.linalg.norm(y)):
            pos = head % m
            s_hist[pos], y_hist[pos] = s, y
            rho[pos] = 1.0 / max(sy, tiny)
            head += 1
            count = min(count + 1, m)
        pg = float(torch.amax(torch.abs(proj(xn - gn) - xn)))
        fdrop = float(f - fn) / max(abs(float(f)), abs(float(fn)), 1.0)
        x, f, g = xn, fn, gn
        if pg <= pgtol or (ok and fdrop <= ftol) or not ok:
            break
    return LBFGSBResult(x, f)


# ---------------------------------------------------------------------------
# Differential evolution (main.py:281-292)
# ---------------------------------------------------------------------------

class DEResult(NamedTuple):
    x: torch.Tensor
    energy: torch.Tensor


def differential_evolution(objective, lower: torch.Tensor,
                           upper: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           popsize: int = 15, maxiter: int = 1000,
                           tol: float = 1e-6,
                           mutation: Tuple[float, float] = (0.5, 1.0),
                           recombination: float = 0.7, polish_fn=None,
                           init: Optional[torch.Tensor] = None) -> DEResult:
    """best1bin DE with dithered mutation and a latin-hypercube start
    (the reference's scipy parameters, main.py:281-292; the JAX package's
    ``differential_evolution``): the (popsize * dim, dim) population lives
    on the device, ``objective`` maps (N, dim) to (N,), every draw comes
    from ``generator``, and the loop stops on scipy's rule std(energies)
    <= 1e-8 + tol * |mean(energies)| or after ``maxiter`` generations.
    ``init`` rows replace the first members; ``polish_fn(x) -> (x, e)``
    refines the best member."""
    dev, dtype = lower.device, lower.dtype
    dim = lower.shape[0]
    pop_n = popsize * dim

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=dev)

    def randint(high, *shape):
        return torch.randint(0, high, shape, generator=generator,
                             device=dev)

    span = upper - lower
    segs = (torch.arange(pop_n, dtype=dtype, device=dev) + rand(dim, pop_n)
            ) / pop_n
    perms = torch.argsort(rand(dim, pop_n), dim=-1)
    pop = lower + torch.gather(segs, 1, perms).T * span      # (pop, dim)
    if init is not None:
        k = min(init.shape[0], pop_n)
        pop[:k] = torch.clamp(init[:k].to(dtype), lower, upper)
    energies = objective(pop)
    members = torch.arange(pop_n, device=dev)
    for _ in range(maxiter):
        if float(torch.std(energies, correction=0)) <= 1e-8 + tol * abs(
                float(torch.mean(energies))):
            break
        best = pop[torch.argmin(energies)]
        f = mutation[0] + (mutation[1] - mutation[0]) * rand()
        r1 = randint(pop_n, pop_n)
        r2 = (r1 + 1 + randint(pop_n - 1, pop_n)) % pop_n
        mutant = torch.clamp(best + f * (pop[r1] - pop[r2]), lower, upper)
        cross = rand(pop_n, dim) < recombination
        cross[members, randint(dim, pop_n)] = True   # at least one dim
        trial = torch.where(cross, mutant, pop)
        trial_e = objective(trial)
        better = trial_e < energies
        pop = torch.where(better[:, None], trial, pop)
        energies = torch.where(better, trial_e, energies)
    i = torch.argmin(energies)
    x, e = pop[i], energies[i]
    if polish_fn is not None:
        x, e = polish_fn(x)
    return DEResult(x, e)


# ---------------------------------------------------------------------------
# Batched forms for the sweep: one problem a scene, every scene in
# lock-step.  Each scene stops on its own rule and then keeps its state,
# as it does under the JAX package's vmap of ``lax.while_loop``.
# ---------------------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, -1)


def lbfgsb_minimize_batched(objective, x0: torch.Tensor, lower: torch.Tensor,
                            upper: torch.Tensor, history: int = 10,
                            maxiter: int = 100, pgtol: float = 1e-5,
                            ftol: float = 2.220446049250313e-09
                            ) -> LBFGSBResult:
    """``lbfgsb_minimize`` for S independent problems: x0, lower and upper
    (S, dim); ``objective`` maps (S, dim) to (S,), row s depending on row s
    alone.  Each problem runs the JAX package's step (the two-loop
    recursion over its own ring of (s, y) pairs, the projected-Armijo
    search of up to 30 halvings, scipy's stopping rules) and keeps its
    state once it stops.  Host-paced: one read a step of whether every
    problem has stopped."""
    dtype = x0.dtype if x0.is_floating_point() else torch.float32
    x = torch.clamp(x0.to(dtype), lower, upper)
    tiny = torch.finfo(dtype).tiny
    batch, dim = x.shape
    m = history
    dev = x.device
    s_hist = torch.zeros((batch, m, dim), dtype=dtype, device=dev)
    y_hist = torch.zeros_like(s_hist)
    rho = torch.zeros((batch, m), dtype=dtype, device=dev)
    head = torch.zeros(batch, dtype=torch.long, device=dev)
    count = torch.zeros(batch, dtype=torch.long, device=dev)
    rows = torch.arange(batch, device=dev)
    slots = torch.arange(m, device=dev)

    def proj(v):
        return torch.clamp(v, lower, upper)

    def gradient(v):
        with torch.enable_grad():
            vg = v.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective(vg).sum(), vg)
        return g.detach()

    def direction(g):
        q = g
        alpha = torch.zeros((batch, m), dtype=dtype, device=dev)
        for k in range(m):                                   # newest -> oldest
            i = (head - 1 - k) % m
            a = torch.where(k < count,
                            rho[rows, i] * _dot(s_hist[rows, i], q),
                            torch.zeros_like(q[:, 0]))
            q = q - a[:, None] * y_hist[rows, i]
            alpha[rows, i] = a
        newest = (head - 1) % m
        gamma = torch.where(
            count > 0,
            _dot(s_hist[rows, newest], y_hist[rows, newest])
            / torch.clamp(_dot(y_hist[rows, newest], y_hist[rows, newest]),
                          min=tiny), torch.ones_like(q[:, 0]))
        r = gamma[:, None] * q
        for k in reversed(range(m)):
            i = (head - 1 - k) % m
            b = torch.where(k < count, rho[rows, i] * _dot(y_hist[rows, i], r),
                            torch.zeros_like(r[:, 0]))
            r = r + (alpha[rows, i] - b)[:, None] * s_hist[rows, i]
        return -r

    def line_search(x, f, d, live):
        a = torch.ones(batch, dtype=dtype, device=dev)
        ok = torch.zeros(batch, dtype=torch.bool, device=dev)
        xn, fn = x, f
        for _ in range(30):
            xa = proj(x + a[:, None] * d)
            fa = objective(xa).detach()
            decrease = fa <= f - 1e-4 * torch.sum((x - xa) ** 2, -1) / \
                torch.clamp(a, min=tiny)
            hit = ~ok & decrease & torch.isfinite(fa)
            xn = torch.where(hit[:, None], xa, xn)
            fn = torch.where(hit, fa, fn)
            ok = ok | hit
            a = torch.where(ok, a, 0.5 * a)
            if bool(torch.all(ok | ~live)):
                break
        return ok, xn, fn

    f = objective(x).detach()
    g = gradient(x)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    for _ in range(maxiter):
        live = ~done
        active = ((x <= lower) & (g > 0)) | ((x >= upper) & (g < 0))
        gm = torch.where(active, torch.zeros_like(g), g)
        d = torch.where(active, torch.zeros_like(g), direction(gm))
        d = torch.where((_dot(d, gm) < 0)[:, None], d, -gm)
        ok, xn, fn = line_search(x, f, d, live)
        gn = gradient(xn)
        s, y = xn - x, gn - g
        sy = _dot(s, y)
        store = live & ok & (sy > 1e-10 * torch.linalg.norm(s, dim=-1)
                             * torch.linalg.norm(y, dim=-1))
        put = store[:, None] & (slots == (head % m)[:, None])  # (S, m)
        s_hist = torch.where(put[..., None], s[:, None], s_hist)
        y_hist = torch.where(put[..., None], y[:, None], y_hist)
        rho = torch.where(put, (1.0 / torch.clamp(sy, min=tiny))[:, None],
                          rho)
        head = torch.where(store, head + 1, head)
        count = torch.where(store, torch.clamp(count + 1, max=m), count)
        pg = torch.amax(torch.abs(proj(xn - gn) - xn), -1)
        fdrop = (f - fn) / torch.clamp(torch.maximum(torch.abs(f),
                                                     torch.abs(fn)), min=1.0)
        x = torch.where(live[:, None], xn, x)
        f = torch.where(live, fn, f)
        g = torch.where(live[:, None], gn, g)
        done = done | (pg <= pgtol) | (ok & (fdrop <= ftol)) | ~ok
        if bool(torch.all(done)):
            break
    return LBFGSBResult(x, f)


def differential_evolution_batched(objective, lower: torch.Tensor,
                                   upper: torch.Tensor,
                                   generator: Optional[torch.Generator] = None,
                                   popsize: int = 15, maxiter: int = 1000,
                                   tol: float = 1e-6,
                                   mutation: Tuple[float, float] = (0.5, 1.0),
                                   recombination: float = 0.7,
                                   polish_fn=None,
                                   init: Optional[torch.Tensor] = None
                                   ) -> DEResult:
    """``differential_evolution`` for S independent problems: bounds
    (S, dim), ``objective`` maps (S, N, dim) to (S, N), ``init`` (S, K,
    dim) seeds each population's first members.  Every scene draws its own
    mutation factor, partners and crossover each generation, and a scene
    whose population meets scipy's rule std(energies) <= 1e-8 + tol *
    |mean(energies)| stops there and keeps its population, exactly as the
    JAX package's vmapped ``while_loop`` freezes it (the rule is checked
    every generation).  Host-paced: one read a generation of whether every
    scene has stopped.  ``polish_fn(x (S, dim)) -> (x, e)`` refines each
    scene's best member."""
    dev, dtype = lower.device, lower.dtype
    batch, dim = lower.shape
    pop_n = popsize * dim

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=dev)

    def randint(high, *shape):
        return torch.randint(0, high, shape, generator=generator,
                             device=dev)

    span = (upper - lower)[:, None, :]
    segs = (torch.arange(pop_n, dtype=dtype, device=dev)
            + rand(batch, dim, pop_n)) / pop_n
    perms = torch.argsort(rand(batch, dim, pop_n), dim=-1)
    pop = lower[:, None, :] + torch.gather(segs, 2, perms).transpose(1, 2) \
        * span                                                # (S, pop, dim)
    if init is not None:
        k = min(init.shape[-2], pop_n)
        pop[:, :k] = torch.clamp(init[:, :k].to(dtype), lower[:, None, :],
                                 upper[:, None, :])
    energies = objective(pop)
    rows = torch.arange(batch, device=dev)[:, None]
    members = torch.arange(pop_n, device=dev)[None, :]
    for _ in range(maxiter):
        live = ~(torch.std(energies, -1, correction=0)
                 <= 1e-8 + tol * torch.abs(torch.mean(energies, -1)))
        if not bool(torch.any(live)):
            break
        best = pop[rows[:, 0], torch.argmin(energies, -1)]     # (S, dim)
        f = mutation[0] + (mutation[1] - mutation[0]) * rand(batch, 1, 1)
        r1 = randint(pop_n, batch, pop_n)
        r2 = (r1 + 1 + randint(pop_n - 1, batch, pop_n)) % pop_n
        mutant = torch.clamp(best[:, None, :] + f * (pop[rows, r1]
                                                     - pop[rows, r2]),
                             lower[:, None, :], upper[:, None, :])
        cross = rand(batch, pop_n, dim) < recombination
        cross[rows, members, randint(dim, batch, pop_n)] = True
        trial = torch.where(cross, mutant, pop)
        trial_e = objective(trial)
        better = live[:, None] & (trial_e < energies)
        pop = torch.where(better[..., None], trial, pop)
        energies = torch.where(better, trial_e, energies)
    i = torch.argmin(energies, -1)
    x, e = pop[rows[:, 0], i], energies[rows[:, 0], i]
    if polish_fn is not None:
        x, e = polish_fn(x)
    return DEResult(x, e)

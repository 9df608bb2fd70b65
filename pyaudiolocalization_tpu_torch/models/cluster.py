"""Clustering for solver initialization (counterpart of the JAX package's
models/cluster.py; reference: utils.py:273-362).

Every function takes an optional leading scene axis: points (B, n, d) are
B independent problems solved in one batched run (the JAX package's
``vmap`` written out); unbatched (n, d) calls run the same code with B = 1.
k-means++ seeding draws from an explicit ``torch.Generator``; callers that
must reproduce another implementation's draws pass the chosen seed indices
instead (``seed_indices``, (k,) or (B, k)).  DBSCAN is deterministic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def _pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    d2 = torch.sum((x[..., :, None, :] - x[..., None, :, :]) ** 2, -1)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _ones_valid(x: torch.Tensor, valid: Optional[torch.Tensor]):
    if valid is None:
        return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    return valid


def silhouette_score(x: torch.Tensor, labels: torch.Tensor,
                     num_clusters: int,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean silhouette over valid samples (sklearn's definition; singleton
    clusters score 0); labels in [0, num_clusters).  x (..., n, d),
    labels / valid (..., n) -> (...)."""
    if x.dim() == 2:
        return silhouette_score(x[None], labels[None], num_clusters,
                                None if valid is None else valid[None])[0]
    valid = _ones_valid(x, valid)
    dist = _pairwise_dist(x)                                      # (B, n, n)
    ks = torch.arange(num_clusters, device=x.device)
    onehot = (labels[..., None] == ks) & valid[..., None]         # (B, n, k)
    counts = torch.sum(onehot, 1)                                 # (B, k)
    sums = dist @ onehot.to(dist.dtype)                           # (B, n, k)
    own_count = torch.gather(counts, 1, labels)
    # a: mean distance to own cluster, excluding self (distance 0).
    a = torch.gather(sums, 2, labels[..., None])[..., 0] / torch.clamp(
        own_count - 1, min=1)
    # b: min over other non-empty clusters of the mean distance.
    mean_other = sums / torch.clamp(counts, min=1)[:, None, :]
    other = (ks != labels[..., None]) & (counts[:, None, :] > 0)
    b = torch.amin(torch.where(other, mean_other,
                               torch.full_like(mean_other, float("inf"))), 2)
    denom_ab = torch.clamp(torch.maximum(a, b), min=1e-30)
    s = torch.where(own_count > 1, (b - a) / denom_ab, torch.zeros_like(a))
    denom = torch.clamp(torch.sum(valid, 1), min=1)
    return torch.sum(torch.where(valid, s, torch.zeros_like(s)), 1) / denom


def kmeanspp_seeds(x: torch.Tensor, k: int,
                   generator: Optional[torch.Generator],
                   valid: torch.Tensor) -> torch.Tensor:
    """k-means++ seed indices (..., k): the first uniform over valid
    points, each next one with probability proportional to its squared
    distance to the nearest seed so far (uniform over valid points when
    every point coincides with a seed).  One draw per step covers every
    scene."""
    if x.dim() == 2:
        return kmeanspp_seeds(x[None], k, generator, valid[None])[0]
    w_valid = valid.to(x.dtype)
    rows = torch.arange(x.shape[0], device=x.device)
    idx = [torch.multinomial(w_valid, 1, generator=generator)[:, 0]]
    for _ in range(1, k):
        centers = x[rows[:, None], torch.stack(idx, 1)]           # (B, j, d)
        d2 = torch.amin(torch.sum((x[:, :, None, :] - centers[:, None]) ** 2,
                                  -1), 2)
        d2 = torch.where(valid, d2, torch.zeros_like(d2))
        probs = torch.where(torch.any(d2 > 0, 1, keepdim=True), d2, w_valid)
        idx.append(torch.multinomial(probs, 1, generator=generator)[:, 0])
    return torch.stack(idx, 1)


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (..., k, d)
    labels: torch.Tensor   # (..., n)
    inertia: torch.Tensor  # (...)


def kmeans(x: torch.Tensor, k: int,
           generator: Optional[torch.Generator] = None, iters: int = 25,
           valid: Optional[torch.Tensor] = None,
           seed_indices: Optional[torch.Tensor] = None) -> KMeansResult:
    """k-means++ seeding + Lloyd iterations over (..., n, d) points;
    ``valid`` masks padding rows out of both seeding and updates."""
    res = kmeans_multi(x, k, generator, iters, valid, seed_indices)
    # Variant k-1 uses every seed; with all centers active the per-variant
    # Lloyd step is plain k-means.
    return KMeansResult(res.centers[..., k - 1, :, :],
                        res.labels[..., k - 1, :], res.inertia[..., k - 1])


class KMeansMultiResult(NamedTuple):
    centers: torch.Tensor  # (..., K, max_k, d); variant j uses rows 0..j
    labels: torch.Tensor   # (..., K, n)
    inertia: torch.Tensor  # (..., K)


def kmeans_multi(x: torch.Tensor, max_k: int,
                 generator: Optional[torch.Generator] = None,
                 iters: int = 10, valid: Optional[torch.Tensor] = None,
                 seed_indices: Optional[torch.Tensor] = None
                 ) -> KMeansMultiResult:
    """k-means for every k = 1..max_k in one batched run: one k-means++
    sequence of max_k seeds initializes every variant (variant j from its
    first j+1 seeds), then ``iters`` Lloyd iterations run over all variants
    (and scenes) at once with per-variant center masks."""
    if x.dim() == 2:
        res = kmeans_multi(x[None], max_k, generator, iters,
                           None if valid is None else valid[None],
                           None if seed_indices is None
                           else torch.as_tensor(seed_indices)[None])
        return KMeansMultiResult(*(t[0] for t in res))
    valid = _ones_valid(x, valid)
    w = valid.to(x.dtype)
    if seed_indices is None:
        seed_indices = kmeanspp_seeds(x, max_k, generator, valid)
    seed_indices = torch.as_tensor(seed_indices, device=x.device)
    rows = torch.arange(x.shape[0], device=x.device)
    seeds = x[rows[:, None], seed_indices]                  # (B, max_k, d)
    k_idx = torch.arange(max_k, device=x.device)
    cmask = k_idx[None, :] <= k_idx[:, None]                # (K, max_k)
    centers = torch.where(cmask[None, :, :, None], seeds[:, None],
                          seeds[:, None, 0:1])              # (B, K, max_k, d)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)

    def assign(centers):
        d2 = torch.sum((x[:, None, :, None, :] - centers[:, :, None, :, :])
                       ** 2, -1)
        return torch.where(cmask[None, :, None, :], d2, inf)  # (B, K, n, k)

    for _ in range(iters):
        labels = torch.argmin(assign(centers), -1)
        onehot = ((labels[..., None] == k_idx).to(x.dtype)
                  * w[:, None, :, None])                     # (B, K, n, k)
        counts = torch.sum(onehot, 2)                        # (B, K, k)
        sums = torch.einsum("bknm,bnd->bkmd", onehot, x)
        new = torch.where(counts[..., None] > 0,
                          sums / torch.clamp(counts, min=1)[..., None],
                          centers)
        centers = torch.where(cmask[None, :, :, None], new, centers)
    d2 = assign(centers)
    labels = torch.argmin(d2, -1)
    inertia = torch.sum(torch.where(valid[:, None, :], torch.amin(d2, -1),
                                    torch.zeros_like(d2[..., 0])), -1)
    return KMeansMultiResult(centers, labels, inertia)


class DbscanResult(NamedTuple):
    labels: torch.Tensor        # (..., n) cluster id, -1 for noise
    num_clusters: torch.Tensor  # (...)


def dbscan(x: torch.Tensor, eps: float, min_samples: int,
           valid: Optional[torch.Tensor] = None) -> DbscanResult:
    """sklearn's DBSCAN cluster structure over (..., n, d) points: core
    points have >= min_samples neighbours within eps (self included),
    clusters are the components of the core eps-graph (n rounds of
    min-label propagation), a border point joins the lowest-labelled
    adjacent core's cluster, noise is -1; labels renumbered by first
    occurrence."""
    if x.dim() == 2:
        res = dbscan(x[None], eps, min_samples,
                     None if valid is None else valid[None])
        return DbscanResult(res.labels[0], res.num_clusters[0])
    n = x.shape[1]
    valid = _ones_valid(x, valid)
    adj = ((_pairwise_dist(x) <= eps) & valid[:, None, :]
           & valid[:, :, None])                                  # (B, n, n)
    core = (torch.sum(adj, -1) >= min_samples) & valid
    idx = torch.arange(n, device=x.device)
    none = torch.full_like(adj, n, dtype=torch.long)
    core_adj = adj & core[:, None, :]
    labels = torch.where(core, idx, n)                           # n = none
    for _ in range(n):
        new = torch.amin(torch.where(core_adj, labels[:, None, :], none), -1)
        labels = torch.where(core, torch.minimum(labels, new), labels)
    border = torch.amin(torch.where(core_adj, labels[:, None, :], none), -1)
    labels = torch.where(core, labels,
                         torch.where(valid & (border < n), border, n))
    is_root = (labels == idx) & (labels < n)
    new_id = torch.cumsum(is_root, -1) - 1
    renum = torch.where(labels < n,
                        torch.gather(new_id, 1, torch.clamp(labels, max=n - 1)),
                        -1)
    return DbscanResult(renum, torch.sum(is_root, -1))

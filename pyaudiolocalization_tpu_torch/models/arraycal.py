"""Array-geometry self-calibration: refine microphone positions from test
events (counterpart of the JAX package's models/arraycal.py; the reference
calibrates per-mic delay offsets only, calibration.py:4-48).

Given K test emissions, the same weighted pair-TDOA residual system that
the localizer solves (utils.py:384-405, roles of source and microphones
swapped) is inverted for the M microphone positions.  The refinement is
Jacobi block Gauss-Newton: every sweep updates every microphone at once
through its 3 x 3 normal equations (``solver._solve3``), with a shared
Levenberg damping that retreats on a cost increase.  The sweeps are a
Python loop of ``torch.where`` updates that reads nothing back to the
host, so that 60 sweeps on the card make no sync.

With unknown event positions (``self_calibrate_array``, M >= 5) the events
are localized as one batch of K problems (the clustered multi-start LM of
models/solver.py) and the mics refined, in turns; then the joint 3(M+K)
system is polished by a damped Gauss-Newton on its closed-form Jacobian,
a fixed 100 iterations whose converged state is frozen by a mask (the JAX
package's ``while_loop`` stops there, so the answers are equal).

``calibrate_array_geometry`` measures the TDOAs first: the all-pairs
GCC-PHAT over the (K, M, N) events, with the events as K1's scene axis at
a power-of-two ``nfft`` (the exact length 2N - 1, the default, takes the
unfused branch), then the physical-lag peak ladder and SNR weights.

Identifiability: each event gives P pair equations of rank <= M - 1; 3M
unknowns need K >= ceil(3M / (M - 1)) events spread in 3-D, and unknown
sources need M >= 5 (a 4-mic array fits every event exactly at any
geometry).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import gccphat
from ..utils.device import as_tensor
from . import solver as solver_ops
from . import tdoa as tdoa_ops

__all__ = ["refine_mic_positions", "calibrate_array_geometry",
           "self_calibrate_array", "GeometryCalResult", "SelfCalResult"]

#: Iterations of the joint polish (the JAX package's while_loop bound).
JOINT_ITERS = 100


class GeometryCalResult(NamedTuple):
    mic_positions: torch.Tensor   # (M, 3) refined coordinates
    cost: torch.Tensor            # final 0.5*sum(r^2) over all events/pairs
    initial_cost: torch.Tensor    # same at the initial geometry
    tdoas: Optional[torch.Tensor] = None   # (K, P) measured TDOAs (wrapper)


class SelfCalResult(NamedTuple):
    mic_positions: torch.Tensor      # (M, 3) refined coordinates
    source_positions: torch.Tensor   # (K, 3) jointly estimated events
    cost: torch.Tensor               # final data cost 0.5*sum(r^2)
    initial_cost: torch.Tensor       # data cost at the surveyed geometry
    tdoas: Optional[torch.Tensor] = None


def _pair_index(pairs_i, pairs_j, device):
    """The pair slots (host sequences) as index tensors on ``device`` and
    as lists (models/solver.py's form)."""
    lists = ([int(v) for v in np.asarray(pairs_i)],
             [int(v) for v in np.asarray(pairs_j)])
    return tuple(torch.as_tensor(v, dtype=torch.long, device=device)
                 for v in lists) + lists


def _residuals(mics, sources, pi, pj, tdoas, c, weights):
    """r[k, p] = w[k, p] * ((d_kj - d_ki) - c * tdoa[k, p]) and the unit
    vectors u[k, m] = (m_m - s_k) / d_km of the per-mic Jacobians."""
    diff = mics[None, :, :] - sources[:, None, :]          # (K, M, 3)
    d = torch.linalg.norm(diff, dim=-1)                    # (K, M)
    u = diff / torch.clamp(d, min=1e-12)[..., None]        # (K, M, 3)
    r = weights * ((d[:, pj] - d[:, pi]) - c * tdoas)      # (K, P)
    return r, u


def refine_mic_positions(tdoas, source_positions, mic_init, pairs_i,
                         pairs_j, c, weights=None, sweeps: int = 60,
                         lam0: float = 1e-2, max_step: float = 0.2,
                         prior_positions=None, prior_weight: float = 0.0,
                         device=None) -> GeometryCalResult:
    """Refine microphone positions from measured pair TDOAs.

    tdoas: (K, P) seconds, td = arrival_j - arrival_i (the localizer's
    residual system: (d_j - d_i) = c * td).  source_positions: (K, 3)
    known emitters.  mic_init: (M, 3) surveyed coordinates, also the
    linearization anchor (the refinement is local: survey errors up to
    ~10 cm).  weights: optional (K, P) residual weights.  ``max_step``
    caps each sweep's move of a mic (meters), a trust region against
    ill-conditioned early sweeps.  ``prior_positions`` / ``prior_weight``
    add the Tikhonov pull prior_weight * (m - prior) a mic (three more
    residuals), which ``self_calibrate_array`` uses to pin the frame.
    Runs on ``tdoas``' device when it is a tensor, else on ``device``."""
    td = as_tensor(tdoas, device=device)
    sources = as_tensor(source_positions, td)
    mics = as_tensor(mic_init, td)
    pi, pj, _, _ = _pair_index(pairs_i, pairs_j, td.device)
    k, p = td.shape
    m = mics.shape[0]
    w = (torch.ones((k, p), dtype=td.dtype, device=td.device)
         if weights is None else as_tensor(weights, td))
    c = as_tensor(c, td)
    # Per-mic pair membership: mic a is pair p's i slot (sign -1 on u_i)
    # or its j slot (+1 on u_j).
    arange = torch.arange(m, device=td.device)[:, None]
    sel_i = (pi[None, :] == arange).to(td.dtype)
    sel_j = (pj[None, :] == arange).to(td.dtype)
    prior = (mics if prior_positions is None
             else as_tensor(prior_positions, td))
    pw = as_tensor(prior_weight, td)
    eye = torch.eye(3, dtype=td.dtype, device=td.device)

    def cost_fn(mm):
        r, _ = _residuals(mm, sources, pi, pj, td, c, w)
        return 0.5 * (torch.sum(r * r) + torch.sum((pw * (mm - prior)) ** 2))

    cost0 = cost_fn(mics)
    cost = cost0
    lam = as_tensor(lam0, td)
    for _ in range(sweeps):
        r, u = _residuals(mics, sources, pi, pj, td, c, w)
        ui, uj = u[:, pi], u[:, pj]                        # (K, P, 3)
        # J[a, k, p, :] = w * (sel_j[a, p] * uj - sel_i[a, p] * ui)
        jac = (sel_j[:, None, :, None] * uj[None]
               - sel_i[:, None, :, None] * ui[None]) * w[None, :, :, None]
        jtj = torch.einsum("akpx,akpy->axy", jac, jac)     # (M, 3, 3)
        jtr = torch.einsum("akpx,kp->ax", jac, r)          # (M, 3)
        # Tikhonov anchor: residuals pw * (m - prior) per coordinate.
        jtj = jtj + (pw * pw) * eye
        jtr = jtr + (pw * pw) * (mics - prior)
        diag = torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=1e-12)
        delta = solver_ops._solve3(jtj + (lam * diag)[..., None] * eye,
                                   -jtr)                   # (M, 3)
        step = torch.linalg.norm(delta, dim=-1, keepdim=True)
        delta = delta * torch.clamp(max_step / torch.clamp(step, min=1e-12),
                                    max=1.0)
        mics_new = mics + delta
        cost_new = cost_fn(mics_new)
        accept = cost_new < cost
        mics = torch.where(accept, mics_new, mics)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-10),
                          torch.clamp(lam * 4.0, max=1e12))
    return GeometryCalResult(mics, cost, cost0)


def _localize_events(mics, td, w, pi, pj, c, generator, seed_indices):
    """Every event's source given the geometry, as one batch of K
    problems: clustered initial guesses, dynamic bounds, multi-start LM
    (the JAX package ``vmap``s one event)."""
    k = td.shape[0]
    mics_b = mics.expand(k, *mics.shape)
    guesses, _ = solver_ops.heuristic_initial_guesses(
        mics_b, pi, pj, td, c, generator, seed_indices=seed_indices)
    lower, upper = solver_ops.dynamic_bounds(mics_b, td, c)
    return solver_ops.multi_start_lm(guesses, mics_b, pi, pj, td, c, w,
                                     lower, upper).x


def joint_jacobian(mics, sources, pi, pj, tdoas, c, weights,
                   anchor_weight):
    """Closed-form Jacobian (K*P + 3M, 3M + 3K) of the joint residual
    vector [r.ravel(), anchor_weight * (mics - mic_init).ravel()] with
    respect to [mics.ravel(), sources.ravel()]: d r[k, p] / d m_a =
    w * (1[a = j] u_kj - 1[a = i] u_ki), d r[k, p] / d s_k = w * (u_ki -
    u_kj), and the anchor's diagonal."""
    k, m = sources.shape[0], mics.shape[0]
    p = pi.shape[0]
    _, u = _residuals(mics, sources, pi, pj, tdoas, c, weights)
    ui, uj = u[:, pi], u[:, pj]                            # (K, P, 3)
    arange = torch.arange(m, device=mics.device)
    sel_i = (pi[:, None] == arange).to(mics.dtype)         # (P, M)
    sel_j = (pj[:, None] == arange).to(mics.dtype)
    wd = weights[..., None, None]
    d_mics = wd * (sel_j[None, :, :, None] * uj[:, :, None, :]
                   - sel_i[None, :, :, None] * ui[:, :, None, :])
    d_src = (weights[..., None] * (ui - uj))[:, :, None, :] \
        * torch.eye(k, dtype=mics.dtype, device=mics.device)[:, None, :,
                                                             None]
    data = torch.cat([d_mics.reshape(k * p, 3 * m),
                      d_src.reshape(k * p, 3 * k)], 1)
    anchor = torch.cat([
        anchor_weight * torch.eye(3 * m, dtype=mics.dtype,
                                  device=mics.device),
        torch.zeros((3 * m, 3 * k), dtype=mics.dtype, device=mics.device)],
        1)
    return torch.cat([data, anchor], 0)


def self_calibrate_array(tdoas, mic_init, pairs_i, pairs_j, c,
                         weights=None, rounds: int = 3,
                         sweeps_per_round: int = 12,
                         anchor_weight: float = 1e-3,
                         generator: Optional[torch.Generator] = None,
                         seed_indices=None, device=None) -> SelfCalResult:
    """Joint array / source self-calibration with UNKNOWN event positions:
    ``rounds`` turns of (a) localizing every event by the clustered
    multi-start LM given the current geometry and (b) refining the mics
    given those events (``sweeps_per_round`` sweeps, anchored), then the
    joint 3(M+K) system polished by a damped Gauss-Newton to data
    precision.

    Gauge: pair TDOAs do not change under a rigid motion of mics and
    sources together, so a weak Tikhonov anchor toward ``mic_init``
    (``anchor_weight``, keep it ~1e-3) pins the frame; the absolute
    positions inherit the rigid part of the survey error, while the
    inter-mic shape is recovered to data precision.  Needs M >= 5 mics and
    K >= (3M - 6) / (M - 4) well-spread events.

    The k-means++ seeds of every event's initial guesses come from
    ``generator`` (default: seeded 0 on the run's device), whose state is
    restored before each localization, so every round and the initial
    cost's localization draw the same stream, as the JAX package's fixed
    event keys do; or, for parity, from ``seed_indices`` (K, 5), indices
    into each event's pair-guess points, used by every localization."""
    td = as_tensor(tdoas, device=device)
    mic0 = as_tensor(mic_init, td)
    if mic0.shape[0] < 5:
        raise ValueError(
            "Unknown-source self-calibration needs >= 5 microphones: with "
            "M mics each event contributes M-1 independent TDOAs and "
            "consumes 3 unknowns for its own position, so a 4-mic array "
            "fits every event exactly at ANY geometry. Survey the event "
            "positions (calibrate_array_geometry with source_positions) "
            "or add microphones.")
    pi, pj, pi_l, pj_l = _pair_index(pairs_i, pairs_j, td.device)
    k, p = td.shape
    m = mic0.shape[0]
    w = (torch.ones((k, p), dtype=td.dtype, device=td.device)
         if weights is None else as_tensor(weights, td))
    c = as_tensor(c, td)
    if seed_indices is not None:
        seed_indices = torch.as_tensor(seed_indices, device=td.device)
    if generator is None:
        generator = torch.Generator(device=td.device).manual_seed(0)
    state = generator.get_state()

    def localize(mics):
        generator.set_state(state)
        return _localize_events(mics, td, w, pi_l, pj_l, c, generator,
                                seed_indices)

    def data_cost(mics, sources):
        r, _ = _residuals(mics, sources, pi, pj, td, c, w)
        return 0.5 * torch.sum(r * r)

    mics, sources = mic0, None
    for _ in range(rounds):
        sources = localize(mics)
        mics = refine_mic_positions(
            td, sources, mics, pi_l, pj_l, c, weights=w,
            sweeps=sweeps_per_round, prior_positions=mic0,
            prior_weight=anchor_weight, device=td.device).mic_positions

    # Alternation converges only linearly (it ignores d(sources)/d(mics)):
    # polish the joint problem by Levenberg-Marquardt, the anchor rows
    # keeping the gauge pinned.
    aw = as_tensor(anchor_weight, td)

    def unpack(x):
        return x[:3 * m].reshape(m, 3), x[3 * m:].reshape(k, 3)

    def resid_vec(x):
        mm, ss = unpack(x)
        r, _ = _residuals(mm, ss, pi, pj, td, c, w)
        return torch.cat([r.reshape(-1), (aw * (mm - mic0)).reshape(-1)])

    def cost_of(x):
        r = resid_vec(x)
        return 0.5 * torch.dot(r, r)

    x = torch.cat([mics.reshape(-1), sources.reshape(-1)])
    lam = as_tensor(1e-3, td)
    cost = cost_of(x)
    done = torch.zeros((), dtype=torch.bool, device=td.device)
    for _ in range(JOINT_ITERS):
        r = resid_vec(x)
        jmat = joint_jacobian(*unpack(x), pi, pj, td, c, w, aw)
        jtj = jmat.T @ jmat
        jtr = jmat.T @ r
        a_mat = jtj + lam * torch.diag(torch.clamp(torch.diagonal(jtj),
                                                   min=1e-12))
        delta = torch.linalg.solve_ex(a_mat, -jtr)[0]
        xn = x + delta
        cn = cost_of(xn)
        accept = cn < cost
        conv = accept & ((cost - cn) <= 1e-12 * (cost + 1e-30))
        live = ~done
        take = live & accept
        x = torch.where(take, xn, x)
        cost = torch.where(take, cn, cost)
        lam = torch.where(live, torch.where(
            accept, torch.clamp(lam / 3.0, min=1e-12),
            torch.clamp(lam * 4.0, max=1e12)), lam)
        done = done | (live & (conv | (lam >= 1e12)))
    mics, sources = unpack(x)
    cost0 = data_cost(mic0, localize(mic0))
    return SelfCalResult(mics, sources, data_cost(mics, sources), cost0)


def calibrate_array_geometry(signals, source_positions, mic_init, fs: float,
                             c, nfft: Optional[int] = None,
                             band: Optional[tuple] = None,
                             max_expected_delay: Optional[float] = None,
                             weight_by_snr: bool = True, sweeps: int = 60,
                             threshold_method: str = "gaussian",
                             generator: Optional[torch.Generator] = None,
                             seed_indices=None, device=None):
    """Measure every event's pair TDOAs with the GCC-PHAT -> peak ladder
    (physical lags), then refine the geometry.

    signals: (K, M, N) recordings of K test events.  source_positions:
    (K, 3) known emitters -> ``refine_mic_positions``
    (``GeometryCalResult``), or ``None`` for joint self-calibration
    (``self_calibrate_array``, with ``generator`` / ``seed_indices``;
    ``SelfCalResult``).  mic_init: (M, 3) surveyed coordinates.  With
    ``weight_by_snr`` each pair residual is weighted by its correlation
    SNR (models/tdoa.compute_weights), as in localization.  At a
    power-of-two ``nfft`` the GCC is one K1 launch with the K events as
    its scene axis; ``nfft=None`` is the exact length 2N - 1, unfused.
    Runs on ``device`` (the card unless named)."""
    x = as_tensor(signals, device=device)
    k, m, n = x.shape
    pairs = np.array([(i, j) for i in range(m) for j in range(i + 1, m)],
                     np.int64)
    pi, pj = pairs[:, 0], pairs[:, 1]
    corr = gccphat.gcc_phat_all_pairs(x, pi, pj, nfft=nfft, band=band,
                                      fs=fs)                 # (K, P, nfft)
    res = tdoa_ops.time_delays_from_corr(
        corr, n, n, fs, num_peaks=1, threshold_method=threshold_method,
        max_expected_delay=max_expected_delay, lag_mode="physical")
    td = -res.delays[..., 0]                                 # (K, P)
    weights = None
    if weight_by_snr:
        weights = tdoa_ops.compute_weights(tdoa_ops.correlation_snr(corr))
    if source_positions is None:
        sc = self_calibrate_array(td, mic_init, pi, pj, c, weights=weights,
                                  generator=generator,
                                  seed_indices=seed_indices,
                                  device=x.device)
        return SelfCalResult(sc.mic_positions, sc.source_positions, sc.cost,
                             sc.initial_cost, tdoas=td)
    out = refine_mic_positions(td, source_positions, mic_init, pi, pj, c,
                               weights=weights, sweeps=sweeps,
                               device=x.device)
    return GeometryCalResult(out.mic_positions, out.cost, out.initial_cost,
                             tdoas=td)

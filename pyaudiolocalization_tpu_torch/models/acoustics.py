"""Acoustic geometry: speed of sound, reflections, attenuation and the
image-source multipath model (counterpart of the JAX package's
models/acoustics.py; reference: utils.py:15-106, materials.py).

The no-immediate-repeat reflection tree for (P planes, order K) is a static
structure enumerated on the host; positions and the acceptance mask are
tensors on the caller's device, computed by a loop over the (small) node
list that keeps the reference's BFS order, dedupe and threshold rules.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


def speed_of_sound(temperature, humidity, pressure: float = 101.325):
    """``speed_of_sound_host`` as tensor arithmetic (temperature and
    humidity: tensors or numbers; the result lies on the temperature's
    device in its dtype, or torch's default dtype for a number)."""
    t = torch.as_tensor(temperature,
                        dtype=(temperature.dtype
                               if isinstance(temperature, torch.Tensor)
                               else torch.get_default_dtype()))
    h = torch.as_tensor(humidity, dtype=t.dtype, device=t.device)
    t = torch.where((t < -50) | (t > 50), torch.full_like(t, 20.0), t)
    h = torch.where((h < 0) | (h > 100), torch.full_like(h, 50.0), h)
    return 331.0 + 0.6 * t + 0.0124 * h + 0.0006 * (pressure - 101.325)

def speed_of_sound_host(temperature: float, humidity: float,
                        pressure: float = 101.325) -> float:
    """331 + 0.6 T + 0.0124 H + 0.0006 (p - 101.325), with the reference's
    out-of-range clamps to 20 degC / 50 % (utils.py:15-27)."""
    t = 20.0 if (temperature < -50 or temperature > 50) else temperature
    h = 50.0 if (humidity < 0 or humidity > 100) else humidity
    return 331.0 + 0.6 * t + 0.0124 * h + 0.0006 * (pressure - 101.325)


def reflect_point_across_plane(point: torch.Tensor,
                               plane: torch.Tensor) -> torch.Tensor:
    """Mirror ``point`` (..., 3) across the plane ax+by+cz+d=0 given as
    (..., 4) (utils.py:29-42)."""
    normal = plane[..., :3]
    d = plane[..., 3]
    denom = torch.sum(normal * normal, -1)
    factor = 2.0 * (torch.sum(normal * point, -1) + d) / denom
    return point - normal * factor[..., None]


def distance(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Euclidean distance over the last axis (utils.py:44-48)."""
    return torch.linalg.norm(p1 - p2, dim=-1)

def calculate_attenuation(dist, material_id, frequency,
                          absorption_table: torch.Tensor,
                          freq_table: torch.Tensor):
    """(1/max(d, 0.1)) * exp(-freq_coeff * f * d) * exp(-absorption * d)
    (utils.py:50-65) with materials as id-indexed tables."""
    d = torch.clamp(dist, min=0.1)
    absorption = absorption_table[material_id]
    fcoeff = freq_table[material_id]
    return (1.0 / d) * torch.exp(-fcoeff * frequency * d) * torch.exp(
        -absorption * d)


def log_attenuation(dist, material_id, frequency,
                    absorption_table: torch.Tensor,
                    freq_table: torch.Tensor):
    """log(calculate_attenuation(...)), exact in float32 where the linear
    form underflows (the reference's default materials give ~exp(-90))."""
    d = torch.clamp(dist, min=0.1)
    absorption = absorption_table[material_id]
    fcoeff = freq_table[material_id]
    return -torch.log(d) - fcoeff * frequency * d - absorption * d


def attenuation_freq_slope(dist, material_id, freq_table: torch.Tensor):
    """d(log gain)/d(frequency) of the attenuation law: the reference's
    exp(-freq_coeff * f * d) term (utils.py:50-65) is log-linear in f with
    slope -freq_coeff * d.  Per-bin rendering (absorption_mode='per-bin')
    evaluates that law at every rfft bin, gain(f) = gain(0) * exp(-slope *
    f), with gains referenced at f = 0 so the exponent is never positive."""
    return freq_table[material_id] * torch.clamp(dist, min=0.1)


class ReflectionTree(NamedTuple):
    """Dense no-immediate-repeat reflection tree (host-side, static):
    node_plane[i] is the plane reflected across to create node i,
    node_parent[i] its parent (-1 for order-1 nodes), node_order[i] its
    reflection order, BFS-sorted."""
    node_plane: np.ndarray
    node_parent: np.ndarray
    node_order: np.ndarray


@functools.lru_cache(maxsize=32)
def reflection_tree(num_planes: int, max_order: int) -> ReflectionTree:
    planes, parents, orders = [], [], []
    frontier = [(-1, -1)]  # (node_index, plane_of_node); root = true source
    for order in range(1, max_order + 1):
        new_frontier = []
        for node_idx, node_plane in frontier:
            for p in range(num_planes):
                if p == node_plane:
                    continue  # own-plane child == parent position, a dup
                planes.append(p)
                parents.append(node_idx)
                orders.append(order)
                new_frontier.append((len(planes) - 1, p))
        frontier = new_frontier
    return ReflectionTree(np.array(planes, np.int32),
                          np.array(parents, np.int32),
                          np.array(orders, np.int32))


class ImageSources(NamedTuple):
    positions: torch.Tensor     # (..., I, 3) image-source positions
    material_ids: torch.Tensor  # (I,) material id per node (its plane's)
    accepted: torch.Tensor      # (..., I) bool: survives dedupe + attenuation
    orders: torch.Tensor        # (I,) reflection order


def image_sources(source: torch.Tensor,
                  plane_coeffs: torch.Tensor,
                  plane_material_ids: torch.Tensor,
                  mic_positions: torch.Tensor,
                  frequency,
                  absorption_table: torch.Tensor,
                  freq_table: torch.Tensor,
                  max_order: int,
                  absorption_threshold: float = 0.01,
                  round_decimals: int = 6) -> ImageSources:
    """Image sources matching generate_image_sources_iterative
    (utils.py:67-106) node for node: the dense tree with an acceptance mask;
    ``positions[accepted]`` in node order is the reference's list.
    ``source`` (..., 3) and ``mic_positions`` (..., M, 3) may carry a
    leading scene axis; positions (..., I, 3) and ``accepted`` (..., I)
    then carry it too (material ids and orders are the tree's, (I,))."""
    dev, dt = source.device, source.dtype
    lead = source.shape[:-1]
    num_planes = int(plane_coeffs.shape[0])
    if num_planes == 0 or max_order == 0:
        zi = torch.zeros(0, dtype=torch.long, device=dev)
        return ImageSources(torch.zeros(lead + (0, 3), dtype=dt, device=dev),
                            zi, torch.zeros(lead + (0,), dtype=torch.bool,
                                            device=dev), zi)

    tree = reflection_tree(num_planes, max_order)
    num_nodes = len(tree.node_plane)
    node_plane = torch.as_tensor(tree.node_plane, dtype=torch.long,
                                 device=dev)

    # Each node reflects its parent's position (the source for order 1).
    rows = []
    for i in range(num_nodes):
        parent = int(tree.node_parent[i])
        base = source if parent < 0 else rows[parent]
        rows.append(reflect_point_across_plane(
            base, plane_coeffs[int(tree.node_plane[i])]))
    positions = torch.stack(rows, -2)                          # (..., I, 3)

    material_ids = plane_material_ids.long()[node_plane]

    # Acceptance: mean over mics > thr AND min > thr/2 (utils.py:97-99),
    # in log space (stable logsumexp mean).
    dists = torch.linalg.norm(positions[..., :, None, :]
                              - mic_positions[..., None, :, :],
                              dim=-1)                          # (..., I, M)
    la = log_attenuation(dists, material_ids[:, None], frequency,
                         absorption_table, freq_table)
    if absorption_threshold > 0:
        log_thr = float(np.log(absorption_threshold))
        k = torch.amax(la, -1)
        log_mean = k + torch.log(torch.mean(torch.exp(la - k[..., None]),
                                            -1))
        att_ok = (log_mean > log_thr) & (
            torch.amin(la, -1) > float(np.log(absorption_threshold / 2.0)))
    else:  # a non-positive threshold accepts everything
        att_ok = torch.ones(lead + (num_nodes,), dtype=torch.bool,
                            device=dev)

    # Sequential BFS-order dedupe against earlier ACCEPTED nodes and the
    # source, by equality of rounded coordinates (utils.py:82,90-91); a node
    # is considered only if its parent was accepted.
    q = torch.round(positions, decimals=round_decimals)
    q_src = torch.round(source, decimals=round_decimals)
    same_as_src = torch.all(q == q_src[..., None, :], -1)      # (..., I)
    accepted = torch.zeros(lead + (num_nodes,), dtype=torch.bool, device=dev)
    for i in range(num_nodes):  # entries >= i are still False here
        parent = int(tree.node_parent[i])
        parent_ok = True if parent < 0 else accepted[..., parent]
        dup = torch.any(accepted & torch.all(q == q[..., i:i + 1, :], -1),
                        -1) | same_as_src[..., i]
        accepted[..., i] = parent_ok & ~dup & att_ok[..., i]
    return ImageSources(positions, material_ids, accepted,
                        torch.as_tensor(tree.node_order, dtype=torch.long,
                                        device=dev))

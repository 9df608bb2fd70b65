"""Checkpoint and resume for long Monte-Carlo sweeps (counterpart of the
JAX package's parallel/checkpoint.py; the reference persists nothing).

``run_sweep_checkpointed`` runs the sweep in chunks, writes the per-scene
results accumulated so far to an .npz checkpoint after every chunk (the JAX
package's layout and fields, written atomically), and resumes from the last
completed chunk.  Each chunk draws from a ``torch.Generator`` seeded by a
fixed rule of (seed, chunk index) (``chunk_seed``), so a resumed run equals
an uninterrupted one to the bit on the same device.  The JAX package
derives its chunk keys by ``jax.random.fold_in``, whose streams torch
cannot reproduce: the two packages' sweeps of one seed agree in
distribution, not scene by scene.

With a ``mesh`` (parallel/sweep.make_mesh) of W ranks every chunk is a
meshed sweep: rank r of chunk c runs chunk_scenes / W scenes from
``chunk_seed(seed, c * W + r)``, which are the scenes of chunk c * W + r
of the unmeshed sweep at chunk_scenes / W.  The shards are all-gathered to
every rank in rank order, rank 0 writes the checkpoint, and a barrier
follows.  The file is the unmeshed sweep's at chunk_scenes / W, so a run
resumes from it with or without a mesh, at any W that divides its chunks.
On resume rank 0 alone reads it and broadcasts the state, so the other
ranks need not share its filesystem.  Without a mesh the sweep runs as a
one-rank mesh on ``device``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from .sweep import (SceneResult, SweepSpec, SweepSummary, _check_mesh,
                    _meshed_sweep, chunk_seed, make_mesh)

_FIELDS = ("estimate", "source", "error", "cost", "tdoas", "covariance")
__all__ = ["chunk_seed", "save_checkpoint", "load_checkpoint",
           "run_sweep_checkpointed"]


def save_checkpoint(path: str, spec: SweepSpec, seed: int,
                    completed_chunks: int, chunk_scenes: int,
                    results: SceneResult) -> None:
    """Atomically write the sweep state and the accumulated per-scene
    results (numpy arrays)."""
    payload = {f: np.asarray(getattr(results, f)) for f in _FIELDS}
    payload["completed_chunks"] = np.asarray(completed_chunks)
    payload["chunk_scenes"] = np.asarray(chunk_scenes)
    payload["seed"] = np.asarray(seed)
    payload["spec_repr"] = np.asarray(repr(dataclasses.asdict(spec)))
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str):
    """(completed_chunks, chunk_scenes, seed, spec_repr, SceneResult of
    numpy arrays), or None when there is no checkpoint or it has another
    SceneResult layout (treated like a spec mismatch: the sweep
    restarts)."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if any(f not in z for f in _FIELDS):
            return None
        results = SceneResult(*(z[f] for f in _FIELDS))
        return (int(z["completed_chunks"]), int(z["chunk_scenes"]),
                int(z["seed"]), str(z["spec_repr"]), results)


def _concat(a: SceneResult, b: SceneResult) -> SceneResult:
    return SceneResult(*(np.concatenate([x, y], 0) for x, y in zip(a, b)))


def run_sweep_checkpointed(spec: SweepSpec, seed: int, num_scenes: int,
                           chunk_scenes: int, checkpoint_path: str,
                           mesh=None, hit_threshold: float = 0.1,
                           resume: bool = True, log_fn=None,
                           dtype: torch.dtype = torch.float32,
                           device=None) -> SweepSummary:
    """Run ``num_scenes`` scenes in chunks of ``chunk_scenes`` on
    ``device`` (default ``cuda``), checkpointing after each chunk; a rerun
    with the same arguments resumes from the last completed chunk and gives
    results equal to the bit to an uninterrupted run.  A checkpoint of
    another spec, seed or chunking is not continued: the sweep restarts.
    With a ``mesh`` every chunk is a meshed sweep over its ranks, each on
    the mesh's device (``device`` is not used), and every rank returns all
    the results (module docstring).  The summary holds numpy arrays."""
    if num_scenes % chunk_scenes != 0:
        raise ValueError("num_scenes must be a multiple of chunk_scenes")
    if mesh is None:
        mesh = make_mesh(device=device)
    else:
        _check_mesh(mesh, seed)
    ranks = mesh.size
    if chunk_scenes % ranks != 0:
        raise ValueError(f"chunk_scenes={chunk_scenes} must be divisible "
                         f"by the mesh size {ranks}")
    num_chunks = num_scenes // chunk_scenes
    # The checkpoint counts the unmeshed sweep's chunks, chunk_scenes / W
    # scenes each.
    unit = chunk_scenes // ranks

    # Rank 0 alone reads the checkpoint and decides where to resume: the
    # other ranks may see no file, or an older one, where the ranks share
    # no filesystem.
    state = None
    if resume and mesh.rank == 0:
        state = load_checkpoint(checkpoint_path)
        # A checkpoint of another spec, seed or chunking must not be
        # continued: the mixed results would be silently wrong.
        if state is not None and not (
                state[1] == unit and state[0] % ranks == 0
                and state[2] == seed
                and state[3] == repr(dataclasses.asdict(spec))):
            state = None
    state = mesh.broadcast(state)
    start = 0
    accumulated: Optional[SceneResult] = None
    if state is not None:
        start, accumulated = state[0] // ranks, state[4]
        if log_fn:
            log_fn(f"resuming at chunk {start}/{num_chunks}")

    for idx in range(start, num_chunks):
        shard = SceneResult(*(mesh.all_gather(x) for x in _meshed_sweep(
            spec, seed, chunk_scenes, mesh, hit_threshold, dtype,
            first_chunk=idx * ranks).results))
        chunk_np = SceneResult(*(x.cpu().numpy() for x in shard))
        accumulated = chunk_np if accumulated is None else _concat(
            accumulated, chunk_np)
        if mesh.rank == 0:
            save_checkpoint(checkpoint_path, spec, seed, (idx + 1) * ranks,
                            unit, accumulated)
        # The checkpoint is on disk before any rank goes on.
        mesh.barrier()
        if log_fn:
            log_fn(f"chunk {idx + 1}/{num_chunks} done "
                   f"({(idx + 1) * chunk_scenes} scenes)")

    err = np.asarray(accumulated.error)
    return SweepSummary(rmse=np.sqrt(np.mean(err ** 2)),
                        mean_error=np.mean(err),
                        hit_rate=np.mean(err < hit_threshold),
                        results=accumulated)

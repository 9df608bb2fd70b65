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
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .sweep import (MESH_NOT_PORTED, SceneResult, SweepSpec,
                    SweepSummary, monte_carlo_sweep)

_FIELDS = ("estimate", "source", "error", "cost", "tdoas", "covariance")


def chunk_seed(seed: int, chunk_index: int) -> int:
    """The generator seed of chunk ``chunk_index`` of a sweep seeded
    ``seed``: 63 bits of ``numpy.random.SeedSequence([seed, index])``."""
    state = np.random.SeedSequence([seed, chunk_index]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


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
    The summary holds numpy arrays."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    if num_scenes % chunk_scenes != 0:
        raise ValueError("num_scenes must be a multiple of chunk_scenes")
    dev = resolve_device(device)
    num_chunks = num_scenes // chunk_scenes

    start = 0
    accumulated: Optional[SceneResult] = None
    if resume:
        state = load_checkpoint(checkpoint_path)
        if state is not None:
            done, saved_chunk, saved_seed, saved_spec, results = state
            # A checkpoint of another spec, seed or chunking must not be
            # continued: the mixed results would be silently wrong.
            if (saved_chunk == chunk_scenes and saved_seed == seed
                    and saved_spec == repr(dataclasses.asdict(spec))):
                start = done
                accumulated = results
                if log_fn:
                    log_fn(f"resuming at chunk {start}/{num_chunks}")

    for idx in range(start, num_chunks):
        gen = torch.Generator(device=dev).manual_seed(chunk_seed(seed, idx))
        summary = monte_carlo_sweep(spec, gen, chunk_scenes,
                                    hit_threshold=hit_threshold, dtype=dtype,
                                    device=dev)
        chunk_np = SceneResult(*(x.cpu().numpy() for x in summary.results))
        accumulated = chunk_np if accumulated is None else _concat(
            accumulated, chunk_np)
        save_checkpoint(checkpoint_path, spec, seed, idx + 1, chunk_scenes,
                        accumulated)
        if log_fn:
            log_fn(f"chunk {idx + 1}/{num_chunks} done "
                   f"({(idx + 1) * chunk_scenes} scenes)")

    err = np.asarray(accumulated.error)
    return SweepSummary(rmse=np.sqrt(np.mean(err ** 2)),
                        mean_error=np.mean(err),
                        hit_rate=np.mean(err < hit_threshold),
                        results=accumulated)

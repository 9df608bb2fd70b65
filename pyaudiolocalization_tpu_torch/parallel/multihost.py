"""Multi-process execution over ``torch.distributed``: one process a card
(counterpart of the JAX package's parallel/multihost.py, whose processes
are one a host over ``jax.distributed``).

``initialize()`` wraps ``torch.distributed.init_process_group`` with the
variables that ``torchrun`` sets as fall-backs, and ``global_scene_mesh()``
builds the sweep's scene mesh over every rank.  Then ``monte_carlo_sweep(
..., mesh=global_scene_mesh())`` runs each rank's share of the scenes on
its card and returns the summary, all-reduced, on every rank::

    torchrun --nproc-per-node=N script.py      # in script.py:
    multihost.initialize()
    out = monte_carlo_sweep(spec, seed, scenes, mesh=global_scene_mesh())

The backend is the caller's to name (NCCL by default, gloo for CPU
processes); nothing switches it.  tests/test_torch_mesh.py runs two gloo
processes on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from .sweep import SceneMesh, make_mesh

__all__ = ["initialize", "global_scene_mesh", "is_multiprocess"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl") -> None:
    """Join this process to the process group.

    ``coordinator_address`` ("host:port" or "tcp://host:port") defaults to
    ``MASTER_ADDR``:``MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE``
    and ``process_id`` to ``RANK``, the variables ``torchrun`` sets.  Call
    it once a process, before the mesh is built."""
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if addr is None or port is None:
            raise ValueError("initialize: no coordinator_address and no "
                             "MASTER_ADDR / MASTER_PORT in the environment")
        coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))


def global_scene_mesh(device=None) -> SceneMesh:
    """The scene mesh over every rank of the process group, this rank on
    ``device`` (default ``cuda:$LOCAL_RANK``); one rank without a group."""
    return make_mesh(None, device)


def is_multiprocess() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)

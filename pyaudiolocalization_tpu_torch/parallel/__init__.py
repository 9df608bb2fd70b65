"""Batched Monte-Carlo scene sweeps over one card or a mesh of cards
(counterpart of the JAX package's parallel/ package)."""

from .checkpoint import (  # noqa: F401
    load_checkpoint, run_sweep_checkpointed, save_checkpoint)
from . import multihost  # noqa: F401
from .sweep import (  # noqa: F401
    SceneMesh, SceneResult, SweepSpec, SweepSummary, localize_batch,
    make_mesh, monte_carlo_sweep, run_scene)

__all__ = ["multihost", "SweepSpec", "SceneResult", "SweepSummary",
           "SceneMesh", "make_mesh", "localize_batch", "run_scene",
           "monte_carlo_sweep", "run_sweep_checkpointed", "save_checkpoint",
           "load_checkpoint"]

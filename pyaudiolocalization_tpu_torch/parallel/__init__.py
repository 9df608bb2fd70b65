"""Batched Monte-Carlo scene sweeps (counterpart of the JAX package's
parallel/ package)."""

from .checkpoint import (  # noqa: F401
    load_checkpoint, run_sweep_checkpointed, save_checkpoint)
from .sweep import (  # noqa: F401
    SceneResult, SweepSpec, SweepSummary, localize_batch, monte_carlo_sweep,
    run_scene)

__all__ = ["SweepSpec", "SceneResult", "SweepSummary", "localize_batch",
           "run_scene", "monte_carlo_sweep", "run_sweep_checkpointed",
           "save_checkpoint", "load_checkpoint"]

"""pyaudiolocalization_tpu_torch — the PyTorch / CUDA port of
pyaudiolocalization_tpu for NVIDIA Hopper.

The package mirrors the JAX package's ``ops/ models/ utils/`` layout and
function names; it imports torch and numpy and never jax.  Ported:
the reference's public API (``localize_sound_source``,
``simulate_signals_with_multipath``, ``run_calibration``) in parity mode
(the default demo: the reference lag axis, the pre-sync, calibration) and
in physical mode with its options (front ends, weightings, ladders,
bootstrap nulls, clustering, robust LM, the DE fallback, calibration
delays, per-bin absorption), the SRP-PHAT solvers ('srp', 'srp+lm') and
the narrowband solvers ('beam', 'music', 'capon'), its windowed fast path,
and the batched Monte-Carlo sweep (``parallel/``: every solver, the
Wiener front end, multi-source scenes), over nine hand-written CUDA
kernels (ops/cuda_fft.py); recorded audio files (``use_simulation=
False``: utils/audio_io.py, ops/resample.py), the reference-shaped
``compat`` layer with the IIR filters, and the checkpointed sweep
(``parallel.run_sweep_checkpointed``); and the serving path: the
Welch-averaged GCC (``ops.gccphat.gcc_phat_streaming``), the online
``models.online.StreamingLocalizer`` and ``OnlineTracker``, moving-source
tracking (``models.tracking.localize_trajectory``, ``track_multiple``) and
the moving render (``models.simulator.simulate_moving_source``);
beamformed extraction (``models.beamformer.extract_source``,
``extract_source_mvdr``), array-geometry calibration
(``models.arraycal``) and the multi-card scene mesh
(``parallel.make_mesh``, ``parallel.multihost``, ``mesh=``): all that the
JAX package does.
"""

from .api import (  # noqa: F401
    localize_sound_source,
    run_calibration,
    simulate_signals_with_multipath,
)
from .utils.config import (  # noqa: F401
    CalibrationConfig, DEFAULT_CONFIG, LocalizationConfig, SceneConfig)
from .utils.materials import (  # noqa: F401
    MaterialTable, default_table, material_properties)

__version__ = "0.1.0"

__all__ = [
    "localize_sound_source",
    "simulate_signals_with_multipath",
    "run_calibration",
    "SceneConfig",
    "LocalizationConfig",
    "CalibrationConfig",
    "DEFAULT_CONFIG",
    "material_properties",
    "MaterialTable",
    "default_table",
]

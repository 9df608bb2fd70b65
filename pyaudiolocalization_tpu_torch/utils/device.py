"""Device selection for the port's entry points: ``cuda`` unless the
caller names a device, and never a silent fall-back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which
    raises when no card is present (pass ``device="cpu"`` to run the plain
    PyTorch path on the CPU)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={str(device)!r}: no CUDA device is "
                               "available")
        return dev
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                       "run the plain PyTorch path on the CPU")

"""Device selection for the port's entry points: ``cuda`` unless the
caller names a device, and never a silent fall-back to the CPU."""

from __future__ import annotations

import numpy as np
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


def as_tensor(x, like: torch.Tensor = None, device=None) -> torch.Tensor:
    """``x`` as a tensor: in ``like``'s dtype and on its device when given,
    else on ``device`` (``resolve_device``) in its own dtype (a numpy
    float64 array stays float64; a Python list goes through numpy, so its
    floats are float64 too)."""
    if like is not None:
        if torch.is_tensor(x):
            return x.to(dtype=like.dtype, device=like.device)
        return torch.as_tensor(np.asarray(x), dtype=like.dtype,
                               device=like.device)
    dev = resolve_device(device)
    return (x.to(dev) if torch.is_tensor(x)
            else torch.as_tensor(np.array(x), device=dev))

"""Device selection for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Asking for CUDA
on a machine without it raises: nothing falls back to the CPU unless the
caller passed ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev

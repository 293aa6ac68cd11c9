"""Dense nearest-neighbour distance in both directions, and the huber loss
(as ``spacap3d_tpu/ops/nn_distance.py``)."""
from __future__ import annotations

from typing import Tuple

import torch


def huber_loss(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise huber: 0.5 min(|e|, delta)^2 + delta (|e| - min(|e|, delta))."""
    abs_error = error.abs()
    quadratic = abs_error.clamp(max=delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor, l1smooth: bool = False,
                delta: float = 1.0, l1: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """pc1 (B, N, C), pc2 (B, M, C) -> (dist1 (B, N), idx1 (B, N) int32,
    dist2 (B, M), idx2 (B, M) int32). The distance is squared L2, L1 with
    ``l1``, summed huber with ``l1smooth``; per-coordinate terms are summed
    in axis order. Ties take the first index, and the distances' gradient
    is split evenly among tied elements (``amin``), as JAX's ``min``."""
    d = None
    for k in range(pc1.shape[-1]):
        dk = pc1[:, :, None, k] - pc2[:, None, :, k]            # (B, N, M)
        if l1smooth:
            dk = huber_loss(dk, delta)
        elif l1:
            dk = dk.abs()
        else:
            dk = dk * dk
        d = dk if d is None else d + dk
    return (d.amin(2), torch.argmin(d, 2).to(torch.int32),
            d.amin(1), torch.argmin(d, 1).to(torch.int32))

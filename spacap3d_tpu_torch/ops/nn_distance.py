"""Dense nearest-neighbour distance in both directions (squared L2)."""
from __future__ import annotations

from typing import Tuple

import torch


def nn_distance(pc1: torch.Tensor, pc2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """pc1 (B, N, C), pc2 (B, M, C) -> (dist1 (B, N), idx1 (B, N) int32,
    dist2 (B, M), idx2 (B, M) int32). Per-coordinate terms are summed in
    axis order; ties take the first index."""
    d = None
    for k in range(pc1.shape[-1]):
        dk = pc1[:, :, None, k] - pc2[:, None, :, k]            # (B, N, M)
        d = dk * dk if d is None else d + dk * dk
    dist1, idx1 = torch.min(d, dim=2)
    dist2, idx2 = torch.min(d, dim=1)
    return dist1, idx1.to(torch.int32), dist2, idx2.to(torch.int32)

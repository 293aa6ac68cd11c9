"""Three-nearest-neighbour feature interpolation."""
from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.spacap.ops.grouping import group_points


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """unknown (B, n, 3), known (B, m, 3) -> (dist2 (B, n, 3), idx (B, n, 3) int32).

    Squared distances of the 3 nearest known points, lowest index first on
    ties: three first-index argmin passes, each masking the pick out."""
    diff = unknown[:, :, None, :] - known[:, None, :, :]
    d2 = (diff * diff).sum(-1)                                  # (B, n, m)
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d2, dim=-1, keepdim=True)              # first minimum
        dists.append(torch.gather(d2, -1, i))
        idxs.append(i)
        d2 = d2.scatter(-1, i, float("inf"))
    return torch.cat(dists, -1), torch.cat(idxs, -1).to(torch.int32)


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """feats (B, m, C), idx (B, n, 3), weight (B, n, 3) -> (B, n, C)."""
    return (group_points(feats, idx) * weight[..., None]).sum(2)

"""Gather / group ops over channel-last (B, N, C) tensors."""
from __future__ import annotations

from typing import Optional

import torch


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, m) int -> (B, m, C): out[b, j] = points[b, idx[b, j]]."""
    c = points.shape[-1]
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, c))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, m, ns) int -> (B, m, ns, C)."""
    b, m, ns = idx.shape
    return gather_points(points, idx.reshape(b, m * ns)).reshape(b, m, ns, -1)


def group_and_localize(cat: torch.Tensor, idx: torch.Tensor, new_xyz: torch.Tensor,
                       radius: Optional[float]) -> torch.Tensor:
    """SA neighbour assembly: gather (xyz ++ feature) rows, then
    ``out[..., :3] = (gathered[..., :3] - new_xyz) / radius`` and
    ``out[..., 3:] = gathered[..., 3:]`` (``radius=None`` skips the divide).
    Forward only; the same ops as the composed gather/slice/concat."""
    grouped = group_points(cat, idx)
    gx = grouped[..., :3] - new_xyz[:, :, None, :]
    if radius is not None:
        gx = gx / radius
    return torch.cat([gx, grouped[..., 3:]], dim=-1)

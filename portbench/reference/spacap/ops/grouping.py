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


class _GroupAndLocalize(torch.autograd.Function):
    """The JAX package's custom VJP: the backward is one channel-scale
    multiply and one scatter-add, not autograd's slice / concat pair."""

    @staticmethod
    def forward(ctx, cat, idx, new_xyz, radius):
        grouped = group_points(cat, idx)
        gx = grouped[..., :3] - new_xyz[:, :, None, :]
        if radius is not None:
            gx = gx / radius
        ctx.save_for_backward(idx)
        ctx.cat_shape, ctx.radius = cat.shape, radius
        return torch.cat([gx, grouped[..., 3:]], dim=-1)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, m, ns = idx.shape
        n, c = ctx.cat_shape[1:]
        inv = 1.0 if ctx.radius is None else 1.0 / ctx.radius
        d_cat = d_new_xyz = None
        if ctx.needs_input_grad[0]:
            scale = g.new_ones(c)
            scale[:3] = inv
            rows = (g * scale).reshape(b * m * ns, c)
            flat = (idx.long() + n * torch.arange(b, device=idx.device)[:, None, None]).reshape(-1)
            d_cat = torch.zeros((b * n, c), dtype=g.dtype, device=g.device).index_add_(
                0, flat, rows).reshape(b, n, c)
        if ctx.needs_input_grad[2]:
            d_new_xyz = -g[..., :3].sum(2) * inv
        return d_cat, None, d_new_xyz, None


def group_and_localize(cat: torch.Tensor, idx: torch.Tensor, new_xyz: torch.Tensor,
                       radius: Optional[float]) -> torch.Tensor:
    """SA neighbour assembly: gather (xyz ++ feature) rows, then
    ``out[..., :3] = (gathered[..., :3] - new_xyz) / radius`` and
    ``out[..., 3:] = gathered[..., 3:]`` (``radius=None`` skips the divide).
    The forward is the composed gather / slice / concat; the backward
    scatter-adds ``g`` scaled by ``[1/r]*3 ++ [1]*(C-3)`` into ``cat`` and
    gives ``new_xyz`` ``-sum over neighbours of g[..., :3] / r``."""
    return _GroupAndLocalize.apply(cat, idx, new_xyz, radius)

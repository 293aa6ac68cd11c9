"""Furthest point sampling, the plain version: a frozen copy of the port's
``furthest_point_sample_plain``. Index 0 comes first; points with
||p||^2 <= 1e-3 are never picked; each step picks the point with the
largest min squared distance to the picks so far, lowest index on ties."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from portbench.reference.spacap.ops._f32 import dot3

MAG_EPS = 1e-3
INIT_DIST = 1e10
FPS_CLUSTERS = (1, 2, 4, 8, 16)
# csrc/fps.cu kBlockPoints: the most points one block of the cluster kernel holds
FPS_BLOCK_POINTS = 8192
# the fewest points a block takes in a cluster of 2 or more blocks
FPS_MIN_BLOCK_POINTS = 1024


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) f32 -> (B, npoint) int32, one tensor op per step."""
    b, n, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    valid = dot3(x, y, z, x, y, z) > MAG_EPS
    mind = torch.where(valid, INIT_DIST, -1.0).to(torch.float32)
    out = torch.zeros((b, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(b, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        # invalid points hold -1 and d >= 0: the plain min keeps them at -1
        mind = torch.minimum(mind, dot3(dx, dy, dz, dx, dy, dz))
        last = torch.argmax(mind, dim=1)       # first index of the max
        out[:, i] = last.to(torch.int32)
    return out

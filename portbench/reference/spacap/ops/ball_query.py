"""Ball query, the plain version: a frozen copy of the port's
``ball_query_plain``. For each centre, the indices of the first ``nsample``
points in input order with squared distance strictly below ``radius**2``;
empty slots repeat the first hit; a centre with no hit gets an all-zero row."""
from __future__ import annotations


import numpy as np
import torch

from portbench.reference.spacap.ops._f32 import dot3

# csrc/ball_query.cu kTile and kWarps: points a tile, and warps a block
BQ_TILE_POINTS = 1024
BQ_WARPS = 16
# the centres a warp holds in the kernel's builds, most first
BQ_WARP_CENTRES = (4, 1)
# warps an SM (of the 64 it holds) below which one centre a warp, and so
# four times the warps, is faster: tools/bq_probe.py's sweep puts the
# crossover between SA3's 7.8 and SA2's 15.5 warps an SM at C = 4
# (PERF.md §6), and this takes the middle
BQ_MIN_WARPS_A_SM = 12


def radius_sq(radius: float) -> float:
    """float32(r * r), the product rounded from double as JAX rounds it."""
    return float(np.float32(float(radius) * float(radius)))


def ball_query_plain(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
                     nsample: int, chunk: int = 64) -> torch.Tensor:
    """(B, N, 3), (B, m, 3) f32 -> (B, m, nsample) int32.

    Centres go ``chunk`` at a time, so the (B, chunk, N) intermediates stay
    small at SA1 (N = 40000, m = 2048)."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    r2 = torch.tensor(radius_sq(radius), dtype=torch.float32, device=xyz.device)
    px, py, pz = (t[:, None, :] for t in xyz.unbind(-1))         # (B, 1, N)
    p2 = dot3(px, py, pz, px, py, pz)
    cx, cy, cz = (t[:, :, None] for t in new_xyz.unbind(-1))     # (B, m, 1)
    c2 = dot3(cx, cy, cz, cx, cy, cz)
    slots = torch.arange(1, nsample + 1, device=xyz.device)
    out = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    for s in range(0, m, chunk):
        e = min(m, s + chunk)
        cross = dot3(cx[:, s:e], cy[:, s:e], cz[:, s:e], px, py, pz)
        d2 = (c2[:, s:e] + p2) - 2.0 * cross                     # (B, C, N)
        rank = torch.cumsum(d2 < r2, dim=-1)                     # hits so far
        count = rank[..., -1:]                                   # (B, C, 1)
        # position of the k-th hit = first index where the running count is k
        pos = torch.searchsorted(rank, slots.expand(b, e - s, nsample).contiguous())
        sel = torch.where(slots <= count, pos, pos[..., :1])
        out[:, s:e] = torch.where(count > 0, sel, 0).to(torch.int32)
    return out

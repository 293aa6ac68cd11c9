"""Ball query.

Contract (as ``spacap3d_tpu/ops/ball_query.py``): for each centre, the
indices of the first ``nsample`` points in input order with squared
distance strictly below ``radius**2``; empty slots repeat the first hit;
a centre with no hit gets an all-zero row.

d2 is assembled as (|c|^2 + |p|^2) - 2 c.p with the JAX oracle's FMA
chains, and compared with float32(radius * radius) rounded once from the
double product, so hits on the radius boundary agree with the oracle.

``ball_query`` launches the CUDA kernel (``csrc/ball_query.cu``) for CUDA
tensors and takes the plain version for CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.ops._f32 import dot3


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


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """(B, N, 3), (B, m, 3) f32 contiguous -> (B, m, nsample) int32."""
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dim() != 3 or t.shape[-1] != 3 or t.dtype != torch.float32:
            raise ValueError(f"ball_query: {name} must be (B, *, 3) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if xyz.shape[0] != new_xyz.shape[0] or xyz.device != new_xyz.device:
        raise ValueError("ball_query: xyz and new_xyz differ in batch or device")
    if xyz.device.type == "cpu":
        return ball_query_plain(xyz, new_xyz, radius, nsample)
    if xyz.device.type != "cuda":
        raise ValueError(f"ball_query: unsupported device {xyz.device}")
    if not (xyz.is_contiguous() and new_xyz.is_contiguous()):
        raise ValueError("ball_query: inputs must be contiguous")
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        out = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
        err = lib.spacap_ball_query(
            xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, radius_sq(radius),
            nsample, out.data_ptr(),
            torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(err, "ball_query")
    ball_query.launches += 1
    return out


ball_query.launches = 0

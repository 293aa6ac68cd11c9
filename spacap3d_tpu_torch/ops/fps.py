"""Furthest point sampling.

Contract (as ``spacap3d_tpu/ops/fps.py``): index 0 comes first; points with
||p||^2 <= 1e-3 are never picked; each step picks the point with the
largest min squared distance to the picks so far, lowest index on ties.

``furthest_point_sample`` launches the CUDA kernel (``csrc/fps.cu``) for a
CUDA tensor and takes the plain version for a CPU tensor.
"""
from __future__ import annotations

import torch

from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.ops._f32 import dot3

MAG_EPS = 1e-3
INIT_DIST = 1e10


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


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) f32 contiguous -> (B, npoint) int32."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"fps wants (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {xyz.device}")
    if not xyz.is_contiguous():
        raise ValueError("fps: xyz must be contiguous")
    b, n, _ = xyz.shape
    lib = _build.library()
    with torch.cuda.device(xyz.device):
        out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
        scratch = None
        if n > lib.spacap_fps_smem_points():
            scratch = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
        err = lib.spacap_fps(
            xyz.data_ptr(), b, n, npoint,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(err, "fps")
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0

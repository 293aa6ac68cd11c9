"""Furthest point sampling.

Contract (as ``spacap3d_tpu/ops/fps.py``): index 0 comes first; points with
||p||^2 <= 1e-3 are never picked; each step picks the point with the
largest min squared distance to the picks so far, lowest index on ties.

``furthest_point_sample`` launches a CUDA kernel (``csrc/fps.cu``) for a
CUDA tensor and takes the plain version for a CPU tensor. A row of up to
16 x ``FPS_BLOCK_POINTS`` points is split over a thread-block cluster of C
blocks, each holding its contiguous share of the row in registers; longer
rows take a streaming kernel, one block a row. The choice is made from N
and the device before the launch, never after a failed one.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.ops._f32 import dot3

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


def fps_cluster(b: int, n: int, resident: Callable[[int], int]) -> int:
    """Blocks a row of n points is split over (C), for b rows: the largest C
    in ``FPS_CLUSTERS`` whose b clusters the device holds all at once
    (``resident(C)``: co-resident clusters) and whose blocks get at least
    ``FPS_MIN_BLOCK_POINTS`` points (C = 1 always may); else the smallest C
    that holds the row. 0 (the streaming kernel) when no C the device holds
    has room for the row."""
    held = [c for c in FPS_CLUSTERS if -(-n // c) <= FPS_BLOCK_POINTS and resident(c) >= 1]
    if not held:
        return 0
    wave = [c for c in held
            if resident(c) >= b and (c == 1 or -(-n // c) >= FPS_MIN_BLOCK_POINTS)]
    return max(wave) if wave else min(held)


def _library() -> ctypes.CDLL:
    """The kernel library, whose blocks must hold ``FPS_BLOCK_POINTS``
    points: the rules above pick C and the kernel from that constant."""
    lib = _build.library()
    held = lib.spacap_fps_block_points()
    if held != FPS_BLOCK_POINTS:
        raise RuntimeError(f"fps: csrc/fps.cu holds {held} points a block, "
                           f"ops/fps.py assumes {FPS_BLOCK_POINTS}")
    return lib


@functools.lru_cache(maxsize=None)
def fps_launch_info(device_index: int, n: int, cluster: int, threads: int = 0) -> dict:
    """The cluster kernel's launch for a row of n points over ``cluster``
    blocks of at most ``threads`` threads (0: the kernel's default) on CUDA
    device ``device_index``: threads a block, points a thread, shared memory
    a block (bytes) and co-resident clusters."""
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device_index):
        err = _library().spacap_fps_launch_info(n, cluster, threads, *map(ctypes.byref, out))
    _build.check(err, "fps launch info")
    return dict(zip(("threads", "points_per_thread", "shared_memory", "max_active_clusters"),
                    (o.value for o in out)))


@functools.lru_cache(maxsize=None)
def fps_default_cluster(device_index: int, b: int, n: int) -> int:
    """The C that ``furthest_point_sample`` takes by default for (b, n) on
    that device; 0 for the streaming kernel."""
    return fps_cluster(b, n, lambda c: fps_launch_info(
        device_index, n, c)["max_active_clusters"])


def furthest_point_sample(xyz: torch.Tensor, npoint: int, *,
                          cluster: Optional[int] = None) -> torch.Tensor:
    """(B, N, 3) f32 contiguous -> (B, npoint) int32, cut from the input's
    gradient as JAX's ``stop_gradient`` cuts it. On CUDA, ``cluster``
    (1, 2, 4, 8 or 16) forces the blocks a row is split over, which only
    measurements need; by default ``fps_default_cluster`` picks C from B, N
    and the device."""
    if cluster is not None and (not isinstance(cluster, int) or cluster not in FPS_CLUSTERS):
        raise ValueError(f"fps: cluster = {cluster!r} must be one of {FPS_CLUSTERS}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"fps wants (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    xyz = xyz.detach()      # no gradient: the indices track none
    if xyz.device.type == "cpu":
        return furthest_point_sample_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"fps: unsupported device {xyz.device}")
    if not xyz.is_contiguous():
        raise ValueError("fps: xyz must be contiguous")
    b, n, _ = xyz.shape
    if cluster is None:
        cluster = fps_default_cluster(xyz.device.index, b, n)
    elif -(-n // cluster) > FPS_BLOCK_POINTS:
        raise ValueError(f"fps: a cluster of {cluster} blocks holds at most "
                         f"{cluster * FPS_BLOCK_POINTS} points, not {n}")
    lib = _library()
    with torch.cuda.device(xyz.device):
        out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
        scratch = None
        if cluster == 0:    # the streaming kernel's min distances
            scratch = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
        err = lib.spacap_fps(
            xyz.data_ptr(), b, n, npoint, cluster, 0,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(err, "fps")
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0

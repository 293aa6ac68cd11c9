"""Ball query.

Contract (as ``spacap3d_tpu/ops/ball_query.py``): for each centre, the
indices of the first ``nsample`` points in input order with squared
distance strictly below ``radius**2``; empty slots repeat the first hit;
a centre with no hit gets an all-zero row.

d2 is assembled as (|c|^2 + |p|^2) - 2 c.p with the JAX oracle's FMA
chains, and compared with float32(radius * radius) rounded once from the
double product, so hits on the radius boundary agree with the oracle.

``ball_query`` launches the CUDA kernel (``csrc/ball_query.cu``) for CUDA
tensors and takes the plain version for CPU tensors. A block of the kernel
holds C centres in each of its ``BQ_WARPS`` warps and walks its row's
points in tiles of ``BQ_TILE_POINTS``; ``ball_query_warp_centres`` picks C
from the batch, the centres and the card's SMs before the launch.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.ops._f32 import dot3

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


def ball_query_blocks(b: int, m: int, warp_centres: int) -> int:
    """Blocks of the kernel's grid: each of the b rows' m centres in blocks
    of ``BQ_WARPS * warp_centres``."""
    return b * -(-m // (BQ_WARPS * warp_centres))


def ball_query_warp_centres(b: int, m: int, sms: int) -> int:
    """Centres a warp: the most in ``BQ_WARP_CENTRES`` that still leave
    ``BQ_MIN_WARPS_A_SM`` warps for each of the card's ``sms`` SMs (more
    centres a warp load each point for more pairs, fewer warps hide less
    latency); the fewest if none does."""
    return next((c for c in BQ_WARP_CENTRES if b * m >= c * BQ_MIN_WARPS_A_SM * sms),
                BQ_WARP_CENTRES[-1])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library, whose tile and block must be the ones above."""
    lib = _build.library()
    built = (lib.spacap_ball_query_tile_points(), lib.spacap_ball_query_warps())
    if built != (BQ_TILE_POINTS, BQ_WARPS):
        raise RuntimeError(f"ball_query: csrc/ball_query.cu has (tile, warps) = {built}, "
                           f"ops/ball_query.py assumes {(BQ_TILE_POINTS, BQ_WARPS)}")
    return lib


@functools.lru_cache(maxsize=None)
def ball_query_launch_info(device_index: int, warp_centres: int) -> dict:
    """The kernel's launch at ``warp_centres`` centres a warp on CUDA
    device ``device_index``: warps and centres a block, points a tile,
    shared memory a block (bytes), blocks an SM holds at once, and the
    device's SMs."""
    out = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device_index):
        err = _library().spacap_ball_query_launch_info(warp_centres, *map(ctypes.byref, out))
    _build.check(err, "ball_query launch info")
    return dict(warp_centres=warp_centres, warps=BQ_WARPS,
                centres_per_block=BQ_WARPS * warp_centres,
                tile_points=BQ_TILE_POINTS,
                **dict(zip(("shared_memory", "blocks_per_sm", "sms"), (o.value for o in out))))


@functools.lru_cache(maxsize=None)
def ball_query_default_warp_centres(device_index: int, b: int, m: int) -> int:
    """The centres a warp ``ball_query`` takes for (b, m) on that device."""
    sms = ball_query_launch_info(device_index, BQ_WARP_CENTRES[0])["sms"]
    return ball_query_warp_centres(b, m, sms)


def launch_ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int,
                      warp_centres: int) -> torch.Tensor:
    """One launch of the kernel on contiguous CUDA tensors at
    ``warp_centres`` centres a warp. Counts no launch: ``ball_query`` does."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    lib = _library()
    with torch.cuda.device(xyz.device):
        out = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
        err = lib.spacap_ball_query(
            xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, radius_sq(radius), nsample,
            warp_centres, out.data_ptr(),
            torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(err, f"ball_query ({warp_centres} centres a warp)")
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
    xyz, new_xyz = xyz.detach(), new_xyz.detach()   # no gradient: the indices track none
    if xyz.device.type == "cpu":
        return ball_query_plain(xyz, new_xyz, radius, nsample)
    if xyz.device.type != "cuda":
        raise ValueError(f"ball_query: unsupported device {xyz.device}")
    if not (xyz.is_contiguous() and new_xyz.is_contiguous()):
        raise ValueError("ball_query: inputs must be contiguous")
    c = ball_query_default_warp_centres(xyz.device.index, xyz.shape[0], new_xyz.shape[1])
    out = launch_ball_query(xyz, new_xyz, radius, nsample, c)
    ball_query.launches += 1
    return out


ball_query.launches = 0

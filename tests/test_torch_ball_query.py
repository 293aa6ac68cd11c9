"""The port's ball query against the JAX package on the CPU, at the inputs
that exercise the CUDA kernel's tiles, blocks of centres and early exit.

On CPU tensors ``ops.ball_query`` takes its plain version, whose arithmetic
is the kernel's (FMA chains, float32(r * r)); indices must equal
``_ball_query_xla`` and, where it is cheap, the Pallas kernel in interpret
mode. The kernel's own launch rule and constants are checked here too; the
kernel itself runs on the card (``chip_smoke.py`` holds it against the
plain version at these cases)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacap3d_tpu.ops.ball_query import _ball_query_xla
from spacap3d_tpu.ops.ball_query_pallas import ball_query_pallas
from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.ops.ball_query import BQ_MIN_WARPS_A_SM, radius_sq

TILE = ops.BQ_TILE_POINTS
BLOCK = ops.BQ_WARP_CENTRES[0] * ops.BQ_WARPS   # centres of the widest block


def _check(xyz, centers, radius, ns, pallas=True):
    """The port's indices, asserted equal to the XLA oracle's (and the
    Pallas kernel's in interpret mode)."""
    got = ops.ball_query(torch.from_numpy(xyz), torch.from_numpy(centers), radius, ns).numpy()
    jx, jc = jnp.asarray(xyz), jnp.asarray(centers)
    np.testing.assert_array_equal(got, np.asarray(_ball_query_xla(jx, jc, radius, ns)))
    if pallas:
        np.testing.assert_array_equal(got, np.asarray(ball_query_pallas(jx, jc, radius, ns, True)))
    return got


def _scene(rng, b, n, scale=6.0):
    pts = (rng.rand(b, n, 3) * scale).astype(np.float32)
    pts[..., 2] *= 0.5
    return pts


def _full(got):
    """Rows whose last slot holds a hit of its own (the centre took ns)."""
    return got[..., -1] != got[..., 0]


@pytest.mark.parametrize("ns", [16, 64])
def test_dense_cloud_fills_within_the_first_tile(rng, ns):
    xyz = _scene(rng, 2, TILE + 300, scale=0.3)
    centers = xyz[:, :48].copy()
    got = _check(xyz, centers, 0.2, ns)
    assert _full(got).mean() > 0.9
    assert got[_full(got)][:, -1].max() < TILE


def test_more_than_32_hits_in_one_chunk(rng):
    xyz = _scene(rng, 1, 300) + 10.0
    xyz[0, :70] = rng.uniform(-0.05, 0.05, (70, 3)).astype(np.float32)
    centers = np.zeros((1, 4, 3), np.float32)
    centers[0, 1:] = 20.0
    got = _check(xyz, centers, 0.2, 48)
    np.testing.assert_array_equal(got[0, 0], np.arange(48))


@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1])
def test_rows_at_the_tile_size_with_hits_on_the_tile_edge(rng, n):
    xyz = _scene(rng, 2, n)
    centers = xyz[:, :40].copy()
    near = centers[:, :1] + rng.uniform(-0.1, 0.1, (2, 12, 3)).astype(np.float32)
    lo = min(TILE - 6, n - 12)
    xyz[:, lo:lo + 12] = near
    got = _check(xyz, centers, 0.3, 16)
    assert {lo, lo + 11} <= set(got[0, 0].tolist()) | set(got[1, 0].tolist())


def test_rows_differ_and_m_is_no_multiple_of_a_block(rng):
    m = 2 * BLOCK + 5
    assert all(m % c for c in ops.BQ_WARP_CENTRES if c > 1) and m % BLOCK
    xyz = _scene(rng, 3, 600)
    centers = xyz[:, :m].copy()
    shift = (10.0 * np.arange(3, dtype=np.float32))[:, None, None]
    got = _check(xyz + shift, centers + shift, 0.4, 32)
    # each row's centres find their own row's points, which another row's lack
    np.testing.assert_array_equal(got, _check(xyz, centers, 0.4, 32, pallas=False))
    assert (got[..., 0] == 0).mean() < 0.5


def test_nsample_one(rng):
    xyz = _scene(rng, 2, 500)
    got = _check(xyz, xyz[:, 100:160].copy(), 0.4, 1)
    assert got.shape == (2, 60, 1)
    assert (got[..., 0] <= np.arange(100, 160)).all()   # the centre itself is a hit


def test_centres_with_no_hit_beside_centres_with_hits(rng):
    xyz = _scene(rng, 2, 700)
    centers = xyz[:, :64].copy()
    centers[:, 1::3] = 100.0
    got = _check(xyz, centers, 0.3, 16)
    np.testing.assert_array_equal(got[:, 1::3], 0)
    assert (got[:, 0::3] != got[:, 0::3, :1]).any()


@pytest.mark.parametrize("radius", [0.2, 0.4, 0.8])
def test_points_on_the_radius_boundary(rng, radius):
    """As chip_smoke.py::bq_input builds them: points at distance r around
    the first centres, which float32 rounding puts on both sides."""
    n, m, k = 900, 64, 48
    xyz = _scene(rng, 2, n)
    centers = xyz[:, :m].copy()
    d = rng.randn(2, k, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xyz[:, n - k:] = (centers[:, :k].astype(np.float64) + radius * d).astype(np.float32)
    got = _check(xyz, centers, radius, 32)
    d2 = ((xyz[:, n - k:] - centers[:, :k]) ** 2).sum(-1)
    assert (d2 < radius_sq(radius)).any() and (d2 >= radius_sq(radius)).any()
    assert (got >= n - k).any()


@pytest.mark.parametrize("b,m,sms,want", [
    (8, 2048, 132, 4),      # SA1: 4,096 warps of 4 centres, 31 an SM
    (8, 1024, 132, 4),      # SA2: 2,048 warps of 4 centres, 15.5 an SM
    (8, 512, 132, 1),       # SA3: 4 centres a warp would leave 7.8 warps an SM
    (8, 256, 132, 1),       # SA4 and vote aggregation
    (1, 16, 132, 1),        # no C leaves enough warps: the fewest centres
    (64, 2048, 132, 4),
    (3, 2 * 64 + 5, 2, 4),
])
def test_centres_a_warp_leave_warps_for_every_sm(b, m, sms, want):
    c = ops.ball_query_warp_centres(b, m, sms)
    assert c == want
    blocks = ops.ball_query_blocks(b, m, c)
    per_block = ops.BQ_WARPS * c
    # the blocks cover every row's centres, with less than a block to spare
    assert blocks % b == 0 and (blocks // b) * per_block >= m > (blocks // b - 1) * per_block
    more = [x for x in ops.BQ_WARP_CENTRES if x > c]
    assert all(b * m < x * BQ_MIN_WARPS_A_SM * sms for x in more)


def test_sa1_grid_is_one_wave():
    """SA1's 16,384 centres: 256 blocks of 16 warps of 4 centres on 132 SMs,
    at most 2 an SM, which an SM holds at once (2 x 40 KB of shared memory,
    2 x 16 of its 64 warps)."""
    c = ops.ball_query_warp_centres(8, 2048, 132)
    blocks = ops.ball_query_blocks(8, 2048, c)
    assert (c, blocks) == (4, 256)
    per_sm = -(-blocks // 132)
    assert per_sm == 2
    assert per_sm * _smem_bytes() <= 227 * 1024 and per_sm * ops.BQ_WARPS <= 64


def _smem_bytes():
    """The kernel's static shared memory: two raw x, y, z tiles and the
    packed (x, y, z, |p|^2) tile."""
    src = (_build.CSRC / "ball_query.cu").read_text()
    assert "__shared__ float raw[2][3 * kTile];" in src
    assert "__shared__ float4 tile[kTile];" in src
    return 2 * 3 * TILE * 4 + TILE * 16


def test_tile_warps_and_builds_match_the_kernel_source():
    src = (_build.CSRC / "ball_query.cu").read_text()
    assert f"constexpr int kTile = {ops.BQ_TILE_POINTS};" in src
    assert f"constexpr int kWarps = {ops.BQ_WARPS};" in src
    built = sorted(int(c) for c in re.findall(r"case (\d+): return ball_query_kernel<\1>;", src))
    assert built == sorted(ops.BQ_WARP_CENTRES)

"""The PyTorch port's geometry ops against the JAX package on the CPU.

Inputs are made from a seed with numpy and handed to both sides. On CPU
tensors the port's FPS and ball-query wrappers take their plain versions,
whose arithmetic is the CUDA kernels' (FMA chains, float32(r * r)), so
index outputs must be exactly equal to the JAX oracles and to the Pallas
kernels run in interpret mode."""
import ast
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacap3d_tpu import ops as jops
from spacap3d_tpu.ops.ball_query import _ball_query_xla
from spacap3d_tpu.ops.ball_query_pallas import ball_query_pallas
from spacap3d_tpu.ops.fps_pallas import furthest_point_sample_pallas
from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.ops._f32 import dot3
from spacap3d_tpu_torch.ops.fps import INIT_DIST, MAG_EPS

RADII = (0.2, 0.4, 0.8, 1.2, 0.3)   # SA1-SA4 and vote aggregation


def _fps_cloud(rng, b, n, lattice=False):
    xyz = rng.randn(b, n, 3).astype(np.float32) * 2
    if lattice:   # exact distance ties everywhere
        xyz = np.round(xyz * 2) / 2
    xyz[0, 5] = 0.0                      # never picked
    xyz[:, 7:11] = 0.01                  # ||p||^2 = 3e-4 <= 1e-3: never picked
    xyz[:, n - 20:n - 10] = xyz[:, 20:30]  # duplicates: exact ties
    return xyz


@pytest.mark.parametrize("b,n,m,lattice", [
    (2, 300, 64, False), (9, 256, 32, False), (2, 200, 48, True)])
def test_fps_matches_jax(rng, b, n, m, lattice):
    xyz = _fps_cloud(rng, b, n, lattice)
    got = ops.furthest_point_sample(torch.from_numpy(xyz), m).numpy()
    want = np.asarray(jops.furthest_point_sample_xla(jnp.asarray(xyz), m))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), m, True))
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32 and 5 not in got[0, 1:]


def test_fps_fewer_valid_points_than_npoint(rng):
    """After the valid points run out, picks repeat the lowest-index valid
    point (min-dist 0); an all-invalid row picks 0 throughout."""
    xyz = np.zeros((2, 40, 3), np.float32)
    xyz[0, [3, 9, 17, 30]] = rng.randn(4, 3).astype(np.float32) + 3
    got = ops.furthest_point_sample(torch.from_numpy(xyz), 12).numpy()
    want = np.asarray(jops.furthest_point_sample_xla(jnp.asarray(xyz), 12))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], 0)
    assert set(got[0, 4:]) == {3}


def _fps_by_ranks(xyz, npoint, c):
    """FPS as the cluster kernel (csrc/fps.cu) splits a row: c contiguous
    ranges of ceil(N / c) points (the last short or empty, padded with
    -FLT_MAX); each step takes every range's first maximum and merges the
    c winners in rank order, a strictly larger value taking over. Returns
    the picks and how many steps had a tie between two ranges."""
    b, n, _ = xyz.shape
    per = -(-n // c)
    x, y, z = xyz.unbind(-1)
    mind = torch.where(dot3(x, y, z, x, y, z) > MAG_EPS, INIT_DIST, -1.0).to(torch.float32)
    padded = torch.full((b, c * per), -torch.finfo(torch.float32).max)
    rows = torch.arange(b)
    last = torch.zeros(b, dtype=torch.long)
    out = torch.zeros((b, npoint), dtype=torch.int32)
    ties = 0
    for s in range(1, npoint):
        dx, dy, dz = (t - t[rows, last][:, None] for t in (x, y, z))
        mind = torch.minimum(mind, dot3(dx, dy, dz, dx, dy, dz))
        padded[:, :n] = mind
        ranges = padded.view(b, c, per)
        local = ranges.argmax(2)                       # each range's first maximum
        vals = ranges.gather(2, local[..., None])[..., 0]
        best_v, best_i = vals[:, 0], local[:, 0]
        for q in range(1, c):
            take = vals[:, q] > best_v
            best_v = torch.where(take, vals[:, q], best_v)
            best_i = torch.where(take, local[:, q] + q * per, best_i)
        ties += int(((vals == best_v[:, None]).sum(1) > 1).any())
        last = best_i
        out[:, s] = last.to(torch.int32)
    return out, ties


def _fps_rank_case(rng, case):
    if case == "ragged":        # 301 = no multiple of 3, 8 or 16; zeros and duplicates
        return _fps_cloud(rng, 2, 301), 64
    if case == "lattice":       # exact ties everywhere, across the ranges too
        return _fps_cloud(rng, 2, 200, lattice=True), 48
    xyz = np.zeros((2, 40, 3), np.float32)   # 4 valid points for 12 picks
    xyz[0, [3, 9, 17, 30]] = rng.randn(4, 3).astype(np.float32) + 3
    return xyz, 12


@pytest.mark.parametrize("case", ["ragged", "lattice", "sparse"])
@pytest.mark.parametrize("c", [1, 3, 8, 16])
def test_fps_partition_over_ranks_matches_jax(rng, c, case):
    """Splitting a row into contiguous ranges and merging the ranges' first
    maxima in rank order picks what the JAX oracle picks."""
    xyz, m = _fps_rank_case(rng, case)
    got, ties = _fps_by_ranks(torch.from_numpy(xyz), m, c)
    want = np.asarray(jops.furthest_point_sample_xla(jnp.asarray(xyz), m))
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "lattice" and c > 1:
        assert ties > 0
    if case == "sparse":
        assert set(got[0, 4:].tolist()) == {3} and not got[1].any()


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("kw", [{"cluster": 0}, {"cluster": 3}, {"cluster": 32},
                                {"cluster": 2.0}, {"threads": 48}, {"threads": 2048}])
def test_fps_refuses_other_cluster_sizes_and_block_sizes(device, kw):
    """A C outside FPS_CLUSTERS is refused; the wrapper takes no block size
    (measurements cap it through the C entry point)."""
    with pytest.raises(TypeError if "threads" in kw else ValueError, match="cluster|threads"):
        ops.furthest_point_sample(torch.ones(1, 8, 3, device=device), 4, **kw)


def test_fps_forced_cluster_takes_the_plain_version_on_cpu(rng):
    xyz = torch.from_numpy(_fps_cloud(rng, 2, 100))
    for c in ops.fps.FPS_CLUSTERS:
        assert torch.equal(ops.furthest_point_sample(xyz, 16, cluster=c),
                           ops.furthest_point_sample_plain(xyz, 16))


def test_fps_block_points_match_the_kernel_source():
    """ops/fps.py picks C and the kernel from the points a block holds; the
    kernel's constant must be the same (the wrapper also checks the built
    library on the card)."""
    src = (_build.CSRC / "fps.cu").read_text()
    assert f"constexpr int kBlockPoints = {ops.fps.FPS_BLOCK_POINTS};" in src


# co-resident clusters by size: one where a GPC holds two clusters of 16
# blocks, one where no cluster of 16 fits
_ROOMY = {1: 132, 2: 66, 4: 32, 8: 16, 16: 8}
_TIGHT = {1: 132, 2: 66, 4: 32, 8: 16, 16: 0}


@pytest.mark.parametrize("b,n,resident,want", [
    (8, 40000, _ROOMY, 16),      # SA1: every cluster of 16 resident at once
    (9, 40000, _ROOMY, 8),       # 9 clusters of 16 would take two waves
    (8, 40000, _TIGHT, 8),
    (8, 1024, _ROOMY, 1),        # aggregation: a split would leave blocks too small
    (8, 4096, _ROOMY, 4),
    (64, 40000, _ROOMY, 8),      # no one-wave split: the smallest that holds the row
    (2, 100000, _ROOMY, 16),
    (2, 100000, _TIGHT, 0),      # no cluster the device holds has room: streaming
    (2, 140000, _ROOMY, 0),
])
def test_fps_cluster_is_the_largest_that_runs_in_one_wave(b, n, resident, want):
    assert ops.fps_cluster(b, n, resident.__getitem__) == want


def _boundary_cloud(rng, b, n, m, r):
    """Centres, and points placed at distance r from them (the float32
    rounding scatters them just inside and just outside the radius)."""
    centers = (rng.rand(b, m, 3) * 3).astype(np.float32)
    d = rng.randn(b, n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    owner = rng.randint(0, m, (b, n))
    xyz = (np.take_along_axis(centers, owner[..., None], 1).astype(np.float64)
           + r * d).astype(np.float32)
    xyz[:, ::7] = (rng.rand(b, len(range(0, n, 7)), 3) * 3).astype(np.float32)
    centers[:, -2:] = 50.0                # no hit: zero rows
    return xyz, centers


@pytest.mark.parametrize("radius", RADII)
def test_ball_query_boundary_matches_jax(rng, radius):
    xyz, centers = _boundary_cloud(rng, 2, 600, 40, radius)
    got = ops.ball_query(torch.from_numpy(xyz), torch.from_numpy(centers), radius, 16).numpy()
    want = np.asarray(_ball_query_xla(jnp.asarray(xyz), jnp.asarray(centers), radius, 16))
    np.testing.assert_array_equal(got, want)
    pallas = ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), radius, 16, True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    # the boundary points really sit on both sides of the radius
    d2 = ((xyz[:, None] - centers[:, :, None]) ** 2).sum(-1)
    assert ((np.abs(d2 - radius * radius) < 1e-6) & (d2 < radius * radius)).any()
    np.testing.assert_array_equal(got[:, -2:], 0)


@pytest.mark.parametrize("b,n,m,ns,radius", [
    (2, 256, 64, 16, 0.3), (1, 300, 50, 8, 0.5), (3, 512, 96, 64, 0.25)])
def test_ball_query_matches_pallas_interpret(rng, b, n, m, ns, radius):
    xyz = (rng.rand(b, n, 3) * 2).astype(np.float32)
    centers = xyz[:, :m] + (rng.rand(b, m, 3) * 0.05).astype(np.float32)
    got = ops.ball_query(torch.from_numpy(xyz), torch.from_numpy(centers), radius, ns).numpy()
    want = np.asarray(ball_query_pallas(jnp.asarray(xyz), jnp.asarray(centers), radius, ns, True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(_ball_query_xla(jnp.asarray(xyz), jnp.asarray(centers), radius, ns)))


def test_ball_query_repeat_padding_and_chunking(rng):
    xyz = np.array([[[10, 0, 0], [0.1, 0, 0], [0, 0.1, 0], [9, 9, 9]]], np.float32)
    got = ops.ball_query(torch.from_numpy(xyz), torch.zeros(1, 1, 3), 0.5, 4).numpy()
    np.testing.assert_array_equal(got[0, 0], [1, 2, 1, 1])
    # chunking over centres changes nothing
    xyz = (rng.rand(2, 200, 3) * 2).astype(np.float32)
    t, c = torch.from_numpy(xyz), torch.from_numpy(xyz[:, :70].copy())
    np.testing.assert_array_equal(ops.ball_query_plain(t, c, 0.4, 8, chunk=16).numpy(),
                                  ops.ball_query_plain(t, c, 0.4, 8, chunk=70).numpy())


def test_radius_sq_is_double_product_rounded_once():
    for r in (0.2, 0.4, 0.8):
        # squaring the float32 radius lands one ulp above
        assert ops.ball_query.__module__
        from spacap3d_tpu_torch.ops.ball_query import radius_sq
        assert radius_sq(r) == float(np.float32(r * r))
        assert radius_sq(r) != float(np.float32(r) * np.float32(r))


def test_three_nn_and_interpolate_match_jax(rng):
    unknown = rng.randn(2, 40, 3).astype(np.float32)
    known = rng.randn(2, 17, 3).astype(np.float32)
    known[:, 5] = known[:, 2]            # duplicate: tie goes to the lower index
    d2, idx = ops.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    jd2, jidx = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5)   # as test_ops.py
    feats = rng.randn(2, 17, 6).astype(np.float32)
    w = rng.rand(2, 40, 3).astype(np.float32)
    got = ops.three_interpolate(torch.from_numpy(feats), idx, torch.from_numpy(w))
    want = jops.three_interpolate(jnp.asarray(feats), jidx, jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_nn_distance_matches_jax(rng):
    pc1 = rng.rand(2, 30, 3).astype(np.float32)
    pc2 = rng.rand(2, 11, 3).astype(np.float32)
    pc2[:, 4] = pc2[:, 1]                # ties: first index
    got = ops.nn_distance(torch.from_numpy(pc1), torch.from_numpy(pc2))
    want = jops.nn_distance(jnp.asarray(pc1), jnp.asarray(pc2))
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("radius", [0.4, None])
def test_grouping_matches_jax_exactly(rng, radius):
    cat = rng.randn(2, 64, 8).astype(np.float32)
    idx = rng.randint(0, 64, (2, 16, 8)).astype(np.int32)
    centers = rng.randn(2, 16, 3).astype(np.float32)
    got = ops.group_and_localize(torch.from_numpy(cat), torch.from_numpy(idx),
                                 torch.from_numpy(centers), radius)
    want = jops.group_and_localize(jnp.asarray(cat), jnp.asarray(idx), jnp.asarray(centers), radius)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ops.gather_points(torch.from_numpy(cat), torch.from_numpy(idx[:, :, 0])).numpy(),
        np.asarray(jops.gather_points(jnp.asarray(cat), jnp.asarray(idx[:, :, 0]))))


@pytest.mark.parametrize("with_heading", [False, True])
def test_box_corners_match_jax(rng, with_heading):
    size = (rng.rand(2, 5, 3) + 0.2).astype(np.float32)
    center = rng.randn(2, 5, 3).astype(np.float32)
    heading = rng.rand(2, 5).astype(np.float32) if with_heading else None
    got = ops.get_3d_box_batch(torch.from_numpy(size),
                               None if heading is None else torch.from_numpy(heading),
                               torch.from_numpy(center))
    want = jops.get_3d_box_batch(jnp.asarray(size),
                                 None if heading is None else jnp.asarray(heading),
                                 jnp.asarray(center))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_kernel_wrappers_refuse_other_devices_and_bad_inputs():
    meta = torch.zeros(1, 8, 3, device="meta")
    with pytest.raises(ValueError):
        ops.furthest_point_sample(meta, 4)
    with pytest.raises(ValueError):
        ops.ball_query(meta, meta, 0.2, 4)
    with pytest.raises(ValueError):
        ops.furthest_point_sample(torch.zeros(1, 8, 3, dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        ops.ball_query(torch.zeros(1, 8, 3), torch.zeros(2, 4, 3), 0.2, 4)


def test_cpu_calls_do_not_count_as_launches(rng):
    before = (ops.furthest_point_sample.launches, ops.ball_query.launches)
    xyz = torch.from_numpy(rng.rand(1, 32, 3).astype(np.float32))
    ops.ball_query(xyz, ops.gather_points(xyz, ops.furthest_point_sample(xyz, 4)), 0.3, 4)
    assert (ops.furthest_point_sample.launches, ops.ball_query.launches) == before


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA kernels cannot be built")))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "no-such-build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spacap3d_tpu_torch\n"
        "for m in pkgutil.walk_packages(spacap3d_tpu_torch.__path__, 'spacap3d_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.') or n == 'jaxlib'"
        " or n.startswith('jaxlib.') or n == 'spacap3d_tpu' or n.startswith('spacap3d_tpu.')]\n"
        "mods = [n for n in sys.modules if n.startswith('spacap3d_tpu_torch.')]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 15, res.stdout

    # chip_smoke.py runs on a machine without JAX: none of its imports,
    # at any depth of its AST, may name jax, jaxlib or the JAX package
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "spacap3d_tpu_torch" in {n.split(".")[0] for n in names}, names
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "spacap3d_tpu")]
    assert not bad, bad


def _path_strings(source):
    """String literals of ``source`` that name a path into the JAX package
    or its host library (``spacap3d_tpu/...``, ``native/...``, or the bare
    directory as an ``os.path.join`` part); docstrings aside."""
    tree = ast.parse(source)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    pattern = re.compile(r"(^|[^\w])(spacap3d_tpu|native)([/\\]|$)")
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs and pattern.search(n.value)]


def test_port_reads_no_jax_package_file_by_path():
    """The port's metadata files and synthetic writer are its own: no
    string in its code names a file of the JAX package or of ``native/``."""
    assert _path_strings("p = os.path.join(ROOT, 'spacap3d_tpu', 'data')\n") == ["spacap3d_tpu"]
    assert _path_strings("lib = f'{root}/native/libspacap_host.so'\n")
    assert not _path_strings('"""Reads spacap3d_tpu/data/meta."""\nx = "spacap3d_tpu_torch/_build"\n')
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "spacap3d_tpu_torch")
    found = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    hits = _path_strings(f.read())
                if hits:
                    found[os.path.relpath(os.path.join(dirpath, name), root)] = hits
    assert not found, found


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """Every module of the port, its command lines under ``scripts/``
    included, names neither JAX nor the JAX package in an import at any
    depth of its AST (imports inside functions, which importing the
    module does not run, too)."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "spacap3d_tpu_torch")
    checked, bad = set(), {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                     for a in n.names]
            names += [n.module for n in ast.walk(tree)
                      if isinstance(n, ast.ImportFrom) and n.module and not n.level]
            rel = os.path.relpath(path, root)
            checked.add(rel)
            hits = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "spacap3d_tpu")]
            if hits:
                bad[rel] = hits
    assert not bad, bad
    for rel in ("scripts/train.py", "scripts/eval.py", "scripts/overfit_gate.py",
                "scripts/profile_step.py", "train/solver.py", "utils/checkpoint.py",
                "parallel/multihost.py", "parallel/mesh.py", "parallel/tp.py",
                "parallel/mp_dryrun.py"):
        assert rel in checked, rel

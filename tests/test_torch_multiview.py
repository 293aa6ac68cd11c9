"""The port's multiview path against the JAX package's on the CPU: the
projection functions (``data/projection.py``, equal under ``==``) and the
three command lines, ENet features, features onto points (HDF5) and labels
onto points (PLY), on the synthetic frames of ``tests/test_aux_scripts.py``.

The feature files and the HDF5 agree within the ENet tolerance of
``tests/test_torch_enet.py`` (1e-4 of the largest magnitude). Labels are an
argmax of the logits: a point's label may differ only where a frame it
projects into has a near tie (top-2 gap within that tolerance) in the JAX
logits."""
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacap3d_tpu.data import projection as jax_proj
from spacap3d_tpu.models.enet import ENET_CLASSIFIER_KEY, enet_for_3d
from spacap3d_tpu.models.enet import init_enet as jax_init_enet
from spacap3d_tpu.utils.convert import load_torch_state_dict
from spacap3d_tpu.utils.convert_enet import convert_enet_state_dict
from spacap3d_tpu_torch.data import projection as port_proj
from spacap3d_tpu_torch.models.enet import init_enet
from spacap3d_tpu_torch.scripts import compute_multiview_features as port_features
from spacap3d_tpu_torch.scripts import project_multiview_features as port_project
from spacap3d_tpu_torch.scripts import project_multiview_labels as port_labels
from test_aux_scripts import frames_world  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import compute_multiview_features as jax_features  # noqa: E402
import project_multiview_features as jax_project  # noqa: E402
import project_multiview_labels as jax_labels  # noqa: E402

REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def helpers(w=16, h=12, near=0.1, far=10.0):
    intr = np.eye(4)
    intr[0, 0] = intr[1, 1] = 10.0
    intr[0, 2], intr[1, 2] = (w - 1) / 2, (h - 1) / 2
    return (jax_proj.ProjectionHelper(intr, near, far, (w, h)),
            port_proj.ProjectionHelper(intr, near, far, (w, h)))


def look_at(rng):
    """A camera-to-world pose: a random position, looking at the room's
    middle through a random roll."""
    eye = rng.uniform([-1, -1, 0.5], [4, 4, 2.5])
    fwd = np.array([1.5, 1.5, 0.5]) + rng.normal(0, 0.3, 3) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, rng.normal(0, 1, 3))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, down, fwd], 1)
    pose[:3, 3] = eye
    return pose


def random_scene(seed, n=3000, frames=5, w=16, h=12):
    """Points in a 3 x 3 x 1 m room, frames from random poses with depth maps
    rendered from the points themselves (the nearest point a pixel, 0 where
    none lands) plus features and labels."""
    rng = np.random.RandomState(seed)
    points = rng.uniform([0, 0, 0], [3, 3, 1], (n, 3))
    helper = helpers(w, h)[0]
    out = []
    for _ in range(frames):
        pose = look_at(rng)
        cam = (np.concatenate([points, np.ones((n, 1))], 1) @ np.linalg.inv(pose).T)[:, :3]
        z = cam[:, 2]
        px = np.round(cam[:, 0] / z * helper.intrinsic[0, 0] + helper.intrinsic[0, 2])
        py = np.round(cam[:, 1] / z * helper.intrinsic[1, 1] + helper.intrinsic[1, 2])
        ok = (z > 0) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        depth = np.full((h, w), np.inf)
        np.minimum.at(depth, (py[ok].astype(int), px[ok].astype(int)), z[ok])
        depth[np.isinf(depth)] = 0
        out.append({"pose": pose, "depth": depth,
                    "features": rng.normal(0, 1, (h, w, 8)).astype(np.float32),
                    "labels": rng.randint(0, 6, (h, w))})
    return points, out


def projection_cases():
    """The cases of tests/test_multiview.py, then random scenes."""
    f1 = np.zeros((12, 16, 4), np.float32)
    f1[6, 8] = [1, 5, 0, 2]
    f2 = np.zeros((12, 16, 4), np.float32)
    f2[6, 8] = [3, 1, 0, 2]
    lab = np.zeros((12, 16), int)
    lab[6, 8] = 3
    cases = []
    for d in (2.0, 3.0, 2.04):
        cases.append((np.array([[0.0, 0.0, 2.0], [100.0, 0.0, 2.0], [0.0, 0.0, -1.0],
                                [0.0, 0.0, -5.0]]),
                      [{"features": f, "labels": lab, "depth": np.full((12, 16), d),
                        "pose": np.eye(4)} for f in (f1, f2)]))
    return cases + [random_scene(s) for s in range(3)]


@pytest.mark.parametrize("case", range(6))
def test_projection_functions_equal_jax(case):
    points, frames = projection_cases()[case]
    jh, ph = helpers()
    seen = 0
    for fr in frames:
        np.testing.assert_array_equal(ph.frustum_corners(fr["pose"]),
                                      jh.frustum_corners(fr["pose"]))
        np.testing.assert_array_equal(ph.points_in_frustum(points, fr["pose"]),
                                      jh.points_in_frustum(points, fr["pose"]))
        got, want = (h.project_points(points, fr["depth"], fr["pose"]) for h in (ph, jh))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        seen += int(want[0].sum())
        got, want = (h.project_features(points, fr["features"], fr["depth"], fr["pose"])
                     for h in (ph, jh))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert seen > 0 or case == 1          # depth 3.0 occludes the one visible point
    np.testing.assert_array_equal(port_proj.aggregate_frames_maxpool(points, frames, ph),
                                  jax_proj.aggregate_frames_maxpool(points, frames, jh))
    for ignore in (False, True):
        np.testing.assert_array_equal(
            port_proj.project_labels_majority(points, frames, ph, 6, ignore_zero=ignore),
            jax_proj.project_labels_majority(points, frames, jh, 6, ignore_zero=ignore))
    np.testing.assert_array_equal(port_proj.project_labels_fill(points, frames, ph),
                                  jax_proj.project_labels_fill(points, frames, jh))


def test_map_helpers_and_hdf5_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    depth = rng.uniform(0.5, 4, (480, 640))
    for h, w in ((32, 41), (60, 80), (7, 9)):
        np.testing.assert_array_equal(port_proj.resample_depth_to_map(depth, h, w),
                                      jax_proj.resample_depth_to_map(depth, h, w))
    intr = np.array([[577.9, 0, 319.5, 0], [0, 577.9, 239.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    for dims in ((41, 32), (80, 60)):
        got = port_proj.make_map_projection_helper(intr, depth.shape, dims, 0.1, 4.0)
        want = jax_proj.make_map_projection_helper(intr, depth.shape, dims, 0.1, 4.0)
        np.testing.assert_array_equal(got.intrinsic, want.intrinsic)
        assert (got.depth_min, got.depth_max, got.image_dims) == (
            want.depth_min, want.depth_max, want.image_dims)
    import h5py

    feats = {"scene0000_00": rng.rand(50, 128).astype(np.float32),
             "scene0001_00": rng.rand(20, 128).astype(np.float32)}
    port_proj.write_multiview_hdf5(str(tmp_path / "a" / "f.hdf5"), feats)
    jax_proj.write_multiview_hdf5(str(tmp_path / "b" / "f.hdf5"), feats)
    with h5py.File(tmp_path / "a" / "f.hdf5") as a, h5py.File(tmp_path / "b" / "f.hdf5") as b:
        assert sorted(a) == sorted(b) == sorted(feats)
        for k in feats:
            np.testing.assert_array_equal(a[k][...], b[k][...])


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def run_jax_cli(module, argv):
    """The JAX package's CLIs read ``sys.argv`` where they take no argv."""
    bak = sys.argv
    try:
        sys.argv = ["x", *argv]
        module.main()
    finally:
        sys.argv = bak


@pytest.fixture()
def weights(frames_world, tmp_path):  # noqa: F811
    """A reference-keyed ``.pth`` of seeded port weights (BN stats moved),
    which both packages' CLIs read."""
    model = init_enet(seed=4, device="cpu")
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.05, m.num_features)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, m.num_features)))
    path = str(tmp_path / "enet.pth")
    torch.save(model.state_dict(), path)
    return path


def test_feature_and_projection_clis_match_jax(frames_world, weights):  # noqa: F811
    import h5py

    root, scene, scene_dir, frames_root, (h, w) = frames_world
    common = ["--frames_root", frames_root, "--image_h", str(h), "--image_w", str(w),
              "--enet_ckpt", weights]
    run_jax_cli(jax_features, [*common, "--out_root", os.path.join(root, "jf")])
    port_features.main([*common, "--out_root", os.path.join(root, "pf"), "--device", "cpu"])
    names = sorted(os.listdir(os.path.join(root, "jf", scene)))
    assert names == sorted(os.listdir(os.path.join(root, "pf", scene))) == ["0.npy", "20.npy"]
    for name in names:
        want = np.load(os.path.join(root, "jf", scene, name))
        got = np.load(os.path.join(root, "pf", scene, name))
        assert got.shape == want.shape == (h // 8, w // 8, 128) and got.dtype == np.float32
        assert rel_err(got, want) <= REL_TOL, rel_err(got, want)

    outs = {}
    for side, feats in (("jax", "jf"), ("port", "pf"), ("port_on_jax", "jf")):
        out = os.path.join(root, f"{side}.hdf5")
        argv = ["--scene_dir", scene_dir, "--frames_root", frames_root,
                "--features_root", os.path.join(root, feats), "--out", out]
        if side == "jax":
            run_jax_cli(jax_project, argv)
        else:
            port_project.main(argv)
        with h5py.File(out) as f:
            outs[side] = f[scene][...]
    assert outs["jax"].shape == (200, 128) and np.abs(outs["jax"]).sum() > 0
    np.testing.assert_array_equal(outs["port_on_jax"], outs["jax"])   # host code: equal
    assert rel_err(outs["port"], outs["jax"]) <= REL_TOL


def ply_colors(path):
    with open(path) as f:
        lines = f.read().split("end_header\n", 1)[1].strip().splitlines()
    return np.array([ln.split()[3:6] for ln in lines], int)


@pytest.mark.parametrize("maxpool", [False, True])
def test_label_cli_matches_jax_up_to_near_ties(frames_world, weights, maxpool):  # noqa: F811
    root, scene, scene_dir, frames_root, (h, w) = frames_world
    argv = ["--scene_id", scene, "--scene_dir", scene_dir, "--frames_root", frames_root,
            "--image_h", str(h), "--image_w", str(w), "--enet_ckpt", weights]
    argv += ["--maxpool"] if maxpool else []
    jax_labels.main([*argv, "--out_root", os.path.join(root, "jl")])
    port_labels.main([*argv, "--out_root", os.path.join(root, "pl"), "--device", "cpu"])
    jply, pply = (os.path.join(root, d, scene + ".ply") for d in ("jl", "pl"))
    with open(jply, "rb") as a, open(pply, "rb") as b:
        if a.read() == b.read():
            return
    # points whose label differs must see a near tie of the JAX logits
    params, state, _ = convert_enet_state_dict(load_torch_state_dict(weights),
                                               *jax_init_enet(jax.random.PRNGKey(0)))
    color_dir = os.path.join(frames_root, scene, "color")
    files = sorted(os.listdir(color_dir))
    imgs = np.stack([jax_features.load_image(os.path.join(color_dir, f), h, w) for f in files])
    logits = np.asarray(enet_for_3d(params, state, jnp.asarray(imgs))[1])
    top2 = np.sort(logits, -1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= REL_TOL * np.abs(logits).max()
    points = np.load(os.path.join(scene_dir, scene + "_aligned_vert.npy"))[:, :3]
    intr = np.loadtxt(os.path.join(frames_root, scene, "intrinsic.txt")).reshape(4, 4)
    helper = jax_proj.make_map_projection_helper(intr, (h, w), (w // 8, h // 8), 0.1, 4.0)
    touches = np.zeros(len(points), bool)
    for f, nr in zip(files, near):
        fid = os.path.splitext(f)[0]
        depth = jax_project.read_depth(os.path.join(frames_root, scene, "depth", fid + ".png"))
        valid, pix = helper.project_points(
            points, jax_proj.resample_depth_to_map(depth, h // 8, w // 8),
            jax_project.read_pose(os.path.join(frames_root, scene, "pose", fid + ".txt")))
        touches[valid] |= nr[pix[valid, 1], pix[valid, 0]]
    differ = (ply_colors(jply) != ply_colors(pply)).any(1)
    assert not (differ & ~touches).any(), np.where(differ & ~touches)[0]


def test_label_cli_uses_the_classifier_of_a_numpy_pickle(frames_world):  # noqa: F811
    """``tests/test_aux_scripts.py::test_project_labels_uses_classifier_logits``
    through the port: a classifier forced to class 40 (zero kernel, a bias
    the reference lacks) in a pickle of numpy trees; both CLIs write the
    same PLY, every labelled point in palette[40]."""
    root, scene, scene_dir, frames_root, (h, w) = frames_world
    params, state = jax.tree_util.tree_map(np.asarray, jax_init_enet(jax.random.PRNGKey(0)))
    bias = np.zeros((41,), np.float32)
    bias[40] = 10.0
    params[ENET_CLASSIFIER_KEY] = {"kernel": np.zeros_like(params[ENET_CLASSIFIER_KEY]["kernel"]),
                                   "bias": bias}
    ckpt = os.path.join(root, "forced_enet.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump({"params": params, "state": state}, f)
    argv = ["--scene_id", scene, "--scene_dir", scene_dir, "--frames_root", frames_root,
            "--image_h", str(h), "--image_w", str(w), "--enet_ckpt", ckpt]
    port_labels.main([*argv, "--out_root", os.path.join(root, "pl"), "--device", "cpu"])
    jax_labels.main([*argv, "--out_root", os.path.join(root, "jl")])
    with open(os.path.join(root, "pl", scene + ".ply"), "rb") as a, \
            open(os.path.join(root, "jl", scene + ".ply"), "rb") as b:
        assert a.read() == b.read()
    colors = ply_colors(os.path.join(root, "pl", scene + ".ply"))
    assert colors.shape == (200, 3)
    labeled = (colors != 0).any(1)
    assert labeled.sum() > 100
    assert (colors[labeled] == np.asarray(port_labels.NYU40_PALETTE[40])).all()


@pytest.mark.parametrize("cli", [port_features, port_labels])
def test_enet_clis_refuse_cuda_when_absent(frames_world, cli):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    root, scene, scene_dir, frames_root, _ = frames_world
    argv = ["--frames_root", frames_root, "--out_root", os.path.join(root, "o")]
    if cli is port_labels:
        argv += ["--scene_dir", scene_dir]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)

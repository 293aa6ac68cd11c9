"""The port's offline data preparation against the JAX package's on the
same synthetic raw scans and annotations: every file the port's command
lines write is byte-equal to the JAX CLI's (the flows of
``tests/test_preprocess.py`` and ``tests/test_aux_scripts.py``), the
library functions behind them equal under ``==``, and the spatiality
heatmaps draw equal matrices and tick labels (PNG bytes, or pixels where
the bytes differ)."""
import csv
import json
import os
import sys

import numpy as np
import pytest

from spacap3d_tpu.data import organize as jax_organize
from spacap3d_tpu.data import preprocess as jax_pre
from spacap3d_tpu.data.spatiality import plot_relation_heatmap as jax_heatmap
from spacap3d_tpu.utils import visualize as jax_vis
from spacap3d_tpu_torch.data import organize as port_organize
from spacap3d_tpu_torch.data import preprocess as port_pre
from spacap3d_tpu_torch.data.scannet_config import scannet_split
from spacap3d_tpu_torch.data.spatiality import plot_relation_heatmap as port_heatmap
from spacap3d_tpu_torch.data.synthetic import write_synthetic_dataset
from spacap3d_tpu_torch.scripts import align_axis as port_align
from spacap3d_tpu_torch.scripts import batch_load_scannet_data as port_batch_load
from spacap3d_tpu_torch.scripts import generate_spatiality_label as port_gen_spatiality
from spacap3d_tpu_torch.scripts import organize_referit3d as port_org_referit
from spacap3d_tpu_torch.scripts import organize_scanrefer as port_org_scanrefer
from spacap3d_tpu_torch.scripts import split_referit3d as port_split_referit
from spacap3d_tpu_torch.scripts import visualize_scene as port_vis_scene
from spacap3d_tpu_torch.scripts import visualize_spatiality as port_vis_spatiality
from spacap3d_tpu_torch.utils import visualize as port_vis
from test_preprocess import make_raw_scene, write_binary_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import align_axis as jax_align  # noqa: E402
import batch_load_scannet_data as jax_batch_load  # noqa: E402
import generate_spatiality_label as jax_gen_spatiality  # noqa: E402
import organize_referit3d as jax_org_referit  # noqa: E402
import organize_scanrefer as jax_org_scanrefer  # noqa: E402
import split_referit3d as jax_split_referit  # noqa: E402
import visualize_scene as jax_vis_scene  # noqa: E402
import visualize_spatiality as jax_vis_spatiality  # noqa: E402

TSV = os.path.join(REPO, "spacap3d_tpu_torch", "data", "scannetv2-labels.combined.tsv")
# scene0000_00 and scene0001_00 are ScanNet train scenes, scene0011_00 a val one
SCENES = ["scene0000_00", "scene0001_00", "scene0011_00"]


def run_argv(module, argv):
    """The JAX package's visualize_scene reads ``sys.argv``."""
    bak = sys.argv
    try:
        sys.argv = ["x", *argv]
        module.main()
    finally:
        sys.argv = bak


def tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def assert_same_files(a, b, want=None):
    got, ref = tree_bytes(a), tree_bytes(b)
    assert sorted(got) == sorted(ref), (sorted(got), sorted(ref))
    assert ref and (want is None or len(ref) == want), sorted(ref)
    for name in ref:
        assert got[name] == ref[name], name


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scans"))
    rng = np.random.RandomState(0)
    for sid in SCENES:
        make_raw_scene(root, sid, rng)
    return root


@pytest.mark.parametrize("flags", [[], ["--scene_list"], ["--no_relations", "--quiet"]])
def test_batch_load_scannet_data_writes_the_jax_files(scans, tmp_path, flags):
    argv = ["--scans_dir", scans, "--label_tsv", TSV] + [f for f in flags if f != "--scene_list"]
    if "--scene_list" in flags:
        lst = str(tmp_path / "scenes.txt")
        with open(lst, "w") as f:
            f.write("scene0011_00\n")
        argv += ["--scene_list", lst]
    jax_batch_load.main([*argv, "--output_dir", str(tmp_path / "jax")])
    port_batch_load.main([*argv, "--output_dir", str(tmp_path / "port")])
    n_scenes = 1 if "--scene_list" in flags else 3
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"),
                      n_scenes * (6 if "--no_relations" in flags else 9))


def test_batch_load_default_label_map_and_scene_lists_equal_jax(scans, tmp_path):
    """Without ``--label_tsv`` each CLI reads its own package's copy of the
    label map; without ``--scene_list`` its own split lists."""
    jax_batch_load.main(["--scans_dir", scans, "--output_dir", str(tmp_path / "jax")])
    port_batch_load.main(["--scans_dir", scans, "--output_dir", str(tmp_path / "port")])
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), 27)
    with pytest.raises(SystemExit):
        port_batch_load.main(["--scans_dir", str(tmp_path / "none"),
                              "--output_dir", str(tmp_path / "x")])
    for split in ("train", "val", "test"):
        from spacap3d_tpu.data.scannet_config import scannet_split as jax_split
        assert scannet_split(split) == jax_split(split)


def test_preprocess_functions_equal_jax(scans, tmp_path):
    base = os.path.join(scans, "scene0000_00", "scene0000_00")
    got, want = (m.read_ply_mesh(base + "_vh_clean_2.ply") for m in (port_pre, jax_pre))
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    xyz = np.stack([want[0][c] for c in "xyz"], 1).astype(np.float64)
    np.testing.assert_array_equal(port_pre.compute_vertex_normals(xyz, want[1]),
                                  jax_pre.compute_vertex_normals(xyz, want[1]))
    np.testing.assert_array_equal(port_pre.read_axis_align_matrix(base + ".txt"),
                                  jax_pre.read_axis_align_matrix(base + ".txt"))
    assert port_pre.read_label_map(TSV) == jax_pre.read_label_map(TSV)
    # an ascii ply, as the visualizers write it
    ascii_ply = str(tmp_path / "a.ply")
    jax_vis.write_ply(xyz, ascii_ply, (np.abs(xyz) * 50).astype(np.uint8))
    got, want = (m.read_ply_mesh(ascii_ply) for m in (port_pre, jax_pre))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] is None and want[1] is None
    # more points than the cap: the same subsample
    big = str(tmp_path / "big")
    rng = np.random.RandomState(1)
    n = port_pre.MAX_NUM_POINT + 7
    os.makedirs(os.path.join(big, "scene0002_00"))
    bbase = os.path.join(big, "scene0002_00", "scene0002_00")
    write_binary_ply(bbase + "_vh_clean_2.ply", rng.rand(n, 3).astype(np.float32),
                     (rng.rand(n, 3) * 255).astype(np.uint8),
                     np.stack([np.arange(30), np.arange(1, 31), np.arange(2, 32)], 1))
    with open(bbase + "_vh_clean_2.0.010000.segs.json", "w") as f:
        json.dump({"segIndices": [i % 4 for i in range(n)]}, f)
    with open(bbase + ".aggregation.json", "w") as f:
        json.dump({"segGroups": [{"objectId": 0, "label": "chair", "segments": [0, 1]},
                                 {"objectId": 1, "label": "wall", "segments": [2]}]}, f)
    with open(bbase + ".txt", "w") as f:
        f.write("axisAlignment = 0 -1 0 1 1 0 0 2 0 0 1 0 0 0 0 1\n")
    label_map = jax_pre.read_label_map(TSV)
    for m, out in ((port_pre, "port"), (jax_pre, "jax")):
        m.export_scene(big, "scene0002_00", label_map, str(tmp_path / out))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), 9)


SCANREFER = [
    {"scene_id": "scene0000_00", "object_id": "1", "ann_id": "0",
     "description": "a red chair", "token": ["a", "red", "chair"]},
    {"scene_id": "scene0000_00", "object_id": "1", "ann_id": "1",
     "description": "the chair", "token": ["the", "chair"]},
    {"scene_id": "scene0011_00", "object_id": "2", "ann_id": "0",
     "description": "a table", "token": ["a", "table"]},
]


@pytest.mark.parametrize("layout", ["combined", "splits"])
def test_organize_scanrefer_writes_the_jax_file(tmp_path, layout):
    for side in ("jax", "port"):
        root = tmp_path / side
        root.mkdir()
        if layout == "combined":
            (root / "ScanRefer_filtered.json").write_text(json.dumps(SCANREFER))
        else:
            (root / "ScanRefer_filtered_train.json").write_text(json.dumps(SCANREFER[:2]))
            (root / "ScanRefer_filtered_val.json").write_text(json.dumps(SCANREFER[2:]))
        (jax_org_scanrefer if side == "jax" else port_org_scanrefer).main(
            ["--data_root", str(root)])
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), 2 if layout == "combined"
                      else 3)
    with pytest.raises(SystemExit):
        port_org_scanrefer.main(["--data_root", str(tmp_path / "empty")])


def write_nr3d(path):
    rows = [
        {"scan_id": "scene0000_00", "target_id": "3",
         "instance_type": "office chair", "utterance": "The red chair."},
        {"scan_id": "scene0000_00", "target_id": "3",
         "instance_type": "office chair", "utterance": "Chair by the desk."},
        {"scan_id": "scene0011_00", "target_id": "5",
         "instance_type": "table", "utterance": "A round table."},
        {"scan_id": "sceneXXXX_00", "target_id": "9",
         "instance_type": "ghost", "utterance": "Not in any split."},
    ]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def test_split_and_organize_referit3d_write_the_jax_files(tmp_path):
    for side, split, org in (("jax", jax_split_referit, jax_org_referit),
                             ("port", port_split_referit, port_org_referit)):
        root = tmp_path / side
        root.mkdir()
        write_nr3d(str(root / "nr3d.csv"))
        split.main(["--csv", str(root / "nr3d.csv"), "--data_root", str(root)])
        os.rename(root / "nr3d_organized.json", root / "split_organized.json")
        org.main(["--csv", str(root / "nr3d.csv"), "--data_root", str(root)])
        # from the csv alone, without the split files
        csv_only = tmp_path / f"{side}_csv"
        csv_only.mkdir()
        org.main(["--csv", str(root / "nr3d.csv"), "--data_root", str(csv_only)])
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), 5)
    assert_same_files(str(tmp_path / "port_csv"), str(tmp_path / "jax_csv"), 3)
    anns = [{"scene_id": "s1", "object_id": 3, "ann_id": "0", "x": 1},
            {"scene_id": "s1", "object_id": "3", "x": 2}]
    assert port_organize.organize(anns) == jax_organize.organize(anns)
    for text in ("The RED chair, next-to table!", "", "a1 b_2"):
        assert port_organize.tokenize(text) == jax_organize.tokenize(text)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    anns, scene_ids = write_synthetic_dataset(root, num_scenes=3, seed=7)
    return root, anns, scene_ids


@pytest.mark.parametrize("dataset", ["scanrefer", "nr3d"])
def test_generate_spatiality_label_writes_the_jax_files(synthetic, tmp_path, dataset):
    src, anns, scene_ids = synthetic
    name = ("ScanRefer_filtered_train.json" if dataset == "scanrefer" else "nr3d_train.json")
    for side in ("jax", "port"):
        data = tmp_path / side / "scannet" / "scannet_data"
        data.mkdir(parents=True)
        for sid in scene_ids:
            for f in ("aligned_bbox",):
                np.save(data / f"{sid}_{f}.npy", np.load(
                    os.path.join(src, "scannet", "scannet_data", f"{sid}_{f}.npy")))
        np.save(data / "scene0099_00_aligned_bbox.npy", np.zeros((0, 8)))
        listed = anns + [{**anns[0], "scene_id": s} for s in ("scene0099_00", "scene0098_00")]
        (tmp_path / side / name).write_text(json.dumps(listed))
        (jax_gen_spatiality if side == "jax" else port_gen_spatiality).main(
            ["--dataset", dataset, "--data_root", str(tmp_path / side), "--verbose"])
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), 1 + 3 * 4 + 1)


def test_align_axis_writes_the_jax_files(tmp_path):
    """One scene with an axis alignment and one without."""
    for side in ("jax", "port"):
        for s, sid in enumerate(SCENES[:2]):
            make_raw_scene(str(tmp_path / side), sid, np.random.RandomState(s))
        with open(tmp_path / side / "scene0000_00" / "scene0000_00.txt", "w") as f:
            f.write("sceneType = Office\n")
        with open(tmp_path / side / "scene0001_00" / "scene0001_00.txt", "w") as f:
            f.write("axisAlignment = 0 -1 0 1 1 0 0 2 0 0 1 0 0 0 0 1\n")
    for argv in (["--quiet"], ["--scene_id", "scene0001_00"]):
        jax_align.main(["--scans_dir", str(tmp_path / "jax"), *argv])
        port_align.main(["--scans_dir", str(tmp_path / "port"), *argv])
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), 10)


@pytest.mark.parametrize("by_instance", [False, True])
def test_visualize_scene_writes_the_jax_files(synthetic, tmp_path, by_instance):
    root, _, scene_ids = synthetic
    argv = ["--scene_dir", os.path.join(root, "scannet", "scannet_data"),
            "--scene_id", scene_ids[1]] + (["--color_by_instance"] if by_instance else [])
    run_argv(jax_vis_scene, [*argv, "--out_dir", str(tmp_path / "jax")])
    port_vis_scene.main([*argv, "--out_dir", str(tmp_path / "port")])
    n_boxes = len(np.load(os.path.join(root, "scannet", "scannet_data",
                                       f"{scene_ids[1]}_aligned_bbox.npy")))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), 2 + n_boxes)


def test_visualize_writers_equal_jax(tmp_path):
    rng = np.random.RandomState(5)
    pts = rng.rand(40, 3)
    cols = (rng.rand(40, 3) * 255).astype(np.uint8)
    corners = [rng.rand(8, 3) for _ in range(3)]
    for side, m in (("jax", jax_vis), ("port", port_vis)):
        m.write_obj(pts, str(tmp_path / side / "a.obj"), cols)
        m.write_obj(pts, str(tmp_path / side / "b.obj"))
        m.write_scene_dump(pts, corners, [0, 5, 21], str(tmp_path / side / "dump"), "scene9",
                           colors=cols)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), 6)


def png_pixels(path):
    import matplotlib.image

    return matplotlib.image.imread(path)


def test_visualize_spatiality_draws_the_jax_heatmap(synthetic, tmp_path):
    """``visualize_spatiality --savefig`` and ``generate_spatiality_label
    --savefig`` draw the same PNG as the JAX CLIs; ``plot_relation_heatmap``
    the same matrix and tick labels."""
    src, _, scene_ids = synthetic
    sid = scene_ids[0]
    pngs = {}
    for side in ("jax", "port"):
        data = tmp_path / side
        data.mkdir()
        for f in ("aligned_bbox", "x", "y", "z"):
            name = f"{sid}_{f}.npy"
            np.save(data / name, np.load(os.path.join(src, "scannet", "scannet_data", name)))
        vis = jax_vis_spatiality if side == "jax" else port_vis_spatiality
        vis.main(["--scannet_data", str(data), "--scene_id", sid, "--axis", "y", "--savefig"])
        vis.main(["--scannet_data", str(data), "--scene_id", sid, "--axis", "x", "--verbose",
                  "--regenerate", "--dryrun"])
        gen = jax_gen_spatiality if side == "jax" else port_gen_spatiality
        gen.main(["--scannet_data", str(data), "--scene_id", sid, "--axis", "z", "--savefig"])
        pngs[side] = {ax: str(data / f"{sid}_{ax}.png") for ax in ("y", "z")}
    for ax in ("y", "z"):
        with open(pngs["port"][ax], "rb") as a, open(pngs["jax"][ax], "rb") as b:
            if a.read() != b.read():
                np.testing.assert_array_equal(png_pixels(pngs["port"][ax]),
                                              png_pixels(pngs["jax"][ax]))
    import matplotlib.pyplot as plt

    matrix = np.load(os.path.join(src, "scannet", "scannet_data", f"{sid}_x.npy"))
    labels = [f"{i}-{i + 3}" for i in range(len(matrix))]
    figs = [f(matrix, labels, "x", sid) for f in (port_heatmap, jax_heatmap)]
    for a, b in zip(*(fig.axes for fig in figs)):
        np.testing.assert_array_equal(a.images[0].get_array() if a.images else [],
                                      b.images[0].get_array() if b.images else [])
        assert [t.get_text() for t in a.get_xticklabels()] == \
            [t.get_text() for t in b.get_xticklabels()]
        assert [t.get_text() for t in a.get_yticklabels()] == \
            [t.get_text() for t in b.get_yticklabels()]
        assert [t.get_text() for t in a.texts] == [t.get_text() for t in b.texts]
    assert [t.get_text() for t in figs[0].axes[0].get_xticklabels()] == labels
    for fig in figs:
        plt.close(fig)

"""The port's data layer against the JAX package's on the CPU: the synthetic
writer, ``ScanReferDataset`` items, ``DataLoader`` and ``GridLoader``
batches and the ``Vocabulary``, on the same files. Everything here is host
numpy with the same RNG schedule, so every comparison is bit for bit."""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from spacap3d_tpu.config import DataConfig as JaxDataConfig
from spacap3d_tpu.data.dataset import ScanReferDataset as JaxDataset
from spacap3d_tpu.data.dataset import Scene as JaxScene
from spacap3d_tpu.data.dataset import SceneStore as JaxSceneStore
from spacap3d_tpu.data.loader import DataLoader as JaxDataLoader
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig as JaxDatasetConfig
from spacap3d_tpu.data.synthetic import write_synthetic_dataset as jax_write_synthetic_dataset
from spacap3d_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from spacap3d_tpu.eval.mul_eval import GridLoader as JaxGridLoader
from spacap3d_tpu_torch.config import DataConfig
from spacap3d_tpu_torch.data.dataset import ScanReferDataset, Scene, SceneStore
from spacap3d_tpu_torch.data.loader import DataLoader
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu_torch.data.synthetic import write_synthetic_dataset
from spacap3d_tpu_torch.data.vocabulary import Vocabulary
from spacap3d_tpu_torch.eval.mul_eval import GridLoader
from spacap3d_tpu_torch.train.step import gather_point_table, to_device_batch
from spacap3d_tpu_torch.utils import trace

NUM_POINTS = 1024
DATA = dict(num_points=NUM_POINTS, use_relation=True, max_des_len=7)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_data"))
    anns, scene_ids = write_synthetic_dataset(root, num_scenes=3, seed=5)
    return root, anns, scene_ids


def datasets(root, split, augment):
    """(port, JAX) datasets over the same files; val takes one annotation
    a scene (the eval protocol), train every annotation."""
    path, anns, scene_ids = root
    if split == "val":
        seen = set()
        anns = [a for a in anns if not (a["scene_id"] in seen or seen.add(a["scene_id"]))]
    rel = split == "train"
    port = ScanReferDataset(
        anns, SceneStore(os.path.join(path, "scannet", "scannet_data"), scene_ids,
                         load_relations=rel),
        Vocabulary.build(anns, max_len=7), ScannetDatasetConfig(),
        DataConfig(data_root=path, augment=augment, **DATA), split=split)
    ref = JaxDataset(
        anns, JaxSceneStore(os.path.join(path, "scannet", "scannet_data"), scene_ids,
                            load_relations=rel),
        JaxVocabulary.build(anns, max_len=7), JaxDatasetConfig(),
        JaxDataConfig(data_root=path, augment=augment, **DATA), split=split)
    return port, ref


def assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_synthetic_writer_writes_the_jax_files(root, tmp_path):
    path, anns, scene_ids = root
    want_anns, want_ids = jax_write_synthetic_dataset(str(tmp_path), num_scenes=3, seed=5)
    assert anns == want_anns and scene_ids == want_ids
    names = sorted(os.listdir(os.path.join(path, "scannet", "scannet_data")))
    assert names == sorted(os.listdir(tmp_path / "scannet" / "scannet_data"))
    assert len(names) == 3 * 7
    for name in names:
        with open(os.path.join(path, "scannet", "scannet_data", name), "rb") as f:
            assert f.read() == (tmp_path / "scannet" / "scannet_data" / name).read_bytes(), name
    with open(os.path.join(path, "ScanRefer_filtered_all.json")) as f:
        assert json.load(f) == json.loads((tmp_path / "ScanRefer_filtered_all.json").read_text())


# train items under each feature branch: the height's dtype and the
# colour's follow the concatenated cloud's (float32 for xyz, normals and
# multiview of a float32 mesh; float64 with colour or a float64 mesh)
FEATURES = {
    "xyz": dict(use_height=False),
    "colour": dict(use_color=True, use_height=False),
    "normal": dict(use_normal=True, use_height=False),
    "multiview": dict(use_multiview=True, use_height=False),
    "all": dict(use_color=True, use_normal=True, use_multiview=True, use_height=True),
    "normal-multiview-height": dict(use_normal=True, use_multiview=True, use_height=True),
}
BRANCHES = [pytest.param("train", True, f, m, id=f"train-True-{f}-{m}")
            for f in FEATURES for m in ("float32", "float64")]


def scene_arrays(root, mesh_dtype):
    """Each scene's arrays from the files, its mesh cast to ``mesh_dtype``,
    with 128 multiview features a point (float32)."""
    path, _, scene_ids = root
    rng = np.random.RandomState(9)
    out = {}
    for sid in scene_ids:
        base = os.path.join(path, "scannet", "scannet_data", sid)
        a = {k: np.load(f"{base}_{k}.npy") for k in ("aligned_vert", "ins_label", "sem_label",
                                                      "aligned_bbox", "x", "y", "z")}
        a["aligned_vert"] = a["aligned_vert"].astype(mesh_dtype)
        a["multiview"] = rng.rand(len(a["ins_label"]), 128).astype(np.float32)
        out[sid] = a
    return out


def train_datasets(root, features, mesh_dtype):
    """(port, JAX) train datasets with augmentation and relations over
    in-memory scenes, under a feature branch of ``FEATURES``."""
    _, anns, _ = root
    arrays = scene_arrays(root, mesh_dtype)
    data = dict(DATA, data_root=root[0], augment=True, **FEATURES[features])

    def store(cls):
        return {sid: cls(mesh_vertices=a["aligned_vert"], instance_labels=a["ins_label"],
                         semantic_labels=a["sem_label"], instance_bboxes=a["aligned_bbox"],
                         relations={ax: a[ax] for ax in ("x", "y", "z")},
                         multiview=a["multiview"]) for sid, a in arrays.items()}

    port = ScanReferDataset(anns, store(Scene), Vocabulary.build(anns, max_len=7),
                            ScannetDatasetConfig(), DataConfig(**data), split="train")
    ref = JaxDataset(anns, store(JaxScene), JaxVocabulary.build(anns, max_len=7),
                     JaxDatasetConfig(), JaxDataConfig(**data), split="train")
    return port, ref


@pytest.mark.parametrize("split,augment,features,mesh", [
    pytest.param("val", False, None, None, id="val-False"),
    pytest.param("train", True, None, None, id="train-True"),
    *BRANCHES])
def test_items_equal_jax(root, split, augment, features, mesh):
    """Items equal the JAX package's bit for bit; an item given batch rows
    (``out``) writes its point block and votes there, equal to the item
    built without them, and returns those rows."""
    if features is None:
        port, ref = datasets(root, split, augment)
    else:
        port, ref = train_datasets(root, features, np.dtype(mesh))
    assert len(port) == len(ref) and port.scene_list == ref.scene_list
    for idx in range(0, len(port), max(1, len(port) // 4)):
        got = port.__getitem__(idx, rng=np.random.RandomState(idx + 3))
        want = ref.__getitem__(idx, rng=np.random.RandomState(idx + 3))
        assert_same_arrays(got, want)
        batch = {k: np.full((3,) + shape, np.nan, np.float32)
                 for k, shape in port.in_place_leaves().items()}
        rows = {k: v[1] for k, v in batch.items()}
        placed = port.__getitem__(idx, rng=np.random.RandomState(idx + 3), out=rows)
        assert_same_arrays(placed, want)
        for k, row in rows.items():
            assert placed[k] is row
            assert np.isnan(batch[k][0]).all() and np.isnan(batch[k][2]).all()
    assert got["point_clouds"].shape == port.in_place_leaves()["point_clouds"]
    if split == "train":
        assert {"x_label", "y_label", "z_label"} <= set(got)
        assert got["vote_label_mask"].any()
    with pytest.raises(ValueError, match="point_clouds"):
        port.__getitem__(0, rng=np.random.RandomState(0),
                         out={"point_clouds": np.zeros((NUM_POINTS, 2), np.float32)})


@pytest.mark.parametrize("num_workers", [2, 4])
def test_train_loader_batches_equal_jax(root, num_workers):
    """Train batches (augmentation, relations, multiview and normals) equal
    the JAX loader's; each batch kept owns its point block and votes; every
    item went into its batch in place, and the stack copied the rest."""
    port, ref = train_datasets(root, "all", np.dtype("float32"))
    kw = dict(batch_size=4, shuffle=True, seed=6, num_workers=num_workers)
    trace.enable()
    try:
        got = list(DataLoader(port, **kw))
    finally:
        records = trace.disable()
    want = list(JaxDataLoader(ref, **kw))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert_same_arrays(g, w)
    for k in port.in_place_leaves():
        for a, b in itertools.combinations(got, 2):
            assert not np.shares_memory(a[k], b[k]), k
    items = [r for r in records if r["name"] == "loader.item"]
    assert len(items) == 4 * len(got) and all(r["attrs"]["in_place"] for r in items)
    stacks = sorted((r for r in records if r["name"] == "loader.stack"),
                    key=lambda r: r["request"])
    assert [r["request"] for r in stacks] == list(range(len(got)))
    for r, g in zip(stacks, got):
        stacked = sum(v.nbytes for k, v in g.items()
                      if k not in ("point_clouds", "vote_label", "__valid__"))
        assert r["attrs"]["bytes"] == stacked


@pytest.mark.parametrize("with_points", [True, False])
def test_getitem_cached_equals_jax_and_getitem(root, with_points):
    port, ref = datasets(root, "val", False)
    for idx in range(len(port)):
        got = port.getitem_cached(idx, np.random.RandomState(7), with_points=with_points)
        assert_same_arrays(got, ref.getitem_cached(idx, np.random.RandomState(7),
                                                   with_points=with_points))
        if with_points:
            assert_same_arrays(got, port.__getitem__(idx, rng=np.random.RandomState(7)))
    np.testing.assert_array_equal(port.full_cloud_f32(1), ref.full_cloud_f32(1))
    with pytest.raises(ValueError, match="getitem_cached"):
        datasets(root, "train", True)[0].getitem_cached(0, np.random.RandomState(0))


@pytest.mark.parametrize("shuffle", [False, True])
def test_data_loader_batches_equal_jax(root, shuffle):
    port, ref = datasets(root, "val", False)
    kw = dict(batch_size=2, shuffle=shuffle, seed=4, num_workers=2)
    got, want = list(DataLoader(port, **kw)), list(JaxDataLoader(ref, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same_arrays(g, w)
    np.testing.assert_array_equal(got[-1]["__valid__"], [True, False])


@pytest.mark.parametrize("indices_mode", [False, True])
def test_grid_loader_batches_equal_jax(root, indices_mode):
    port, ref = datasets(root, "val", False)
    keys = sorted({"pc_choices" if indices_mode else "point_clouds", "dataset_idx",
                   "gt_box_corner_label"})
    kw = dict(seeds=[0, 3], batch_size=4, num_workers=2, keys=keys, indices_mode=indices_mode)
    got, want = list(GridLoader(port, **kw)), list(JaxGridLoader(ref, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same_arrays(g, w)
    np.testing.assert_array_equal(got[0]["__seed__"], [0, 0, 0, 3])
    np.testing.assert_array_equal(got[1]["__valid__"], [True, True, False, False])


def test_vocabulary_equals_jax_and_round_trips(root, tmp_path):
    _, anns, _ = root
    vocab, ref = Vocabulary.build(anns, max_len=7), JaxVocabulary.build(anns, max_len=7)
    assert vocab.word2idx == ref.word2idx and vocab.idx2word == ref.idx2word
    glove = ["the", "chair", "red", "table"]
    filtered = Vocabulary.build(anns, glove_vocab=glove)
    assert filtered.word2idx == JaxVocabulary.build(anns, glove_vocab=glove).word2idx
    assert set(filtered.word2idx) == {"pad_", "unk", "sos", "eos", *glove}
    for ann in anns[:10]:
        ids = vocab.encode(ann["token"], max_len=7)
        np.testing.assert_array_equal(ids, ref.encode(ann["token"], max_len=7))
        assert vocab.decode(ids[1:]) == ref.decode(ids[1:])
        assert vocab.decode(ids[1:]).split() == ["sos", *ann["token"][:7], "eos"]
    assert vocab.encode(["nosuchword"], max_len=3).tolist() == [2, 1, 3, 0, 0]
    assert vocab.decode([5, 6]).split()[-1] == "eos"
    vocab.save(str(tmp_path / "v.json"))
    loaded = Vocabulary.load(str(tmp_path / "v.json"))
    assert loaded.word2idx == vocab.word2idx and loaded.idx2word == vocab.idx2word


def test_uint16_choices_gather_past_int16(tmp_path):
    """A scene of 38,000 points: ``getitem_cached`` ships uint16 indices,
    about one in seven above 32,767; the eval step's point-table gather of them equals
    the host gather."""
    anns, scene_ids = write_synthetic_dataset(
        str(tmp_path), num_scenes=1, seed=2, anns_per_object=1, num_objects=4,
        points_per_object=2000, background_points=30000)
    ds = ScanReferDataset(
        anns[:1], SceneStore(str(tmp_path / "scannet" / "scannet_data"), scene_ids),
        Vocabulary.build(anns), ScannetDatasetConfig(),
        DataConfig(data_root=str(tmp_path), num_points=4096, augment=False), split="val")
    item = ds.getitem_cached(0, np.random.RandomState(1), with_points=False)
    choices = item["pc_choices"]
    assert choices.dtype == np.uint16 and choices.max() > 32767
    assert (choices > 32767).mean() > 0.1
    batch = to_device_batch({"pc_choices": choices[None], "scene_row": np.zeros(1, np.int32),
                             "point_table": ds.full_cloud_f32(0)[None],
                             "center_table": item["center_label"][None]}, torch.device("cpu"))
    assert batch["pc_choices"].dtype == torch.uint16
    got = gather_point_table(batch)["point_clouds"][0].numpy()
    want = ds.getitem_cached(0, np.random.RandomState(1))["point_clouds"]
    np.testing.assert_array_equal(got, want)


def test_items_with_every_feature_equal_jax(root, tmp_path):
    """Colour, normals, multiview features from an hdf5 file and GloVe
    embeddings (``lang_feat``): every feature branch of the item build."""
    import h5py

    path, anns, scene_ids = root
    mv = str(tmp_path / "multiview.hdf5")
    rng = np.random.RandomState(0)
    with h5py.File(mv, "w") as f:
        for sid in scene_ids:
            n = len(np.load(os.path.join(path, "scannet", "scannet_data", f"{sid}_ins_label.npy")))
            f.create_dataset(sid, data=rng.rand(n, 128).astype(np.float32))
    glove = {w: rng.rand(300).astype(np.float32) for w in ["unk", "sos", "eos", "the", "chair"]}
    data = dict(DATA, data_root=path, augment=False, use_color=True, use_normal=True,
                use_multiview=True)
    scene_dir = os.path.join(path, "scannet", "scannet_data")
    port = ScanReferDataset(anns, SceneStore(scene_dir, scene_ids, multiview_hdf5=mv),
                            Vocabulary.build(anns, max_len=7), ScannetDatasetConfig(),
                            DataConfig(**data), split="val", glove=glove)
    ref = JaxDataset(anns, JaxSceneStore(scene_dir, scene_ids, multiview_hdf5=mv),
                     JaxVocabulary.build(anns, max_len=7), JaxDatasetConfig(),
                     JaxDataConfig(**data), split="val", glove=glove)
    got = port.__getitem__(2, rng=np.random.RandomState(1))
    assert_same_arrays(got, ref.__getitem__(2, rng=np.random.RandomState(1)))
    assert got["point_clouds"].shape == (NUM_POINTS, 3 + 3 + 3 + 128 + 1)
    assert got["lang_feat"].shape == (9, 300) and got["lang_feat"].any()

"""Synthetic ScanNet-like scenes and ScanRefer-like annotations, made in
memory from a seed: a frozen copy of the program's makers
(``data/synthetic.py::make_scene`` and ``make_annotations``), with caption
words drawn from the whole vocabulary of the configuration and, for a
multiview configuration, a 128-channel feature a point.

A scene is boxes filled with points over a floor of background points in a
6 x 6 m room; its relation matrices are computed from its boxes."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench.reference.spacap.config import SPECIAL_TOKENS
from portbench.reference.spacap.data.scannet_config import ScannetDatasetConfig
from portbench.reference.spacap.data.spatiality import generate_relation_labels
from portbench.reference.spacap.data.vocabulary import Vocabulary


def seed32(seed: int, *salt: int) -> int:
    """A 32-bit numpy seed from any whole number and a salt."""
    return int(np.random.SeedSequence([int(seed) % (2 ** 63), *salt]).generate_state(1)[0])


def make_scene(rng: np.random.RandomState, num_objects: int, points_per_object: int,
               background_points: int, extent: float = 6.0) -> Dict[str, np.ndarray]:
    """One scene's arrays: ``aligned_vert`` (N, 9) xyz rgb normal,
    ``ins_label``, ``sem_label``, ``aligned_bbox`` (M, 8) and the relation
    labels ``x``, ``y``, ``z``."""
    boxes, pts, ins, sem = [], [], [], []
    nyu_ids = [3, 4, 5, 6, 7, 8, 9, 10][: max(num_objects, 1)]
    for i in range(num_objects):
        size = rng.uniform(0.4, 1.4, 3)
        center = np.array([rng.uniform(0.5, extent - 0.5), rng.uniform(0.5, extent - 0.5),
                           rng.uniform(0.3, 1.5)])
        nyu = nyu_ids[i % len(nyu_ids)]
        boxes.append(np.concatenate([center, size, [nyu, i]]))
        pts.append(center + (rng.rand(points_per_object, 3) - 0.5) * size)
        ins.append(np.full(points_per_object, i + 1))
        sem.append(np.full(points_per_object, nyu))
    bg = np.stack([rng.uniform(0, extent, background_points),
                   rng.uniform(0, extent, background_points),
                   np.abs(rng.randn(background_points)) * 0.02], axis=1)
    pts.append(bg)
    ins.append(np.zeros(background_points))
    sem.append(np.full(background_points, 2))
    xyz = np.concatenate(pts).astype(np.float32)
    rgb = (np.clip(rng.rand(len(xyz), 3), 0, 1) * 255).astype(np.float32)
    normals = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (len(xyz), 1))
    arrays = {
        "aligned_vert": np.concatenate([xyz, rgb, normals], axis=1),
        "ins_label": np.concatenate(ins).astype(np.int64),
        "sem_label": np.concatenate(sem).astype(np.int64),
        "aligned_bbox": np.stack(boxes),
    }
    arrays.update(generate_relation_labels(arrays["aligned_bbox"]))
    return arrays


def words(vocab_size: int) -> List[str]:
    return [f"w{i}" for i in range(vocab_size - len(SPECIAL_TOKENS))]


def vocabulary(vocab_size: int) -> Tuple[Dict[str, int], Dict[str, str]]:
    """(word2idx, idx2word) over the special tokens and every word."""
    all_words = list(SPECIAL_TOKENS) + words(vocab_size)
    return ({w: i for i, w in enumerate(all_words)},
            {str(i): w for i, w in enumerate(all_words)})


def make_annotations(rng: np.random.RandomState, scene_id: str, bboxes: np.ndarray,
                     anns_per_object: int, vocab_size: int) -> List[dict]:
    """``anns_per_object`` annotations of 5-13 words for each box."""
    dc = ScannetDatasetConfig()
    pool = words(vocab_size)
    anns = []
    for row in bboxes:
        nyu, obj_id = int(row[6]), int(row[7])
        name = dc.class2type[dc.nyu40id2class.get(nyu, 17)].replace(" ", "_")
        for a in range(anns_per_object):
            tokens = [pool[i] for i in rng.randint(0, len(pool), rng.randint(5, 14))]
            anns.append({"scene_id": scene_id, "object_id": str(obj_id), "object_name": name,
                         "ann_id": str(a), "description": " ".join(tokens), "token": tokens})
    return anns


def make_split(seed: int, num_scenes: int, anns_per_object: int, scene: Dict,
               vocab_size: int, multiview: bool = False):
    """-> (scene arrays by scene id, annotations). With ``multiview`` each
    scene also carries ``multiview`` (N, 128) float32 in [0, 1)."""
    rng = np.random.RandomState(seed32(seed, 1))
    scenes, anns = {}, []
    for s in range(num_scenes):
        sid = f"scene{s:04d}_00"
        arrays = make_scene(rng, **scene)
        anns += make_annotations(rng, sid, arrays["aligned_bbox"], anns_per_object, vocab_size)
        scenes[sid] = arrays
    if multiview:
        gen = np.random.default_rng(seed32(seed, 2))
        for sid in scenes:
            n = len(scenes[sid]["aligned_vert"])
            scenes[sid]["multiview"] = gen.random((n, 128), dtype=np.float32)
    return scenes, anns


class Store:
    """The scene store a dataset reads (``store[scene_id]``)."""

    def __init__(self, scenes: Dict):
        self.scenes = scenes

    def __getitem__(self, sid):
        return self.scenes[sid]


def store(scene_cls, arrays: Dict[str, Dict[str, np.ndarray]]) -> Store:
    """A store of ``scene_cls`` objects (the program's ``Scene`` or the
    reference's) over the same arrays."""
    return Store({sid: scene_cls(
        mesh_vertices=a["aligned_vert"], instance_labels=a["ins_label"],
        semantic_labels=a["sem_label"], instance_bboxes=a["aligned_bbox"],
        relations={ax: a[ax] for ax in ("x", "y", "z")},
        multiview=a.get("multiview")) for sid, a in arrays.items()})


def reference_vocabulary(vocab_size: int) -> Vocabulary:
    return Vocabulary(*vocabulary(vocab_size))

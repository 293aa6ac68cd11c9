"""Synthetic ScanNet-like data, built from seeded numpy streams.

``write_synthetic_dataset`` writes scenes and ScanRefer-style annotations
in the on-disk format the real preprocessing emits, so the dataset, the
loader and the eval harness run end to end without the ScanNet release;
with the same arguments it writes the same files as the JAX package's
``spacap3d_tpu/data/synthetic.py``. ``train_batch`` builds a training batch
in memory: every key the train step reads, with the shapes and dtypes of
the dataset's items; its caption is SOS, random word ids, EOS and pads,
and ``lang_label`` prepends id 1, as the dataset does, so that position 0
passes the decoder's ``token > 0`` mask.

A scene is a few axis-aligned boxes filled with points, over a floor of
background points, in a 6 x 6 m room.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from spacap3d_tpu_torch.config import EOS_ID, GT_VOTE_FACTOR, MAX_NUM_OBJ, SOS_ID
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig, mean_size_arr
from spacap3d_tpu_torch.data.spatiality import generate_relation_labels

ROOM = 6.0
NUM_OBJECTS = 6          # boxes a scene, as the JAX package's synthetic batch
FIRST_WORD = EOS_ID + 1

_WORDS = [
    "the", "a", "chair", "table", "brown", "red", "large", "small", "next",
    "to", "door", "window", "wooden", "on", "left", "right", "corner", "room",
    "this", "is", "near", "it", "desk", "bed", "sofa", "shelf", "cabinet",
]


def make_scene(
    rng: np.random.RandomState,
    num_objects: int = 6,
    points_per_object: int = 800,
    background_points: int = 3000,
    extent: float = 6.0,
) -> Dict[str, np.ndarray]:
    """One scene's arrays, keyed by their file suffix: ``aligned_vert``
    (N, 9) xyz rgb normal, ``ins_label``, ``sem_label``, ``aligned_bbox``
    (M, 8) and the relation labels ``x``, ``y``, ``z``."""
    boxes = []
    pts, ins, sem = [], [], []
    nyu_ids = [3, 4, 5, 6, 7, 8, 9, 10][: max(num_objects, 1)]
    for i in range(num_objects):
        size = rng.uniform(0.4, 1.4, 3)
        center = np.array([
            rng.uniform(0.5, extent - 0.5),
            rng.uniform(0.5, extent - 0.5),
            rng.uniform(0.3, 1.5),
        ])
        nyu = nyu_ids[i % len(nyu_ids)]
        boxes.append(np.concatenate([center, size, [nyu, i]]))
        pts.append(center + (rng.rand(points_per_object, 3) - 0.5) * size)
        ins.append(np.full(points_per_object, i + 1))
        sem.append(np.full(points_per_object, nyu))
    # background: floor (instance 0, semantic 2 — an excluded class)
    bg = np.stack([
        rng.uniform(0, extent, background_points),
        rng.uniform(0, extent, background_points),
        np.abs(rng.randn(background_points)) * 0.02,
    ], axis=1)
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


def make_annotations(
    rng: np.random.RandomState, scene_id: str, bboxes: np.ndarray,
    anns_per_object: int = 2, dc: Optional[ScannetDatasetConfig] = None,
) -> List[dict]:
    """``anns_per_object`` ScanRefer-style annotations of 5-13 random
    words for each box of the scene."""
    dc = dc or ScannetDatasetConfig()
    anns = []
    for row in bboxes:
        nyu, obj_id = int(row[6]), int(row[7])
        name = dc.class2type[dc.nyu40id2class.get(nyu, 17)].replace(" ", "_")
        for a in range(anns_per_object):
            tokens = [_WORDS[rng.randint(len(_WORDS))] for _ in range(rng.randint(5, 14))]
            anns.append({
                "scene_id": scene_id,
                "object_id": str(obj_id),
                "object_name": name,
                "ann_id": str(a),
                "description": " ".join(tokens),
                "token": tokens,
            })
    return anns


def write_synthetic_dataset(
    root: str, num_scenes: int = 4, seed: int = 0, anns_per_object: int = 2,
    **scene_kwargs
) -> Tuple[List[dict], List[str]]:
    """Writes scenes under <root>/scannet/scannet_data and a ScanRefer-style
    annotation json at <root>/ScanRefer_filtered_all.json. Returns
    (annotations, scene_ids)."""
    rng = np.random.RandomState(seed)
    scene_dir = os.path.join(root, "scannet", "scannet_data")
    os.makedirs(scene_dir, exist_ok=True)
    dc = ScannetDatasetConfig()
    all_anns: List[dict] = []
    scene_ids = []
    for s in range(num_scenes):
        sid = f"scene{s:04d}_00"
        scene_ids.append(sid)
        arrays = make_scene(rng, **scene_kwargs)
        for name, arr in arrays.items():
            np.save(os.path.join(scene_dir, f"{sid}_{name}.npy"), arr)
        all_anns += make_annotations(rng, sid, arrays["aligned_bbox"],
                                     anns_per_object=anns_per_object, dc=dc)
    with open(os.path.join(root, "ScanRefer_filtered_all.json"), "w") as f:
        json.dump(all_anns, f)
    return all_anns, scene_ids


def _scene(rng: np.random.RandomState, cfg, msa: np.ndarray) -> Dict:
    n, num_objects = cfg.num_points, NUM_OBJECTS
    sizes = rng.uniform(0.4, 1.4, (num_objects, 3))
    centers = np.stack([rng.uniform(0.5, ROOM - 0.5, num_objects),
                        rng.uniform(0.5, ROOM - 0.5, num_objects),
                        rng.uniform(0.3, 1.5, num_objects)], 1)
    classes = rng.randint(0, cfg.num_size_cluster, num_objects)
    per_object = n // (2 * num_objects)
    pts, inst = [], []
    for i in range(num_objects):
        pts.append(centers[i] + (rng.rand(per_object, 3) - 0.5) * sizes[i])
        inst.append(np.full(per_object, i))
    bg = n - per_object * num_objects
    pts.append(np.stack([rng.uniform(0, ROOM, bg), rng.uniform(0, ROOM, bg),
                         np.abs(rng.randn(bg)) * 0.02], 1))
    inst.append(np.full(bg, -1))
    order = rng.permutation(n)
    xyz = np.concatenate(pts)[order]
    inst = np.concatenate(inst)[order]

    # votes: the offset to the AABB centre of the point's object, 3 times
    votes = np.zeros((n, 3))
    for i in range(num_objects):
        sel = inst == i
        votes[sel] = 0.5 * (xyz[sel].min(0) + xyz[sel].max(0)) - xyz[sel]
    height = xyz[:, 2] - np.percentile(xyz[:, 2], 0.99)

    boxes = np.concatenate([centers, sizes], 1)
    rel = generate_relation_labels(boxes)
    item = {
        "point_clouds": np.concatenate([xyz, height[:, None]], 1),
        "vote_label": np.tile(votes, (1, GT_VOTE_FACTOR)),
        "vote_label_mask": (inst >= 0).astype(np.int64),
        "center_label": np.zeros((MAX_NUM_OBJ, 3)),
        "heading_class_label": np.zeros(MAX_NUM_OBJ, np.int64),
        "heading_residual_label": np.zeros(MAX_NUM_OBJ),
        "size_class_label": np.zeros(MAX_NUM_OBJ, np.int64),
        "size_residual_label": np.zeros((MAX_NUM_OBJ, 3)),
        "sem_cls_label": np.zeros(MAX_NUM_OBJ, np.int64),
        "box_label_mask": np.zeros(MAX_NUM_OBJ),
    }
    item["center_label"][:num_objects] = centers
    item["size_class_label"][:num_objects] = classes
    item["size_residual_label"][:num_objects] = sizes - msa[classes]
    item["sem_cls_label"][:num_objects] = classes
    item["box_label_mask"][:num_objects] = 1
    item["box_label_mask_int"] = item["box_label_mask"].astype(np.int64)
    for ax in ("x", "y", "z"):
        mat = np.zeros((MAX_NUM_OBJ, MAX_NUM_OBJ), np.int64)
        mat[:num_objects, :num_objects] = rel[ax]
        item[f"{ax}_label"] = mat
    item["ref_center_label"] = centers[rng.randint(num_objects)]

    max_des = cfg.max_des_len
    words = rng.randint(FIRST_WORD, cfg.vocab_size, rng.randint(max(1, max_des // 3), max_des + 1))
    lang_ids = np.zeros(max_des + 2, np.int64)
    lang_ids[:len(words) + 2] = [SOS_ID, *words, EOS_ID]
    item["lang_ids"] = lang_ids
    item["lang_label"] = np.concatenate([[1], lang_ids]).astype(np.int64)
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in item.items()}


def train_batch(cfg, batch_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A training batch of ``batch_size`` synthetic scenes of
    ``cfg.num_points`` points: numpy arrays keyed as the dataset's."""
    rng = np.random.RandomState(seed)
    msa = mean_size_arr()
    items = [_scene(rng, cfg, msa) for _ in range(batch_size)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}

"""Synthetic training batches: every key the train step reads, with the
shapes and dtypes of the JAX package's dataset items
(``spacap3d_tpu/data/dataset.py``), built from one seeded numpy stream.

A scene is a few axis-aligned boxes filled with points, over a floor of
background points, in a 6 x 6 m room. The caption is SOS, random word ids,
EOS and pads; ``lang_label`` prepends id 1, as the dataset does, so that
position 0 passes the decoder's ``token > 0`` mask.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from spacap3d_tpu_torch.config import EOS_ID, GT_VOTE_FACTOR, MAX_NUM_OBJ, SOS_ID
from spacap3d_tpu_torch.data.meta import mean_size_arr
from spacap3d_tpu_torch.data.spatiality import generate_relation_labels

ROOM = 6.0
NUM_OBJECTS = 6          # boxes a scene, as the JAX package's synthetic batch
FIRST_WORD = EOS_ID + 1


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

"""Annotation reshaping utilities, a copy of ``spacap3d_tpu/data/organize.py``
that writes the same files byte for byte.

The reference's organize/split scripts (SURVEY.md §2.4):
  * organize_annotations (scripts/organize_scanrefer.py,
    organize_referit3d.py): flat list -> {scene: {obj: {ann: entry}}};
  * split_referit3d (scripts/split_referit3d.py): the Nr3D/ReferIt3D csv
    -> train/val json lists by ScanNet split, with tokenization.
"""
from __future__ import annotations

import csv
import json
import os
import re
from typing import Dict, List, Tuple

from spacap3d_tpu_torch.data.scannet_config import scannet_split

_TOKEN_RE = re.compile(r"[a-zA-Z0-9]+")


def tokenize(text: str) -> List[str]:
    return [t.lower() for t in _TOKEN_RE.findall(text)]


def organize(annotations: List[dict]) -> Dict:
    out: Dict = {}
    for ann in annotations:
        out.setdefault(ann["scene_id"], {}).setdefault(
            str(ann["object_id"]), {}
        )[str(ann.get("ann_id", 0))] = ann
    return out


def organize_file(in_path: str, out_path: str) -> None:
    with open(in_path) as f:
        anns = json.load(f)
    with open(out_path, "w") as f:
        json.dump(organize(anns), f, indent=4)


def split_referit3d(
    csv_path: str, out_dir: str, prefix: str = "nr3d"
) -> Tuple[List[dict], List[dict]]:
    """ReferIt3D csv (columns incl. scan_id, target_id, instance_type,
    utterance) -> <prefix>_train.json / <prefix>_val.json in the ScanRefer
    annotation schema."""
    train_scenes = set(scannet_split("train"))
    val_scenes = set(scannet_split("val"))
    train, val = [], []
    ann_counter: Dict[Tuple[str, str], int] = {}
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            sid = row["scan_id"]
            if sid not in train_scenes and sid not in val_scenes:
                continue
            key = (sid, row["target_id"])
            ann_id = ann_counter.get(key, 0)
            ann_counter[key] = ann_id + 1
            entry = {
                "scene_id": sid,
                "object_id": row["target_id"],
                "object_name": row["instance_type"].replace(" ", "_"),
                "ann_id": str(ann_id),
                "description": row["utterance"],
                "token": tokenize(row["utterance"]),
            }
            (train if sid in train_scenes else val).append(entry)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{prefix}_train.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(out_dir, f"{prefix}_val.json"), "w") as f:
        json.dump(val, f)
    # organized file covers train+val, like the reference's
    # organize_referit3d.py (it parses the WHOLE csv) — eval --use_train
    # needs the train scenes' entries present
    with open(os.path.join(out_dir, f"{prefix}_organized.json"), "w") as f:
        json.dump(organize(train + val), f, indent=4)
    return train, val

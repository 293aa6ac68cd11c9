"""ScanNet dataset configuration: the 18-class map, the nyu40 id mapping, the
mean box sizes and the heading bins, as ``spacap3d_tpu/data/scannet_config.py``.

The metadata it reads sits beside this module: ``scannet_reference_means.npz``
(the 18 x 3 mean box sizes), ``scannetv2-labels.combined.tsv`` (the raw
ScanNet label -> nyu40 map) and the split lists ``scannetv2_{train,val,test}.txt``,
copies of the files the JAX package reads.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

META_DIR = os.path.dirname(os.path.abspath(__file__))
MEAN_SIZE_FILE = "scannet_reference_means.npz"

SCANNET_TYPES = [
    "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "refrigerator", "shower curtain",
    "toilet", "sink", "bathtub", "others",
]

# nyu40 ids kept for detection: walls (1), floors (2), ceilings (22) excluded
NYU40_OBJ_IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 23,
     24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]
)


def mean_size_arr(meta_dir: str = META_DIR, mean_size_file: str = MEAN_SIZE_FILE) -> np.ndarray:
    """(num_size_cluster=18, 3) float64 mean (l, w, h) per size class."""
    with np.load(os.path.join(meta_dir, mean_size_file)) as f:
        return f["arr_0"]


def _read_label_tsv(path: str):
    with open(path) as f:
        lines = [line.rstrip("\n") for line in f][1:]
    return [line.split("\t") for line in lines]


class ScannetDatasetConfig:
    def __init__(self, meta_dir: str = META_DIR, mean_size_file: str = MEAN_SIZE_FILE):
        self.type2class: Dict[str, int] = {t: i for i, t in enumerate(SCANNET_TYPES)}
        self.class2type = {i: t for t, i in self.type2class.items()}
        self.nyu40ids = NYU40_OBJ_IDS
        self.mean_size_arr = mean_size_arr(meta_dir, mean_size_file)
        self.num_class = len(SCANNET_TYPES)
        self.num_heading_bin = 1
        self.num_size_cluster = len(SCANNET_TYPES)
        self.type_mean_size = {
            self.class2type[i]: self.mean_size_arr[i]
            for i in range(self.num_size_cluster)
        }
        self._meta_dir = meta_dir
        self._nyu40id2class = None
        self._raw2label = None
        self._raw2nyuid = None

    # --- lazy tsv-derived maps -------------------------------------------
    def _load_tsv_maps(self):
        rows = _read_label_tsv(os.path.join(self._meta_dir, "scannetv2-labels.combined.tsv"))
        nyu40id2class, raw2label, raw2nyuid = {}, {}, {}
        for r in rows:
            raw_name, nyu40_id, nyu40_name = r[1], int(r[4]), r[7]
            raw2nyuid[raw_name] = nyu40_id
            raw2label[raw_name] = self.type2class.get(nyu40_name, self.type2class["others"])
            if nyu40_id in self.nyu40ids:
                nyu40id2class[nyu40_id] = self.type2class.get(
                    nyu40_name, self.type2class["others"])
        self._nyu40id2class = nyu40id2class
        self._raw2label = raw2label
        self._raw2nyuid = raw2nyuid

    @property
    def nyu40id2class(self):
        if self._nyu40id2class is None:
            self._load_tsv_maps()
        return self._nyu40id2class

    @property
    def raw2label(self):
        if self._raw2label is None:
            self._load_tsv_maps()
        return self._raw2label

    @property
    def raw2nyuid(self):
        if self._raw2nyuid is None:
            self._load_tsv_maps()
        return self._raw2nyuid

    # --- angle/size codecs (ScanNet boxes are axis-aligned) ---------------
    def class2angle(self, pred_cls, residual, to_label_format=True):
        return 0

    def class2angle_batch(self, pred_cls, residual, to_label_format=True):
        return np.zeros(np.shape(pred_cls)[0])

    def class2size(self, pred_cls, residual):
        return self.mean_size_arr[pred_cls] + residual

    def class2size_batch(self, pred_cls, residual):
        return self.mean_size_arr[pred_cls] + residual

    def size2class(self, size, type_name):
        return self.type2class[type_name], size - self.type_mean_size[type_name]

    def param2obb(self, center, heading_class, heading_residual, size_class,
                  size_residual):
        obb = np.zeros(7)
        obb[0:3] = center
        obb[3:6] = self.class2size(int(size_class), size_residual)
        obb[6] = -1 * self.class2angle(heading_class, heading_residual)
        return obb

    def param2obb_batch(self, center, heading_class, heading_residual,
                        size_class, size_residual):
        n = heading_class.shape[0]
        obb = np.zeros((n, 7))
        obb[:, 0:3] = center
        obb[:, 3:6] = self.class2size_batch(size_class, size_residual)
        obb[:, 6] = -1 * self.class2angle_batch(heading_class, heading_residual)
        return obb


def scannet_split(split: str, meta_dir: str = META_DIR) -> List[str]:
    """The sorted scene ids of ScanNet v2's ``split`` (train, val or test)."""
    with open(os.path.join(meta_dir, f"scannetv2_{split}.txt")) as f:
        return sorted(line.strip() for line in f if line.strip())

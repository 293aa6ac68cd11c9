"""ScanNet metadata the eval forward needs: the 18 x 3 mean box sizes.

``scannet_reference_means.npz`` is a copy of the table the JAX package's
``ScannetDatasetConfig`` loads by default.
"""
from __future__ import annotations

import os

import numpy as np

MEAN_SIZE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "scannet_reference_means.npz")


def mean_size_arr() -> np.ndarray:
    """(num_size_cluster=18, 3) float64 mean (l, w, h) per size class."""
    with np.load(MEAN_SIZE_FILE) as f:
        return f["arr_0"]

"""The host data ops in plain numpy: frozen copies of the port's ``*_plain``
versions, under the names of the library bindings that the dataset calls."""
from __future__ import annotations

from fractions import Fraction

import numpy as np

from portbench.reference.spacap.config import GT_VOTE_FACTOR


def choice_noreplace_plain(n: int, k: int, rng: np.random.RandomState) -> np.ndarray:
    return rng.choice(n, k, replace=False)


def gather_rows_plain(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return src[np.asarray(idx, np.int64)]


def percentile_plain(values: np.ndarray, q: float) -> float:
    """The library's formula in numpy: ``vlo + (vhi - vlo) * t`` with
    ``t = pos - floor(pos)``, ``pos = q / 100 * (n - 1)``, and the
    multiply-add rounded once (exact rational arithmetic)."""
    v = np.asarray(values, np.float64)
    n = len(v)
    pos = q / 100.0 * float(n - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, n - 1)
    part = np.partition(v, [lo, hi] if hi != lo else [lo])
    vlo, vhi = float(part[lo]), float(part[hi])
    return float(Fraction(vhi - vlo) * Fraction(pos - lo) + Fraction(vlo))


def compute_votes_plain(xyz, ins, sem, nyu_ids):
    """The vectorized numpy version (replaces the python instance loop of
    reference lib/dataset.py:421-430)."""
    xyz = np.asarray(xyz, np.float64)
    n = xyz.shape[0]
    votes = np.zeros((n, 3))
    mask = np.zeros(n)
    ids, first_idx, inverse = np.unique(ins, return_index=True, return_inverse=True)
    mins = np.full((len(ids), 3), np.inf)
    maxs = np.full((len(ids), 3), -np.inf)
    np.minimum.at(mins, inverse, xyz)
    np.maximum.at(maxs, inverse, xyz)
    centers = 0.5 * (mins + maxs)
    # the instance's semantic label = label of its first point (:419)
    point_valid = np.isin(np.asarray(sem)[first_idx], nyu_ids)[inverse]
    votes[point_valid] = centers[inverse[point_valid]] - xyz[point_valid]
    mask[point_valid] = 1.0
    return np.tile(votes, (1, GT_VOTE_FACTOR)), mask



def points_in_boxes_plain(pc, lo, hi, cap: int = 0) -> np.ndarray:
    pc = np.asarray(pc, np.float32)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    inside = ((pc[None, :, :] >= lo[:, None, :])
              & (pc[None, :, :] <= hi[:, None, :])).all(-1)      # (K, N)
    counts = inside.sum(-1).astype(np.int32)
    return np.minimum(counts, cap) if cap > 0 else counts


def greedy_nms_plain(lo, hi, cls, order, thresh, union_eps) -> np.ndarray:
    """The full pairwise-overlap matrix in one vectorized pass (the same
    elementwise arithmetic), then the greedy loop over it."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    order = np.asarray(order, np.int64)
    area = np.prod(hi - lo, axis=-1)
    l = np.maximum(lo[:, None, :], lo[None, :, :])
    h = np.minimum(hi[:, None, :], hi[None, :, :])
    inter = np.prod(np.maximum(h - l, 0), axis=-1)
    o_mat = inter / (area[:, None] + area[None, :] - inter + union_eps)
    if cls is not None:
        cls = np.asarray(cls, np.float64)
        o_mat = o_mat * (cls[:, None] == cls[None, :])
    pick = []
    while order.size:
        i = int(order[-1])
        order = order[:-1]
        pick.append(i)
        if not order.size:
            break
        order = order[o_mat[i, order] <= thresh]
    return np.asarray(pick, np.int64)


choice_noreplace_native = choice_noreplace_plain
gather_rows = gather_rows_plain
percentile_z = percentile_plain
compute_votes_native = compute_votes_plain
points_in_boxes_native = points_in_boxes_plain
greedy_nms_native = greedy_nms_plain

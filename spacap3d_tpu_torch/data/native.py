"""ctypes bindings of the port's host library (``csrc/spacap_host.cpp``),
with the names and argument types of ``spacap3d_tpu/data/native.py``.

The library is built with ``g++`` at the first call of any binding
(``ops/_build.py::host_build``: once per source hash, under a lock, into
the gitignored ``_build/``); a failed build raises with the compiler's
log. There is no fallback: the data layer and the detection eval always
run the library. ctypes releases the interpreter lock for the length of
each call, so the loader threads run it in parallel.

Beside each binding sits its plain numpy version (``*_plain``), which only
the tests and ``chip_smoke.py`` call: each binding equals its plain
version under ``==``.

  binding                   plain version
  ------------------------  -----------------------------------------------
  choice_noreplace_native   ``rng.choice(n, k, replace=False)``
  gather_rows               fancy indexing ``src[idx]``
  gather_rows_into          ``out[...] = src[idx]`` (a cast to float32)
  percentile_z              the library's formula with one rounding; within
                            an ulp of ``np.percentile`` where neither
                            cancels (numpy rounds twice, and changes
                            formula at t = 0.5)
  compute_votes_native      the vectorized per-instance min/max
  points_in_boxes_native    the broadcast in-box test (K, N)
  greedy_nms_native         the greedy loop over the K x K overlap matrix
"""
from __future__ import annotations

import ctypes
import threading
from fractions import Fraction
from typing import Optional

import numpy as np

from spacap3d_tpu_torch.config import GT_VOTE_FACTOR

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """Builds (once per source hash) and loads the host library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from spacap3d_tpu_torch.ops import _build

        lib = ctypes.CDLL(str(_build.host_build()))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
        c64 = ctypes.c_int64
        lib.gather_rows_f64.argtypes = [f64p, i64p, f64p, c64, c64]
        lib.gather_rows_f32.argtypes = [f32p, i64p, f32p, c64, c64]
        lib.gather_i64.argtypes = [i64p, i64p, i64p, c64]
        vp = ctypes.c_void_p
        for name in ("gather_cols_f32_f32", "gather_cols_f64_f32"):
            getattr(lib, name).argtypes = [vp, c64, i64p, vp, c64, c64, c64]
        lib.percentile.restype = ctypes.c_double
        lib.percentile.argtypes = [f64p, c64, ctypes.c_double]
        lib.compute_votes.argtypes = [f64p, i64p, i64p, u8p, c64, f64p, f64p]
        lib.points_in_boxes.argtypes = [f32p, c64, f64p, c64, ctypes.c_int32, i32p]
        lib.greedy_nms.restype = c64
        lib.greedy_nms.argtypes = [f64p, f64p, f64p, i64p, c64, c64,
                                   ctypes.c_double, ctypes.c_double, c64, i64p]
        lib.mt_permutation_head.restype = c64
        lib.mt_permutation_head.argtypes = [u32p, c64, c64, c64, i64p]
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# the subsample

def choice_noreplace_native(n: int, k: int, rng: np.random.RandomState) -> np.ndarray:
    """``rng.choice(n, k, replace=False)`` (= ``rng.permutation(n)[:k]``,
    numpy's legacy MT19937 pipeline) in C++, on the RandomState's exported
    state; the advanced state is written back, so later draws from ``rng``
    continue exactly as after numpy's ``choice``."""
    if k > n:
        raise ValueError(f"cannot choose {k} of {n} without replacement")
    kind, key, pos, has_gauss, cached = rng.get_state()
    key = np.ascontiguousarray(key, np.uint32)
    out = np.empty(k, np.int64)
    new_pos = library().mt_permutation_head(key, int(pos), int(n), int(k), out)
    rng.set_state((kind, key, int(new_pos), has_gauss, cached))
    return out


def choice_noreplace_plain(n: int, k: int, rng: np.random.RandomState) -> np.ndarray:
    return rng.choice(n, k, replace=False)


# ---------------------------------------------------------------------------
# row gathers

def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``src[idx]`` along the first axis, for float32 and float64 arrays
    of any rank and 1-D int64 arrays."""
    idx = np.ascontiguousarray(idx, np.int64)
    src = np.ascontiguousarray(src)
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    feat = int(np.prod(src.shape[1:]))
    if src.dtype == np.float64:
        library().gather_rows_f64(src.reshape(len(src), feat), idx,
                                  out.reshape(len(out), feat), len(idx), feat)
    elif src.dtype == np.float32:
        library().gather_rows_f32(src.reshape(len(src), feat), idx,
                                  out.reshape(len(out), feat), len(idx), feat)
    elif src.dtype == np.int64 and src.ndim == 1:
        library().gather_i64(src, idx, out, len(idx))
    else:
        raise TypeError(f"gather_rows takes float32, float64 or 1-D int64, not "
                        f"{src.dtype} of rank {src.ndim}")
    return out


def gather_rows_plain(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    return src[np.asarray(idx, np.int64)]


def _row_stride(a: np.ndarray, what: str) -> int:
    """The row stride of a 2-D array in elements; its rows must be
    contiguous."""
    if a.shape[1] > 1 and a.strides[1] != a.itemsize or a.strides[0] % a.itemsize \
            or a.strides[0] < 0:
        raise ValueError(f"gather_rows_into: {what} rows must be contiguous, with "
                         f"strides {a.strides}")
    return a.strides[0] // a.itemsize


def gather_rows_into(src: np.ndarray, idx: np.ndarray, out: np.ndarray) -> np.ndarray:
    """``out[...] = src[idx]``, cast to float32, in one pass over the
    chosen rows: ``src`` a 2-D float32 or float64 array (a column range of
    a wider one too), ``out`` a float32 (len(idx), src.shape[1]) array
    whose rows may lie apart (the columns of a batch row). Returns ``out``."""
    idx = np.ascontiguousarray(idx, np.int64)
    if src.ndim != 2 or src.dtype not in (np.float32, np.float64):
        raise TypeError(f"gather_rows_into takes a 2-D float32 or float64 source, not "
                        f"{src.dtype} of rank {src.ndim}")
    if out.dtype != np.float32 or out.shape != (len(idx), src.shape[1]):
        raise ValueError(f"gather_rows_into writes a float32 {(len(idx), src.shape[1])} "
                         f"array, not {out.dtype} {out.shape}")
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"gather_rows_into: an index outside [0, {len(src)})")
    if not out.size:
        return out
    fn = (library().gather_cols_f32_f32 if src.dtype == np.float32
          else library().gather_cols_f64_f32)
    fn(src.ctypes.data, _row_stride(src, "source"), idx, out.ctypes.data,
       _row_stride(out, "destination"), len(idx), src.shape[1])
    return out


def gather_rows_into_plain(src: np.ndarray, idx: np.ndarray, out: np.ndarray) -> np.ndarray:
    out[...] = src[np.asarray(idx, np.int64)]
    return out


# ---------------------------------------------------------------------------
# the floor percentile

def percentile_z(values: np.ndarray, q: float) -> float:
    """The ``q``-th percentile of ``values`` by linear interpolation
    between the two neighbouring order statistics, rounded once."""
    values = np.ascontiguousarray(values, np.float64)
    return float(library().percentile(values, len(values), float(q)))


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


# ---------------------------------------------------------------------------
# vote targets

def compute_votes_native(xyz, ins, sem, nyu_ids):
    """Per point of an instance whose first point's semantic label is one
    of ``nyu_ids``: (instance AABB centre - point), tiled x3 to (n, 9), and
    a mask of 1; zeros elsewhere. Returns (votes, mask)."""
    xyz = np.ascontiguousarray(xyz, np.float64)
    ins = np.ascontiguousarray(ins, np.int64)
    sem = np.ascontiguousarray(sem, np.int64)
    valid = np.zeros(41, np.uint8)
    valid[np.asarray(nyu_ids)] = 1
    n = len(xyz)
    votes = np.empty((n, 3 * GT_VOTE_FACTOR), np.float64)
    mask = np.empty(n, np.float64)
    library().compute_votes(xyz, ins, sem, valid, n, votes, mask)
    return votes, mask


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


# ---------------------------------------------------------------------------
# point-in-box counts

def points_in_boxes_native(pc, lo, hi, cap: int = 0) -> np.ndarray:
    """Per box, the points of ``pc`` (N, 3) inside [lo, hi] (K, 3) as
    float32 compares; with cap > 0 each count saturates at cap
    (remove_empty_box only tests >= 5)."""
    pc = np.ascontiguousarray(pc, np.float32)
    boxes = np.ascontiguousarray(np.concatenate([lo, hi], axis=-1), np.float64)
    counts = np.empty(len(boxes), np.int32)
    library().points_in_boxes(pc, len(pc), boxes, len(boxes), int(cap), counts)
    return counts


def points_in_boxes_plain(pc, lo, hi, cap: int = 0) -> np.ndarray:
    pc = np.asarray(pc, np.float32)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    inside = ((pc[None, :, :] >= lo[:, None, :])
              & (pc[None, :, :] <= hi[:, None, :])).all(-1)      # (K, N)
    counts = inside.sum(-1).astype(np.int32)
    return np.minimum(counts, cap) if cap > 0 else counts


# ---------------------------------------------------------------------------
# greedy NMS

def greedy_nms_native(lo, hi, cls, order, thresh, union_eps) -> np.ndarray:
    """Greedy NMS in C++ (per pick, the double-precision AABB IoU with the
    reference's formula and op order, utils/nms.py:71-150). ``lo``/``hi``:
    (n, dims) float64; ``cls``: (n,) float64 or None (class-blind);
    ``order``: the boxes ascending by score, picked from the end. Returns
    the picks in pick order."""
    lo = np.ascontiguousarray(lo, np.float64)
    hi = np.ascontiguousarray(hi, np.float64)
    n, dims = lo.shape
    order = np.ascontiguousarray(order, np.int64)
    picks = np.empty(max(n, 1), np.int64)
    cls_arg = (np.ascontiguousarray(cls, np.float64) if cls is not None
               else np.zeros(0, np.float64))
    npick = library().greedy_nms(lo, hi, cls_arg, order, n, dims, float(thresh),
                                 float(union_eps), int(cls is not None), picks)
    return picks[:npick]


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

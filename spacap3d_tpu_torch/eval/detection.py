"""Detection evaluation: NMS, prediction/GT parsing, VOC AP, as
``spacap3d_tpu/eval/detection.py``.

Host-side numpy implementations matching the reference decision-for-
decision (utils/nms.py:39-150, lib/ap_helper.py:44-250,
utils/eval_det.py:21-253), with the JAX package's two redesigns:

  * ``remove_empty_box`` uses a vectorized point-in-AABB test instead of
    the reference's per-box scipy Delaunay hull test
    (model_util_scannet.py:13-22). Equivalent because predicted boxes are
    axis-aligned (heading is always 0 on ScanNet), where the convex hull
    of the 8 corners IS the AABB — and orders of magnitude faster.
  * greedy NMS extracts per-box min/max corners vectorized rather than in
    python loops.

Greedy NMS semantics preserved exactly: sort ascending by score, pop the
highest, suppress others with IoU > threshold (and same class for
``cls_nms``; +1e-8 in that variant's union denominator).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def softmax_np(x: np.ndarray) -> np.ndarray:
    p = np.exp(x - x.max(axis=-1, keepdims=True))
    return p / p.sum(axis=-1, keepdims=True)


# -----------------------------------------------------------------------------
# box IoU (numpy, axis-aligned from corners)
# -----------------------------------------------------------------------------

def box3d_iou_np(corners1: np.ndarray, corners2: np.ndarray) -> float:
    """(8,3) x (8,3) -> IoU (reference utils/box_util.py:97-135)."""
    mn1, mx1 = corners1.min(0), corners1.max(0)
    mn2, mx2 = corners2.min(0), corners2.max(0)
    inter = np.prod(np.maximum(np.minimum(mx1, mx2) - np.maximum(mn1, mn2), 0))
    v1 = np.prod(mx1 - mn1)
    v2 = np.prod(mx2 - mn2)
    return inter / (v1 + v2 - inter + 1e-8)


# -----------------------------------------------------------------------------
# greedy NMS variants
# -----------------------------------------------------------------------------

def _greedy_nms(lo, hi, score, thresh, cls=None, union_eps=0.0):
    # float64 throughout — the reference's box arrays are np.zeros
    # (float64) so its IoUs are double precision (utils/nms.py:71-150).
    # The full pairwise-overlap matrix in one vectorized pass, then the
    # greedy loop over it; the JAX package's optional host library computes
    # the same IoUs per pick with the same arithmetic.
    lo = np.ascontiguousarray(lo, np.float64)
    hi = np.ascontiguousarray(hi, np.float64)
    order = np.argsort(score)  # ascending; pop from the end
    area = np.prod(hi - lo, axis=-1)
    l = np.maximum(lo[:, None, :], lo[None, :, :])
    h = np.minimum(hi[:, None, :], hi[None, :, :])
    inter = np.prod(np.maximum(h - l, 0), axis=-1)
    o_mat = inter / (area[:, None] + area[None, :] - inter + union_eps)
    if cls is not None:
        cls64 = np.ascontiguousarray(cls, np.float64)
        o_mat = o_mat * (cls64[:, None] == cls64[None, :])
    pick = []
    while order.size:
        i = int(order[-1])
        order = order[:-1]
        pick.append(i)
        if not order.size:
            break
        order = order[o_mat[i, order] <= thresh]
    return pick


def nms_2d_faster(boxes: np.ndarray, overlap_threshold: float, old_type=False):
    """boxes (n,5): x1,y1,x2,y2,score (reference utils/nms.py:39-69)."""
    lo = boxes[:, 0:2]
    hi = boxes[:, 2:4]
    if old_type:
        return _nms_old(lo, hi, boxes[:, 4], overlap_threshold)
    return _greedy_nms(lo, hi, boxes[:, 4], overlap_threshold)


def nms_3d_faster(boxes: np.ndarray, overlap_threshold: float, old_type=False):
    """boxes (n,7): x1,y1,z1,x2,y2,z2,score (reference :71-107)."""
    lo = boxes[:, 0:3]
    hi = boxes[:, 3:6]
    if old_type:
        return _nms_old(lo, hi, boxes[:, 6], overlap_threshold)
    return _greedy_nms(lo, hi, boxes[:, 6], overlap_threshold)


def nms_3d_faster_samecls(boxes: np.ndarray, overlap_threshold: float, old_type=False):
    """boxes (n,8): ...,score,cls — suppress only same-class overlaps
    (reference :110-150; note the 1e-8 union epsilon)."""
    lo = boxes[:, 0:3]
    hi = boxes[:, 3:6]
    return _greedy_nms(lo, hi, boxes[:, 6], overlap_threshold,
                       cls=boxes[:, 7], union_eps=1e-8)


def calc_iou(box_a, box_b):
    """Center+size AABB IoU (reference utils/metric_util.py:98-121).
    boxes: [cx, cy, cz, dx, dy, dz]."""
    a_lo = np.asarray(box_a[:3]) - np.asarray(box_a[3:6]) / 2.0
    a_hi = np.asarray(box_a[:3]) + np.asarray(box_a[3:6]) / 2.0
    b_lo = np.asarray(box_b[:3]) - np.asarray(box_b[3:6]) / 2.0
    b_hi = np.asarray(box_b[:3]) + np.asarray(box_b[3:6]) / 2.0
    inter = np.prod(np.maximum(np.minimum(a_hi, b_hi) - np.maximum(a_lo, b_lo), 0))
    va = np.prod(a_hi - a_lo)
    vb = np.prod(b_hi - b_lo)
    return inter / (va + vb - inter + 1e-8)


def bbox_corner_dist_measure(crnr1, crnr2):
    """Normalized corner-distance similarity (reference utils/pc_utils.py):
    1 - mean corner distance / diagonal."""
    crnr1 = np.asarray(crnr1).reshape(8, 3)
    crnr2 = np.asarray(crnr2).reshape(8, 3)
    dist = np.linalg.norm(crnr1 - crnr2, axis=1).mean()
    diag = np.linalg.norm(crnr1[0] - crnr1[6])
    return 1.0 - dist / (diag + 1e-8)


def nms_crnr_dist(boxes, conf, overlap_threshold):
    """Greedy NMS by corner-distance similarity (reference utils/nms.py:
    152-168): suppress boxes whose similarity to the kept box exceeds the
    threshold."""
    order = list(np.argsort(conf))
    pick = []
    while order:
        i = order.pop()
        pick.append(i)
        order = [
            j for j in order
            if bbox_corner_dist_measure(boxes[i], boxes[j]) <= overlap_threshold
        ]
    return pick


def _nms_old(lo, hi, score, thresh):
    # old_type variant: overlap = inter / area[other]
    area = np.prod(hi - lo, axis=-1)
    order = list(np.argsort(score))
    pick = []
    while order:
        i = order.pop()
        pick.append(i)
        if not order:
            break
        rest = np.array(order)
        l = np.maximum(lo[i], lo[rest])
        h = np.minimum(hi[i], hi[rest])
        inter = np.prod(np.maximum(h - l, 0), axis=-1)
        o = inter / area[rest]
        order = [j for j, ov in zip(order, o) if ov <= thresh]
    return pick


# -----------------------------------------------------------------------------
# parse predictions / groundtruths
# -----------------------------------------------------------------------------

def _pred_mask(ep: Dict[str, np.ndarray], config: Dict):
    """Shared NMS/empty-box stage of prediction parsing. Writes
    ep['pred_mask'] and returns (pred_mask, box_lo, box_hi, corners,
    sem_cls, sem_probs, obj_prob).

    Every decision below consumes only the axis-aligned extents, so a
    compact eval step (train/step.py, compact=True) ships ``bbox_lo``/
    ``bbox_hi`` instead of the 4x bigger 8-corner tensor; min/max are
    exact, so the decisions are bit-identical either way (``corners`` is
    None in that case)."""
    corners = ep.get("bbox_corner")
    if corners is not None:
        corners = np.asarray(corners)                    # (B, K, 8, 3)
        box_lo = corners.min(axis=2)                     # (B, K, 3)
        box_hi = corners.max(axis=2)
    else:
        box_lo = np.asarray(ep["bbox_lo"])
        box_hi = np.asarray(ep["bbox_hi"])
    bsize, k = box_lo.shape[:2]
    if "sem_cls" in ep:
        sem_cls = np.asarray(ep["sem_cls"])              # (B, K)
    else:
        # compact eval step: sem_cls is argmax(sem_cls_scores) on the
        # device; recomputing it here on the identical fetched f32 scores
        # (same first-max tie rule) saves fetching a (B, K) tensor
        sem_cls = np.argmax(np.asarray(ep["sem_cls_scores"]), axis=-1)
    sem_probs = softmax_np(np.asarray(ep["sem_cls_scores"]))
    obj_prob = softmax_np(np.asarray(ep["objectness_scores"]))[:, :, 1]

    nonempty = np.ones((bsize, k), bool)
    if config.get("remove_empty_box", False):
        if "nonempty_box" in ep:
            # precomputed on the device by the eval step (train/step.py):
            # same f32 compares on the same values, no host work
            nonempty = np.asarray(ep["nonempty_box"]).astype(bool)
        else:
            pc = np.asarray(ep["point_clouds"])[:, :, :3]    # (B, N, 3)
            for i in range(bsize):
                inside = (
                    (pc[i][None, :, :] >= box_lo[i][:, None, :])
                    & (pc[i][None, :, :] <= box_hi[i][:, None, :])
                ).all(-1)                                     # (K, N)
                nonempty[i] = inside.sum(-1) >= 5             # "< 5 points" removed

    pred_mask = np.zeros((bsize, k))
    thresh = config["nms_iou"]
    for i in range(bsize):
        idx = np.where(nonempty[i])[0]
        if config.get("use_3d_nms", True) and config.get("cls_nms", True):
            boxes = np.concatenate(
                [box_lo[i, idx], box_hi[i, idx], obj_prob[i, idx, None],
                 sem_cls[i, idx, None]], axis=-1,
            )
            pick = nms_3d_faster_samecls(boxes, thresh, config.get("use_old_type_nms", False))
        elif config.get("use_3d_nms", True):
            boxes = np.concatenate(
                [box_lo[i, idx], box_hi[i, idx], obj_prob[i, idx, None]], axis=-1
            )
            pick = nms_3d_faster(boxes, thresh, config.get("use_old_type_nms", False))
        else:
            boxes = np.stack(
                [box_lo[i, idx, 0], box_lo[i, idx, 2],
                 box_hi[i, idx, 0], box_hi[i, idx, 2], obj_prob[i, idx]], axis=-1
            )
            pick = nms_2d_faster(boxes, thresh, config.get("use_old_type_nms", False))
        assert len(pick) > 0
        pred_mask[i, idx[pick]] = 1
    ep["pred_mask"] = pred_mask
    return pred_mask, box_lo, box_hi, corners, sem_cls, sem_probs, obj_prob


def parse_predictions(ep: Dict[str, np.ndarray], config: Dict) -> List[List[Tuple]]:
    """reference lib/ap_helper.py:44-160. ``ep`` values are host numpy
    arrays. Writes ep['pred_mask'] and returns batch_pred_map_cls as
    per-scan lists of (class, corners, score) tuples. Requires the full
    ``bbox_corner`` tensor (the reference tuple layout carries corners);
    compact eval outputs go through parse_predictions_arrays."""
    pred_mask, _, _, corners, sem_cls, sem_probs, obj_prob = _pred_mask(ep, config)
    assert corners is not None, "parse_predictions needs ep['bbox_corner']"
    bsize, k = pred_mask.shape
    conf_thresh = config.get("conf_thresh", 0.05)
    num_class = config["dataset_config"].num_class
    batch_pred_map_cls = []
    for i in range(bsize):
        keep = [j for j in range(k)
                if pred_mask[i, j] == 1 and obj_prob[i, j] > conf_thresh]
        if config.get("per_class_proposal", True):
            cur = []
            for c in range(num_class):
                cur += [(c, corners[i, j], sem_probs[i, j, c] * obj_prob[i, j])
                        for j in keep]
            batch_pred_map_cls.append(cur)
        else:
            batch_pred_map_cls.append(
                [(int(sem_cls[i, j]), corners[i, j], obj_prob[i, j]) for j in keep]
            )
    return batch_pred_map_cls


def parse_predictions_arrays(ep: Dict[str, np.ndarray], config: Dict) -> List[Dict]:
    """Array-form parse_predictions: same decisions, but each scan's
    predictions come out as {'cls' (P,), 'corners' (P,8,3), 'conf' (P,)}
    arrays instead of P python tuples. With per_class_proposal the
    expansion is class-major exactly like the tuple layout (the reference
    appends all of class 0, then class 1, ... lib/ap_helper.py:137-146),
    so downstream sorting/decisions are identical. Avoids building ~2k
    tuples per scan on the eval hot path.

    Boxes come out as axis-aligned extents ('lo'/'hi'), which is all the
    AP pipeline consumes (_eval_det_cls_core; heading is always 0) —
    this also lets the compact eval step skip fetching 8-corner tensors
    from the device entirely."""
    pred_mask, box_lo, box_hi, _, sem_cls, sem_probs, obj_prob = _pred_mask(
        ep, config)
    bsize = pred_mask.shape[0]
    conf_thresh = config.get("conf_thresh", 0.05)
    num_class = config["dataset_config"].num_class
    out = []
    for i in range(bsize):
        keep = np.where((pred_mask[i] == 1) & (obj_prob[i] > conf_thresh))[0]
        nk = len(keep)
        if config.get("per_class_proposal", True):
            # (class-major, keep-minor) = tuple layout
            cls = np.repeat(np.arange(num_class), nk)
            lo = np.tile(box_lo[i, keep], (num_class, 1))
            hi = np.tile(box_hi[i, keep], (num_class, 1))
            conf = (sem_probs[i, keep, :num_class] * obj_prob[i, keep, None]
                    ).T.reshape(-1)
        else:
            cls = sem_cls[i, keep].astype(np.int64)
            lo = box_lo[i, keep]
            hi = box_hi[i, keep]
            conf = obj_prob[i, keep]
        out.append({"cls": cls, "lo": lo, "hi": hi, "conf": conf})
    return out


def parse_groundtruths(ep: Dict[str, np.ndarray], config: Dict) -> List[List[Tuple]]:
    """reference lib/ap_helper.py:163-192."""
    box_mask = np.asarray(ep["box_label_mask"])
    sem_label = np.asarray(ep["sem_cls_label"])
    gt_corners = np.asarray(ep["gt_box_corner_label"])
    bsize = sem_label.shape[0]
    out = []
    for i in range(bsize):
        out.append(
            [(int(sem_label[i, j]), gt_corners[i, j])
             for j in range(gt_corners.shape[1]) if box_mask[i, j] == 1]
        )
    return out


def parse_groundtruths_arrays(ep: Dict[str, np.ndarray], config: Dict) -> List[Dict]:
    """Array-form parse_groundtruths: {'cls' (G,), 'corners' (G,8,3)}."""
    box_mask = np.asarray(ep["box_label_mask"])
    sem_label = np.asarray(ep["sem_cls_label"])
    gt_corners = np.asarray(ep["gt_box_corner_label"])
    out = []
    for i in range(sem_label.shape[0]):
        sel = np.where(box_mask[i] == 1)[0]
        out.append({"cls": sem_label[i, sel].astype(np.int64),
                    "corners": gt_corners[i, sel]})
    return out


# -----------------------------------------------------------------------------
# VOC AP
# -----------------------------------------------------------------------------

def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric=False) -> float:
    """reference utils/eval_det.py:21-52."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    # running max from the right — sequential max, identical to the
    # reference's backwards python loop (utils/eval_det.py:45-46)
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _eval_det_cls_core(det_img, det_mn, det_mx, conf,
                       gt_img, gt_mn, gt_mx, npos,
                       ovthresh, use_07_metric):
    """Vectorized per-class PR/AP core, decision-identical to the
    reference's greedy per-detection loop (utils/eval_det.py:97-158):

      * detections processed in np.argsort(-confidence) order (same array,
        same sort — identical permutation incl. ties);
      * each detection's best GT in ITS image by first-maximum IoU
        (float64 AABB IoU with the reference's +1e-8 union epsilon);
      * a GT box counts at most one TP — the greedy 'rec.det[jmax]' check
        is exactly 'first detection in sorted order claiming (img, jmax)',
        computed with one np.unique(return_index=True) over composite keys.

    All arrays are flat over this class's detections / GT boxes; img ids
    are int64 indices. Returns (recall, precision, ap)."""
    nd = det_img.shape[0]
    order = np.argsort(-conf)
    det_img = det_img[order]
    det_mn = det_mn[order]
    det_mx = det_mx[order]

    ovmax = np.full(nd, -np.inf)
    jmax = np.full(nd, -1, np.int64)
    if gt_img.shape[0]:
        gvol = np.prod(gt_mx - gt_mn, -1)
        for img in np.unique(det_img):
            gsel = np.where(gt_img == img)[0]
            if not gsel.size:
                continue
            dsel = np.where(det_img == img)[0]
            inter = np.prod(
                np.maximum(
                    np.minimum(det_mx[dsel, None], gt_mx[None, gsel])
                    - np.maximum(det_mn[dsel, None], gt_mn[None, gsel]),
                    0,
                ),
                -1,
            )                                             # (D, G)
            dvol = np.prod(det_mx[dsel] - det_mn[dsel], -1)
            iou = inter / (dvol[:, None] + gvol[None, gsel] - inter + 1e-8)
            # argmax takes the FIRST maximum — same tie-break as the
            # reference's strict `iou > ovmax` scan
            jm = np.argmax(iou, axis=1)
            ovmax[dsel] = iou[np.arange(len(dsel)), jm]
            jmax[dsel] = gsel[jm]                         # global gt index

    tp = np.zeros(nd)
    kidx = np.where(ovmax > ovthresh)[0]                  # ascending = sorted order
    if kidx.size:
        # jmax is a GLOBAL gt index (unique across images), so it alone
        # keys the greedy 'already detected' check
        _, first = np.unique(jmax[kidx], return_index=True)
        tp[kidx[first]] = 1.0
    fp = 1.0 - tp

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / float(npos + 1e-8)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


def eval_det_cls(pred: Dict, gt: Dict, ovthresh=0.25, use_07_metric=False):
    """Per-class precision/recall/AP (reference utils/eval_det.py:73-158).

    pred: {img_id: [(corners, score)]}, gt: {img_id: [corners]}.
    Thin adapter over the vectorized core: flattens the per-image tuple
    lists into arrays in the reference's iteration order (image insertion
    order, then per-image detection order) so sorting and greedy
    decisions are identical."""
    img_index = {}
    for img_id in list(gt.keys()) + list(pred.keys()):
        if img_id not in img_index:
            img_index[img_id] = len(img_index)

    npos = sum(len(boxes) for boxes in gt.values())
    gt_img, gt_mn, gt_mx = [], [], []
    for img_id, boxes in gt.items():
        if len(boxes):
            gtb = np.asarray(boxes, float)                # (G, 8, 3)
            gt_img.append(np.full(len(boxes), img_index[img_id], np.int64))
            gt_mn.append(gtb.min(axis=1))
            gt_mx.append(gtb.max(axis=1))
    gt_img = np.concatenate(gt_img) if gt_img else np.zeros(0, np.int64)
    gt_mn = np.concatenate(gt_mn) if len(gt_mn) else np.zeros((0, 3))
    gt_mx = np.concatenate(gt_mx) if len(gt_mx) else np.zeros((0, 3))

    image_ids, confidence, bbs = [], [], []
    for img_id, dets in pred.items():
        for box, score in dets:
            image_ids.append(img_index[img_id])
            confidence.append(score)
            bbs.append(np.asarray(box, float))
    det_img = np.asarray(image_ids, np.int64)
    conf = np.array(confidence)
    if len(bbs):
        bbs = np.stack(bbs)                               # (D, 8, 3)
        det_mn, det_mx = bbs.min(axis=1), bbs.max(axis=1)
    else:
        det_mn = det_mx = np.zeros((0, 3))
    return _eval_det_cls_core(det_img, det_mn, det_mx, conf,
                              gt_img, gt_mn, gt_mx, npos,
                              ovthresh, use_07_metric)


def _normalize_pred_scan(entry):
    """A scan's predictions -> {'cls','corners'|'lo'+'hi','conf'} arrays;
    accepts the tuple-list form or the already-array form."""
    if isinstance(entry, dict):
        return entry
    if len(entry) == 0:
        return {"cls": np.zeros(0, np.int64),
                "corners": np.zeros((0, 8, 3)),
                "conf": np.zeros(0)}
    cls = np.array([c for c, _, _ in entry], np.int64)
    corners = np.stack([np.asarray(b) for _, b, _ in entry])
    conf = np.array([s for _, _, s in entry])
    return {"cls": cls, "corners": corners, "conf": conf}


def _scan_extents(e):
    """Axis-aligned (min, max) float64 extents of a normalized scan entry
    — from precomputed 'lo'/'hi' (compact path) or the 8-corner tensor.
    min/max commute with the float64 cast, so both forms are
    bit-identical."""
    if "lo" in e:
        return np.asarray(e["lo"], float), np.asarray(e["hi"], float)
    crn = np.asarray(e["corners"], float)
    return crn.min(axis=1), crn.max(axis=1)


def _normalize_gt_scan(entry):
    if isinstance(entry, dict):
        return entry
    if len(entry) == 0:
        return {"cls": np.zeros(0, np.int64), "corners": np.zeros((0, 8, 3))}
    cls = np.array([c for c, _ in entry], np.int64)
    corners = np.stack([np.asarray(b) for _, b in entry])
    return {"cls": cls, "corners": corners}


def eval_det(pred_all: Dict, gt_all: Dict, ovthresh=0.25, use_07_metric=False,
             num_workers: int = 10):
    """Multi-class AP over {scan: predictions}, {scan: gts}.

    Scan entries may be tuple lists (reference layout) or the array dicts
    from parse_*_arrays. Fully vectorized: per-scan arrays are
    concatenated once (scan order = the reference's dict insertion order)
    and each class runs through _eval_det_cls_core — the reference's
    Pool(10)-over-classes (utils/eval_det.py:207-253) is obsolete at
    ~5 ms/class (``num_workers`` kept for API compatibility).

    API narrowing vs the reference: classnames must be INTEGER ids (the
    vectorized core groups by an int64 class column; the reference's
    eval_det accepted arbitrary hashable classnames, e.g. strings). Map
    string classnames through an index (e.g. ScannetDatasetConfig's
    type2class) before calling — every in-repo caller already passes
    ints."""
    del num_workers
    scan_ids = list(pred_all.keys())
    scan_index = {s: i for i, s in enumerate(scan_ids)}

    d_img, d_cls, d_mn, d_mx, d_conf = [], [], [], [], []
    for s in scan_ids:
        e = _normalize_pred_scan(pred_all[s])
        n = len(e["cls"])
        if n:
            mn, mx = _scan_extents(e)
            d_img.append(np.full(n, scan_index[s], np.int64))
            d_cls.append(np.asarray(e["cls"], np.int64))
            d_mn.append(mn)
            d_mx.append(mx)
            d_conf.append(np.asarray(e["conf"]))
    g_img, g_cls, g_mn, g_mx = [], [], [], []
    extra_scans = 0
    for s, entry in gt_all.items():
        e = _normalize_gt_scan(entry)
        n = len(e["cls"])
        if not n:
            continue
        if s in scan_index:
            img = scan_index[s]
        else:
            # GT for a scan with no prediction entry: its boxes still
            # count in npos (no detection can ever match them)
            img = len(scan_index) + extra_scans
            extra_scans += 1
        mn, mx = _scan_extents(e)
        g_img.append(np.full(n, img, np.int64))
        g_cls.append(np.asarray(e["cls"], np.int64))
        g_mn.append(mn)
        g_mx.append(mx)

    def cat(parts, shape, dtype=float):
        return np.concatenate(parts) if parts else np.zeros(shape, dtype)

    d_img = cat(d_img, (0,), np.int64)
    d_cls = cat(d_cls, (0,), np.int64)
    d_mn = cat(d_mn, (0, 3))
    d_mx = cat(d_mx, (0, 3))
    d_conf = cat(d_conf, (0,))
    g_img = cat(g_img, (0,), np.int64)
    g_cls = cat(g_cls, (0,), np.int64)
    g_mn = cat(g_mn, (0, 3))
    g_mx = cat(g_mx, (0, 3))

    pred_classes = set(np.unique(d_cls).tolist())
    gt_classes = set(np.unique(g_cls).tolist())
    rec, prec, ap = {}, {}, {}
    for c in sorted(pred_classes | gt_classes):
        if c not in pred_classes:
            rec[c], prec[c], ap[c] = 0, 0, 0
            continue
        dsel = d_cls == c
        gsel = g_cls == c
        rec[c], prec[c], ap[c] = _eval_det_cls_core(
            d_img[dsel], d_mn[dsel], d_mx[dsel], d_conf[dsel],
            g_img[gsel], g_mn[gsel], g_mx[gsel], int(gsel.sum()),
            ovthresh, use_07_metric,
        )
    return rec, prec, ap


class APCalculator:
    """Accumulates per-scan predictions/GTs, computes mAP/AR
    (reference lib/ap_helper.py:195-250)."""

    def __init__(self, ap_iou_thresh=0.25, class2type_map=None):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.reset()

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for pred, gt in zip(batch_pred_map_cls, batch_gt_map_cls):
            # normalized array form: compact to hold (and to pickle when a
            # seed's AP state crosses a worker boundary in mul_eval)
            self.gt_map_cls[self.scan_cnt] = _normalize_gt_scan(gt)
            self.pred_map_cls[self.scan_cnt] = _normalize_pred_scan(pred)
            self.scan_cnt += 1

    def compute_metrics(self, num_workers: int = 10):
        rec, _, ap = eval_det(
            self.pred_map_cls, self.gt_map_cls, ovthresh=self.ap_iou_thresh,
            num_workers=num_workers,
        )
        ret = {}
        for key in sorted(ap.keys()):
            name = self.class2type_map[key] if self.class2type_map else str(key)
            ret[f"{name} Average Precision"] = ap[key]
        ret["mAP"] = np.mean(list(ap.values()))
        rec_list = []
        for key in sorted(ap.keys()):
            name = self.class2type_map[key] if self.class2type_map else str(key)
            try:
                ret[f"{name} Recall"] = rec[key][-1]
                rec_list.append(rec[key][-1])
            except (TypeError, IndexError):
                ret[f"{name} Recall"] = 0
                rec_list.append(0)
        ret["AR"] = np.mean(rec_list)
        return ret

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0

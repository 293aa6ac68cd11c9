"""Caption and detection evaluation harness, as
``spacap3d_tpu/eval/eval_helper.py`` (reference lib/eval_helper.py:24-319:
prepare_corpus, feed_scene_cap, eval_cap), with the attention and proposal
dumps and ``eval_visualize``.

The eval step (``train/step.py::make_eval_step``: the detector, the greedy
decode over every proposal and the objectness assignment, one forward on
the device) runs over the loader; its outputs come to the host once a
batch. The host post-processes them with class-NMS, the objectness mask and
an IoU > ``min_iou`` match against the assigned GT box, decodes the
surviving captions keyed ``scene|object_id|object_name``, back-fills
undetected objects with "sos eos", and scores with BLEU, CIDEr, ROUGE-L and
METEOR. Caption and detection evaluation share the one forward.

POST_DICT parity: remove_empty_box, 3D class-NMS at IoU 0.25,
per_class_proposal, conf 0.05 (lib/eval_helper.py:135-144).

Entry points take ``device=`` (default ``"cuda"``): the model must sit on
that device, and each batch goes there before the step. Without CUDA they
raise unless given ``device="cpu"``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.reference.spacap.config import EVAL_MIN_IOU, MAX_DES_LEN
from portbench.reference.spacap.data.scannet_config import ScannetDatasetConfig
from portbench.reference.spacap.data.vocabulary import Vocabulary
from portbench.reference.spacap.eval import capeval
from portbench.reference.spacap.eval.detection import (
    APCalculator,
    parse_groundtruths_arrays,
    parse_predictions_arrays,
    softmax_np,
)

POST_DICT_DEFAULTS = dict(
    remove_empty_box=True, use_3d_nms=True, nms_iou=0.25,
    use_old_type_nms=False, cls_nms=True, per_class_proposal=True,
    conf_thresh=0.05,
)


def prepare_corpus(raw_data: List[dict], max_len: int = MAX_DES_LEN) -> Dict[str, List[str]]:
    """reference lib/eval_helper.py:24-44."""
    corpus: Dict[str, List[str]] = {}
    for data in raw_data:
        key = "{}|{}|{}".format(data["scene_id"], data["object_id"], data["object_name"])
        description = "sos " + " ".join(data["token"][:max_len]) + " eos"
        corpus.setdefault(key, []).append(description)
    return corpus


def check_candidates(corpus: Dict, candidates: Dict) -> Dict:
    """Back-fill undetected objects with 'sos eos' (reference :59-69)."""
    for key in corpus:
        if key not in candidates:
            candidates[key] = ["sos eos"]
    return candidates


def organize_candidates(corpus: Dict, candidates: Dict) -> Dict:
    return {key: candidates[key] for key in corpus}


def resolve_winning_proposals(keep_row, det_ids_row, organized, scene_id):
    """{scene|obj|name key -> winning proposal index} for one scene row.

    Several NMS-surviving proposals can map to the same object key; the
    LAST one in proposal order wins the dict write (reference
    lib/eval_helper.py:150-166), so only that one needs decoding.
    Detected ids without a corpus entry are skipped."""
    final_k = {}
    for k in np.where(keep_row)[0]:
        object_id = str(int(det_ids_row[k]))
        try:
            ann_list = list(organized[scene_id][object_id].keys())
            object_name = organized[scene_id][object_id][ann_list[0]]["object_name"]
        except KeyError:
            continue
        final_k[f"{scene_id}|{object_id}|{object_name}"] = int(k)
    return final_k


def postprocess_batch(out: Dict, batch: Dict, post: Dict, min_iou: float,
                      with_detection: bool = True):
    """Host-side per-batch post-processing shared by the single-seed and
    grid (mul_eval) paths: class-NMS (writes out['pred_mask']), the
    nms AND objectness mask, per-proposal IoU against the assigned GT
    box, and AP-format parsed predictions/groundtruths.

    Mirrors reference lib/eval_helper.py:135-173 + ap_helper parsing.
    Returns (nms_mask, detected_object_ids, ious, preds, gts)."""
    ep_host = dict(out)
    if "point_clouds" in batch:
        ep_host["point_clouds"] = batch["point_clouds"]
    # (the point-table grid ships no host point_clouds; the eval step
    # computes nonempty_box on the device, so parsing never needs them)
    preds = parse_predictions_arrays(ep_host, post)
    nms_mask = ep_host["pred_mask"] * (out["bbox_mask"] != 0)

    assign = out["object_assignment"].astype(np.int64)          # (B, K)
    detected_object_ids = np.take_along_axis(batch["scene_object_ids"], assign, axis=1)
    gt_corners = batch["gt_box_corner_label"]                   # (B, M, 8, 3)
    assigned_corners = np.take_along_axis(gt_corners, assign[:, :, None, None], axis=1)
    mn1, mx1 = assigned_corners.min(2), assigned_corners.max(2)
    if "bbox_corner" in out:
        det_corners = out["bbox_corner"]
        mn2, mx2 = det_corners.min(2), det_corners.max(2)
    else:  # compact eval step: extents computed on the device (exact)
        mn2, mx2 = out["bbox_lo"], out["bbox_hi"]
    inter = np.prod(np.maximum(np.minimum(mx1, mx2) - np.maximum(mn1, mn2), 0), -1)
    v1 = np.prod(mx1 - mn1, -1)
    v2 = np.prod(mx2 - mn2, -1)
    ious = inter / (v1 + v2 - inter + 1e-8)

    gts = None
    if with_detection:
        gts = parse_groundtruths_arrays(
            {k: batch[k] for k in ("box_label_mask", "sem_cls_label", "gt_box_corner_label")},
            post,
        )
    return nms_mask, detected_object_ids, ious, preds, gts


def organize_annotations(annotations: List[dict]) -> Dict:
    """Flat annotation list -> {scene: {obj: {ann: entry}}} (the layout of
    the reference's *_organized.json, scripts/organize_scanrefer.py)."""
    out: Dict = {}
    for ann in annotations:
        out.setdefault(ann["scene_id"], {}).setdefault(
            str(ann["object_id"]), {})[str(ann.get("ann_id", 0))] = ann
    return out


def caption_metrics(bleu, cider, rouge, meteor) -> Dict[str, float]:
    """The reference CSV's caption columns, plus their sum."""
    metrics = {
        "bleu-1": bleu[0][0], "bleu-2": bleu[0][1],
        "bleu-3": bleu[0][2], "bleu-4": bleu[0][3],
        "cider": cider[0], "rouge": rouge[0], "meteor": meteor[0],
    }
    metrics["sum"] = sum(metrics.values())
    return metrics

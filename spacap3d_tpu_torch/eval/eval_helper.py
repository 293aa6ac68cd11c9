"""Caption and detection evaluation harness, as
``spacap3d_tpu/eval/eval_helper.py`` (reference lib/eval_helper.py:24-319:
prepare_corpus, feed_scene_cap, eval_cap).

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
import torch

from spacap3d_tpu_torch.config import EVAL_MIN_IOU, MAX_DES_LEN
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu_torch.data.vocabulary import Vocabulary
from spacap3d_tpu_torch.device import resolve_device
from spacap3d_tpu_torch.eval import capeval
from spacap3d_tpu_torch.eval.detection import (
    APCalculator,
    parse_groundtruths_arrays,
    parse_predictions_arrays,
    softmax_np,
)
from spacap3d_tpu_torch.train.step import EVAL_INPUT_KEYS, to_device_batch

POST_DICT_DEFAULTS = dict(
    remove_empty_box=True, use_3d_nms=True, nms_iou=0.25,
    use_old_type_nms=False, cls_nms=True, per_class_proposal=True,
    conf_thresh=0.05,
)


def eval_device(model: torch.nn.Module, device) -> torch.device:
    """``device`` resolved; raises if ``model``'s parameters lie elsewhere."""
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != dev.type or dev.index not in (None, p.device.index):
        raise ValueError(f"the model lies on {p.device}, not on {dev}")
    return dev


def fetch_outputs(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The step's outputs as host numpy arrays (one copy a tensor; each
    waits for the forward that produced it)."""
    return {k: v.cpu().numpy() for k, v in out.items()}


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


def _valid_rows(batch: Dict, bsize: int) -> np.ndarray:
    """Rows padded by the loader's wrap-around duplicate scenes already
    evaluated; they are skipped everywhere (candidates, dumps, AP) so that
    metrics match the reference's ragged-batch protocol."""
    return np.asarray(batch.get("__valid__", np.ones(bsize, bool))).astype(bool)


def feed_scene_cap(
    step, model,
    dataset,
    loader,
    vocab: Vocabulary,
    organized: Dict,
    dc: ScannetDatasetConfig,
    min_iou: float = EVAL_MIN_IOU,
    also_detection: bool = False,
    save_proposal: bool = False,
    device="cuda",
) -> Tuple[Dict, Optional[APCalculator], Dict]:
    """Runs ``step(model, batch)`` (``make_eval_step``, full outputs) over
    the loader; returns (candidates, an APCalculator when
    ``also_detection``, proposal dumps). The dumps mirror the reference's
    --save_proposal output (lib/eval_helper.py:224-243)."""
    dev = eval_device(model, device)
    candidates: Dict[str, List[str]] = {}
    proposal_dump: Dict = {}
    post = dict(POST_DICT_DEFAULTS, dataset_config=dc)
    ap_calc = APCalculator(0.5, dc.class2type) if also_detection else None

    for batch in loader:
        out = fetch_outputs(step(model, to_device_batch(
            {k: batch[k] for k in EVAL_INPUT_KEYS}, dev)))
        captions = out["lang_cap"]                       # (B, K, T) int
        bsize = captions.shape[0]
        valid = _valid_rows(batch, bsize)

        nms_mask, detected_object_ids, ious, preds, gts = postprocess_batch(
            out, batch, post, min_iou, with_detection=ap_calc is not None)
        keep = (nms_mask == 1) & (ious > min_iou)        # (B, K)
        for b in range(bsize):
            if not valid[b]:
                continue
            scene_id = dataset.annotations[int(batch["dataset_idx"][b])]["scene_id"]
            final_k = resolve_winning_proposals(keep[b], detected_object_ids[b], organized,
                                                scene_id)
            for key, k in final_k.items():
                candidates[key] = [vocab.decode(captions[b, k])]
            if final_k and save_proposal:
                proposal_dump[scene_id] = {
                    "obj_id": detected_object_ids[b],
                    "obj_mask": out["bbox_mask"][b],
                    "ious": ious[b],
                    "nms_mask": nms_mask[b],
                    "box_corners": out["bbox_corner"][b],
                    "class": out["sem_cls"][b],
                    "objectness": softmax_np(out["objectness_scores"][b])[:, 1],
                    "center": out["center"][b],
                }

        if ap_calc is not None:
            ap_calc.step([p for p, v in zip(preds, valid) if v],
                         [g for g, v in zip(gts, valid) if v])

    return candidates, ap_calc, proposal_dump


def eval_detection(step, model, loader, dc: ScannetDatasetConfig, ap_iou: float = 0.5,
                   device="cuda") -> Dict:
    """Detection-only evaluation (reference scripts/eval.py:176-244
    eval_detection): parse predictions + groundtruths per batch, compute
    VOC AP/AR. Works for no-caption (detection-pretrain) models."""
    dev = eval_device(model, device)
    post = dict(POST_DICT_DEFAULTS, dataset_config=dc)
    calc = APCalculator(ap_iou, dc.class2type)
    for batch in loader:
        out = fetch_outputs(step(model, to_device_batch(
            {k: batch[k] for k in EVAL_INPUT_KEYS}, dev)))
        out["point_clouds"] = batch["point_clouds"]
        preds = parse_predictions_arrays(out, post)
        gts = parse_groundtruths_arrays(
            {k: batch[k] for k in ("box_label_mask", "sem_cls_label", "gt_box_corner_label")},
            post,
        )
        valid = _valid_rows(batch, len(preds))
        calc.step([p for p, v in zip(preds, valid) if v],
                  [g for g, v in zip(gts, valid) if v])
    return calc.compute_metrics()


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


def score_captions(corpus: Dict, candidates: Dict, meteor_jar: Optional[str] = None):
    """Returns the reference's (bleu, cider, rouge, meteor) tuple layout."""
    candidates = check_candidates(corpus, candidates)
    candidates = organize_candidates(corpus, candidates)
    bleu = capeval.Bleu(4).compute_score(corpus, candidates)
    cider = capeval.Cider().compute_score(corpus, candidates)
    rouge = capeval.Rouge().compute_score(corpus, candidates)
    meteor_scorer = capeval.Meteor(meteor_jar)
    try:
        meteor = meteor_scorer.compute_score(corpus, candidates)
    finally:
        meteor_scorer.close()
    return bleu, cider, rouge, meteor, candidates


def eval_cap(
    step, model, dataset, loader, vocab, dc,
    corpus_annotations: List[dict],
    min_iou: float = EVAL_MIN_IOU,
    also_detection: bool = False,
    corpus_cache: Optional[str] = None,
    pred_path: Optional[str] = None,
    meteor_jar: Optional[str] = None,
    save_proposal: bool = False,
    dump_dir: Optional[str] = None,
    device="cuda",
):
    """Full caption (+ optional detection) evaluation pass; returns
    (metrics, candidates)."""
    if corpus_cache and os.path.exists(corpus_cache):
        with open(corpus_cache) as f:
            corpus = json.load(f)
    else:
        corpus = prepare_corpus(corpus_annotations)
        if corpus_cache:
            os.makedirs(os.path.dirname(corpus_cache) or ".", exist_ok=True)
            with open(corpus_cache, "w") as f:
                json.dump(corpus, f, indent=4)

    organized = organize_annotations(corpus_annotations)
    candidates, ap_calc, proposal_dump = feed_scene_cap(
        step, model, dataset, loader, vocab, organized, dc,
        min_iou=min_iou, also_detection=also_detection,
        save_proposal=save_proposal, device=device,
    )
    if dump_dir and proposal_dump:
        import pickle
        os.makedirs(dump_dir, exist_ok=True)
        with open(os.path.join(dump_dir, "proposal_related.pkl"), "wb") as f:
            pickle.dump(proposal_dump, f)
    bleu, cider, rouge, meteor, candidates = score_captions(corpus, candidates, meteor_jar)
    if pred_path:
        os.makedirs(os.path.dirname(pred_path) or ".", exist_ok=True)
        with open(pred_path, "w") as f:
            json.dump(candidates, f, indent=4)

    metrics = caption_metrics(bleu, cider, rouge, meteor)
    if ap_calc is not None:
        det = ap_calc.compute_metrics()
        metrics["mAP@0.5"] = det["mAP"]
        metrics["AR@0.5"] = det["AR"]
        metrics["detection"] = det
    return metrics, candidates

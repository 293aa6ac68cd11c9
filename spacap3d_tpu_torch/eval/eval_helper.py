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


def run_step(step, model, batch: Dict, dev: torch.device):
    """``step`` on ``batch``'s input keys, uploaded to ``dev``; returns the
    uploaded batch and the outputs on the host."""
    dev_batch = to_device_batch({k: batch[k] for k in EVAL_INPUT_KEYS}, dev)
    return dev_batch, fetch_outputs(step(model, dev_batch))


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
    attn_dump_step=None,
    save_proposal: bool = False,
    device="cuda",
) -> Tuple[Dict, Optional[APCalculator], Dict, Dict]:
    """Runs ``step(model, batch)`` (``make_eval_step``, full outputs) over
    the loader; returns (candidates, an APCalculator when
    ``also_detection``, attention intermediates, proposal dumps). The last
    two mirror the reference's --save_*_attn / --save_proposal outputs
    (lib/eval_helper.py:99-121, :224-243): ``attn_dump_step``
    (``make_attn_dump_step``) runs on each batch's greedy tokens, and each
    matched caption keeps its scene's encoder weights and its proposal's
    decoder weights."""
    dev = eval_device(model, device)
    candidates: Dict[str, List[str]] = {}
    intermediates: Dict = {}
    proposal_dump: Dict = {}
    post = dict(POST_DICT_DEFAULTS, dataset_config=dc)
    ap_calc = APCalculator(0.5, dc.class2type) if also_detection else None

    for batch in loader:
        dev_batch, out = run_step(step, model, batch, dev)
        captions = out["lang_cap"]                       # (B, K, T) int
        bsize, num_proposals = captions.shape[:2]
        valid = _valid_rows(batch, bsize)

        nms_mask, detected_object_ids, ious, preds, gts = postprocess_batch(
            out, batch, post, min_iou, with_detection=ap_calc is not None)
        if attn_dump_step is not None:
            enc_attn, dec_attn = (a.cpu().numpy() for a in
                                  attn_dump_step(model, dev_batch, captions))
        keep = (nms_mask == 1) & (ious > min_iou)        # (B, K)
        for b in range(bsize):
            if not valid[b]:
                continue
            scene_id = dataset.annotations[int(batch["dataset_idx"][b])]["scene_id"]
            final_k = resolve_winning_proposals(keep[b], detected_object_ids[b], organized,
                                                scene_id)
            for key, k in final_k.items():
                caption = vocab.decode(captions[b, k])
                candidates[key] = [caption]
                if attn_dump_step is not None:
                    entry = {"token": caption.split(" "), "prop_id": k}
                    if enc_attn.size:
                        entry["encoder_attn_weights"] = enc_attn[:, b]
                    if dec_attn.size:
                        entry["decoder_attn_weights"] = dec_attn[:, b * num_proposals + k]
                    intermediates[key] = entry
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

    return candidates, ap_calc, intermediates, proposal_dump


def eval_visualize(
    step, model, dataset, loader,
    vocab: Vocabulary, organized: Dict, dc: ScannetDatasetConfig,
    out_root: str,
    scans_dir: Optional[str] = None,
    min_iou: float = EVAL_MIN_IOU,
    verbose: bool = False,
    nodryrun: bool = False,
    device="cuda",
) -> Dict[str, Dict]:
    """``--eval_visualize`` (reference scripts/eval.py:247-378): for every
    scene, dump ``vis/{scene}/``:

      * ``{scene}.ply``: the axis-aligned scene mesh when present under
        ``scans_dir`` (the reference copies ``{scene}_axis_aligned.ply``),
        else the evaluated point cloud as a point ply;
      * ``pred-{object_id}-{object_name}.ply``: a cylinder-edge box mesh
        per proposal that survives NMS, objectness and IoU > ``min_iou``,
        coloured ``COLORS[object_id % len(COLORS)]`` (:366-369);
      * ``predictions.json``: {object_id: {object_name, description}}.

    ``nodryrun=False`` (the reference default) only prints the paths.
    Returns {scene_id: candidates}."""
    import shutil

    from spacap3d_tpu_torch.utils.visualize import COLORS, write_bbox, write_ply

    dev = eval_device(model, device)
    post = dict(POST_DICT_DEFAULTS, dataset_config=dc)
    all_candidates: Dict[str, Dict] = {}
    for batch in loader:
        _, out = run_step(step, model, batch, dev)
        captions = out["lang_cap"]
        bsize = captions.shape[0]
        valid = _valid_rows(batch, bsize)
        nms_mask, det_ids, ious, _, _ = postprocess_batch(out, batch, post, min_iou,
                                                          with_detection=False)
        keep = (nms_mask == 1) & (ious > min_iou)
        for b in range(bsize):
            if not valid[b]:
                continue
            scene_id = dataset.annotations[int(batch["dataset_idx"][b])]["scene_id"]
            scene_root = os.path.join(out_root, "vis", scene_id)
            if verbose:
                print(">> scene root:", scene_root)
            if nodryrun:
                os.makedirs(scene_root, exist_ok=True)
                mesh_path = os.path.join(scene_root, f"{scene_id}.ply")
                mesh_src = (os.path.join(scans_dir, scene_id, f"{scene_id}_axis_aligned.ply")
                            if scans_dir else None)
                if mesh_src and os.path.exists(mesh_src):
                    shutil.copyfile(mesh_src, mesh_path)
                else:
                    write_ply(batch["point_clouds"][b, :, :3], mesh_path)
            # the last surviving proposal of an object wins, as the
            # reference's loop, which rewrites the object's entry and ply
            candidates: Dict[str, Dict] = {}
            for key, k in resolve_winning_proposals(keep[b], det_ids[b], organized,
                                                    scene_id).items():
                _, object_id, object_name = key.split("|")
                candidates[object_id] = {"object_name": object_name,
                                         "description": vocab.decode(captions[b, k])}
                ply_path = os.path.join(scene_root, f"pred-{object_id}-{object_name}.ply")
                if verbose:
                    print(ply_path)
                if nodryrun:
                    color = COLORS[int(object_id) % len(COLORS)]
                    write_bbox(out["bbox_corner"][b, k], ply_path,
                               color=tuple(int(x) for x in color))
            pred_path = os.path.join(scene_root, "predictions.json")
            if verbose:
                print("pred_path:", pred_path)
            if nodryrun:
                with open(pred_path, "w") as f:
                    json.dump(candidates, f, indent=4)
            all_candidates[scene_id] = candidates
    return all_candidates


def eval_detection(step, model, loader, dc: ScannetDatasetConfig, ap_iou: float = 0.5,
                   device="cuda") -> Dict:
    """Detection-only evaluation (reference scripts/eval.py:176-244
    eval_detection): parse predictions + groundtruths per batch, compute
    VOC AP/AR. Works for no-caption (detection-pretrain) models."""
    dev = eval_device(model, device)
    post = dict(POST_DICT_DEFAULTS, dataset_config=dc)
    calc = APCalculator(ap_iou, dc.class2type)
    for batch in loader:
        _, out = run_step(step, model, batch, dev)
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
    attn_dump_step=None,
    save_proposal: bool = False,
    dump_dir: Optional[str] = None,
    device="cuda",
):
    """Full caption (+ optional detection) evaluation pass; returns
    (metrics, candidates). With ``dump_dir``, the attention intermediates
    (``attn_dump_step``) go to ``attn_weights.pkl`` and the proposal dumps
    (``save_proposal``) to ``proposal_related.pkl`` there."""
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
    candidates, ap_calc, intermediates, proposal_dump = feed_scene_cap(
        step, model, dataset, loader, vocab, organized, dc,
        min_iou=min_iou, also_detection=also_detection, attn_dump_step=attn_dump_step,
        save_proposal=save_proposal, device=device,
    )
    if dump_dir and (intermediates or proposal_dump):
        import pickle
        os.makedirs(dump_dir, exist_ok=True)
        for name, dump in (("attn_weights.pkl", intermediates),
                           ("proposal_related.pkl", proposal_dump)):
            if dump:
                with open(os.path.join(dump_dir, name), "wb") as f:
                    pickle.dump(dump, f)
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

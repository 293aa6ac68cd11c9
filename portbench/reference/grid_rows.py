"""The reference's rows of a grid call: the frozen copy of the grid's host
post-processing (class NMS, the IoU match, the winning proposal, the
caption decode) and scoring (BLEU, CIDEr, ROUGE-L, METEOR without its
synonym stage, AP at IoU 0.5), run serially over the program's outputs of
every forward of the call, each row's host keys built again from the raw
scene. It imports nothing of the program."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench import synthetic
from portbench.reference.grid_check import dataset, grid_pairs
from portbench.reference.spacap.config import EVAL_MIN_IOU
from portbench.reference.spacap.data.scannet_config import ScannetDatasetConfig
from portbench.reference.spacap.eval import capeval
from portbench.reference.spacap.eval.detection import APCalculator
from portbench.reference.spacap.eval.eval_helper import (
    POST_DICT_DEFAULTS,
    caption_metrics,
    check_candidates,
    organize_annotations,
    organize_candidates,
    postprocess_batch,
    prepare_corpus,
    resolve_winning_proposals,
)

HOST_KEYS = ("dataset_idx", "scene_object_ids", "gt_box_corner_label", "box_label_mask",
             "sem_cls_label")


def rows(data: Dict, scenes: Dict, eval_list: List[dict], anns: List[dict], vocab_size: int,
         seeds: Sequence[int], outputs: List[Dict], batch: int,
         kept: Optional[List] = None) -> List[Dict]:
    """One metrics row a seed, as the grid computes it from ``outputs``
    (the program's outputs of each forward of the call, in stream order).
    ``kept``, where given, receives (detections, matched) of each row: its
    boxes that pass class NMS and the objectness mask, and those of them
    that also match their GT box at IoU over ``EVAL_MIN_IOU``."""
    ds = dataset(scenes, eval_list, vocab_size, data)
    vocab = synthetic.reference_vocabulary(vocab_size)
    dc = ScannetDatasetConfig()
    post = dict(POST_DICT_DEFAULTS, dataset_config=dc)
    corpus, organized = prepare_corpus(anns), organize_annotations(anns)
    n = len(seeds) * len(ds)
    pairs = grid_pairs(seeds, len(ds), batch)
    candidates = {s: {} for s in seeds}
    ap_rows = {s: {} for s in seeds}
    for f, out in enumerate(outputs):
        block = pairs[f * batch:(f + 1) * batch]
        items = [ds.getitem_cached(int(i), np.random.RandomState(
            (int(s) * 2654435761 + int(i)) % (2 ** 31)), with_points=False) for s, i in block]
        host = {k: np.stack([it[k] for it in items]) for k in HOST_KEYS}
        out = {k: (v.cpu() if torch.is_tensor(v) else torch.as_tensor(v)).numpy()
               for k, v in out.items()}
        nms_mask, det_ids, ious, preds, gts = postprocess_batch(out, host, post, EVAL_MIN_IOU)
        keep = (nms_mask == 1) & (ious > EVAL_MIN_IOU)
        for b, (seed, idx) in enumerate(block):
            if f * batch + b >= n:
                continue
            if kept is not None:
                kept.append((int((nms_mask[b] == 1).sum()), int(keep[b].sum())))
            scene_id = ds.annotations[int(idx)]["scene_id"]
            final_k = resolve_winning_proposals(keep[b], det_ids[b], organized, scene_id)
            candidates[int(seed)].update({key: [vocab.decode(out["lang_cap"][b, k])]
                                          for key, k in final_k.items()})
            ap_rows[int(seed)][int(idx)] = (preds[b], gts[b])
    refs = capeval.CiderRefs(corpus)
    meteor = capeval.Meteor(None, wordnet_dir="")
    result = []
    try:
        for s in seeds:
            cands = organize_candidates(corpus, check_candidates(corpus, dict(candidates[s])))
            metrics = caption_metrics(
                capeval.Bleu(4).compute_score(corpus, cands),
                capeval.Cider(refs=refs).compute_score(corpus, cands),
                capeval.Rouge().compute_score(corpus, cands),
                meteor.compute_score(corpus, cands))
            calc = APCalculator(0.5, dc.class2type)
            for idx in sorted(ap_rows[s]):
                pred, gt = ap_rows[s][idx]
                calc.step([pred], [gt])
            det = calc.compute_metrics(num_workers=1)
            metrics["mAP@0.5"], metrics["AR@0.5"] = det["mAP"], det["AR"]
            result.append({"seed": int(s), **metrics})
    finally:
        meteor.close()
    return result


def rows_gap(program: List[Dict], reference: List[Dict]) -> float:
    """The widest gap between a number of the program's rows and the
    reference's, seed by seed; infinite where the seeds or keys differ."""
    if [r["seed"] for r in program] != [r["seed"] for r in reference]:
        return float("inf")
    gap = 0.0
    for p, r in zip(program, reference):
        keys = {k for k, v in r.items() if isinstance(v, (int, float))}
        if keys != {k for k, v in p.items() if isinstance(v, (int, float))}:
            return float("inf")
        gap = max([gap] + [abs(float(p[k]) - float(r[k])) for k in keys])
    return gap

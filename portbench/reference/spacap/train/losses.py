"""Training losses, as ``spacap3d_tpu/train/losses.py`` (reference
lib/loss_helper.py:20-385): the same maths and weights, masked sums in
place of boolean indexing.

    det_loss = vote + 0.5 objectness + box + 0.1 sem_cls
    box_loss = center + 0.1 heading_cls + heading_reg + 0.1 size_cls + size_reg
    loss     = 10 det_loss + cap_loss + 0.1 relation_loss

Proposals whose centre lies within NEAR_THRESHOLD (0.3 m) of a GT centre
are positive, beyond FAR_THRESHOLD (0.6 m) negative; the zone between is
masked out. Objectness class weights (0.2, 0.8).

With a ``group`` of ranks, each holding a row-block of one global batch,
every value here is this rank's share of the global batch's value: a
masked mean keeps its numerator local and divides by the count of the
whole group (all-reduced, without a gradient; the 1e-6 added once, to the
global count), and a ratio divides by the global number of proposals. The
shares sum over the ranks to the global values, and their gradients sum
to the global batch's gradient (``train/step.py`` all-reduces both).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

from portbench.reference.spacap.config import GT_VOTE_FACTOR
from portbench.reference.spacap.models.core import active_group
from portbench.reference.spacap.ops.nn_distance import huber_loss, nn_distance

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)

LOSS_KEYS = ("vote_loss", "objectness_loss", "center_loss", "heading_cls_loss",
             "heading_reg_loss", "size_cls_loss", "size_reg_loss", "sem_cls_loss",
             "box_loss")


def _global_count(count: torch.Tensor, group) -> torch.Tensor:
    """``count`` summed over ``group`` (no gradient); itself without one."""
    if group is None:
        return count
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return count


def _masked_mean(x, mask, eps=1e-6, group=None):
    return (x * mask).sum() / (_global_count(mask.sum(), group) + eps)



def _take(x, idx):
    """x (B, M, ...) at idx (B, K) along axis 1 -> (B, K, ...)."""
    idx = idx.long()
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]))


def _pick(x, idx):
    """x (..., C) at the last-axis index idx (...) -> (...)."""
    return torch.gather(x, -1, idx.long()[..., None])[..., 0]


def _ce(logits, labels):
    """Per-element cross entropy: logits (..., C), int labels (...)."""
    return -_pick(torch.log_softmax(logits, dim=-1), labels)


def compute_vote_loss(ep: Dict, group=None) -> torch.Tensor:
    """Min-of-min L1 distance between each seed's votes and its 3 replicated
    GT votes (reference :20-67)."""
    b, num_seed, _ = ep["seed_xyz"].shape
    seed_inds = ep["seed_inds"]
    mask = _take(ep["vote_label_mask"], seed_inds).float()
    gt = _take(ep["vote_label"], seed_inds) + ep["seed_xyz"].repeat(1, 1, GT_VOTE_FACTOR)
    votes = ep["vote_xyz"].reshape(b * num_seed, -1, 3)
    _, _, dist2, _ = nn_distance(votes, gt.reshape(b * num_seed, GT_VOTE_FACTOR, 3), l1=True)
    return _masked_mean(dist2.amin(1).reshape(b, num_seed), mask, group=group)


def compute_objectness_loss(ep: Dict, group=None):
    """Reference :69-108. Returns loss, labels, mask, object_assignment."""
    dist1, ind1, _, _ = nn_distance(ep["aggregated_vote_xyz"], ep["center_label"][:, :, :3])
    edist = torch.sqrt(dist1 + 1e-6)
    label = (edist < NEAR_THRESHOLD).to(torch.int32)
    mask = ((edist < NEAR_THRESHOLD) | (edist > FAR_THRESHOLD)).float()
    # the class weight of each label, without a host-to-device copy
    w = torch.where(label != 0, OBJECTNESS_CLS_WEIGHTS[1], OBJECTNESS_CLS_WEIGHTS[0])
    per = _ce(ep["objectness_scores"], label) * w
    return _masked_mean(per, mask, group=group), label, mask, ind1


def compute_box_and_sem_cls_loss(ep: Dict, mean_size_arr: torch.Tensor, num_heading_bin: int,
                                 num_size_cluster: int, group=None):
    """Reference :111-197."""
    mm = functools.partial(_masked_mean, group=group)
    assign = ep["object_assignment"]
    objn = ep["objectness_label"].float()

    dist1, _, dist2, _ = nn_distance(ep["center"], ep["center_label"][:, :, :3])
    center_loss = mm(dist1, objn) + mm(dist2, ep["box_label_mask"].float())

    heading_label = _take(ep["heading_class_label"], assign)
    heading_cls_loss = mm(_ce(ep["heading_scores"], heading_label), objn)
    heading_res_norm_label = (_take(ep["heading_residual_label"], assign)
                              / (math.pi / num_heading_bin))
    pred_res = _pick(ep["heading_residuals_normalized"], heading_label)
    heading_reg_loss = mm(huber_loss(pred_res - heading_res_norm_label, 1.0), objn)

    size_label = _take(ep["size_class_label"], assign).long()
    size_cls_loss = mm(_ce(ep["size_scores"], size_label), objn)
    size_res_label = _take(ep["size_residual_label"], assign)                   # (B, K, 3)
    pred_size_res = torch.gather(ep["size_residuals_normalized"], 2,
                                 size_label[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    size_res_norm_label = size_res_label / mean_size_arr[size_label]
    size_reg_loss = mm(
        huber_loss(pred_size_res - size_res_norm_label, 1.0).mean(-1), objn)

    sem_label = _take(ep["sem_cls_label"], assign)
    sem_cls_loss = mm(_ce(ep["sem_cls_scores"], sem_label), objn)
    return (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss, size_reg_loss,
            sem_cls_loss)


def compute_cap_loss(ep: Dict, group=None):
    """Reference :199-238: cross entropy against lang_ids[:, 1:T+1] with pads
    (id 0) ignored, over every token slot of every good box (pads count in
    the denominator, as in the reference)."""
    pred = ep["lang_cap"]                               # (B, T, V) log-probs
    b, t, _ = pred.shape
    target = ep["lang_ids"][:, 1:t + 1]
    valid = (target != 0).float()
    nll = -_pick(pred, target) * valid
    good = ep["good_bbox_masks"].float()[:, None]       # (B, 1)
    cap_loss = (nll * good).sum() / (_global_count(good.expand(b, t).sum(), group) + 1e-6)
    correct = (pred.argmax(-1) == target).float() * valid * good
    denom = _global_count((valid * good).sum(), group)
    cap_acc = torch.where(denom > 0, correct.sum() / denom, 0.0)
    return cap_loss, cap_acc


def compute_relation_loss(ep: Dict, group=None):
    """Reference :240-289: the K x K relation labels gathered from the
    MAX_NUM_OBJ x MAX_NUM_OBJ ground truth through object_assignment on both
    axes; cross entropy averaged over the pairs whose proposals are both
    positive and assigned to a real box."""
    assign = ep["object_assignment"].long()                     # (B, K)
    rows = torch.arange(assign.shape[0], device=assign.device)[:, None, None]
    valid = (_take(ep["box_label_mask_int"], assign)
             & ep["objectness_label"].to(ep["box_label_mask_int"].dtype)).float()
    pair_mask = valid[:, :, None] * valid[:, None, :]           # (B, K, K)
    losses, accs = [], []
    for i, axis in enumerate(("x", "y", "z")):
        label = ep[f"{axis}_label"][rows, assign[:, :, None], assign[:, None, :]]
        logits = ep["relation_pred"][..., 3 * i:3 * i + 3]
        losses.append(_masked_mean(_ce(logits, label), pair_mask, group=group))
        accs.append(_masked_mean((logits.argmax(-1) == label).float(), pair_mask,
                                 group=group))
    return tuple(losses) + tuple(accs)


def get_scene_cap_loss(ep: Dict, mean_size_arr: torch.Tensor, num_heading_bin: int = 1,
                       num_size_cluster: int = 18, detection: bool = True,
                       caption: bool = True, use_relation: bool = False,
                       group: Optional["dist.ProcessGroup"] = None) -> Dict:
    """The endpoints plus every loss scalar the reference logs
    (:291-385), and the total ``loss``; with a ``group`` of more than one
    rank, this rank's shares of them (module docstring)."""
    group = active_group(group)
    out = dict(ep)
    zero = torch.zeros((), device=ep["vote_xyz"].device)

    vote_loss = compute_vote_loss(ep, group)
    objectness_loss, obj_label, obj_mask, assign = compute_objectness_loss(ep, group)
    out["objectness_label"], out["objectness_mask"] = obj_label, obj_mask
    out["object_assignment"] = assign
    total = obj_label.numel() * (1 if group is None else dist.get_world_size(group))
    out["pos_ratio"] = obj_label.float().sum() / total
    out["neg_ratio"] = obj_mask.sum() / total - out["pos_ratio"]

    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss, size_reg_loss,
     sem_cls_loss) = compute_box_and_sem_cls_loss(out, mean_size_arr, num_heading_bin,
                                                  num_size_cluster, group)
    box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss
                + 0.1 * size_cls_loss + size_reg_loss)
    out["obj_acc"] = _masked_mean((ep["bbox_mask"] == obj_label).float(), obj_mask,
                                  group=group)

    if use_relation:
        x_loss, y_loss, z_loss, x_acc, y_acc, z_acc = compute_relation_loss(out, group)
        out.update(x_loss=x_loss, y_loss=y_loss, z_loss=z_loss, x_acc=x_acc, y_acc=y_acc,
                   z_acc=z_acc, relation_loss=x_loss + y_loss + z_loss)
    else:
        out.update({k: zero for k in ("x_loss", "y_loss", "z_loss", "x_acc", "y_acc",
                                      "z_acc", "relation_loss")})

    if detection:
        out.update(vote_loss=vote_loss, objectness_loss=objectness_loss,
                   center_loss=center_loss, heading_cls_loss=heading_cls_loss,
                   heading_reg_loss=heading_reg_loss, size_cls_loss=size_cls_loss,
                   size_reg_loss=size_reg_loss, sem_cls_loss=sem_cls_loss, box_loss=box_loss)
    else:
        out.update({k: zero for k in LOSS_KEYS + ("det_loss",)})

    if caption:
        out["cap_loss"], out["cap_acc"] = compute_cap_loss(out, group)
    else:
        out["cap_loss"] = out["cap_acc"] = out["pred_ious"] = zero

    loss = zero
    if detection:
        out["det_loss"] = (out["vote_loss"] + 0.5 * out["objectness_loss"]
                           + out["box_loss"] + 0.1 * out["sem_cls_loss"])
        loss = loss + 10.0 * out["det_loss"]
    if caption:
        loss = loss + out["cap_loss"]
    if use_relation:
        loss = loss + 0.1 * out["relation_loss"]
    out["loss"] = loss
    return out

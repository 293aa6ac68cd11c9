"""The train and eval steps, as ``spacap3d_tpu/train/step.py``.

Train: forward (batch-statistics BN, dropout), losses, backward, two-group
Adam with torch's coupled weight decay (the JAX chain
``add_decayed_weights -> scale_by_adam -> lr``) and the BN running-stat
update. Eval: the eval forward (with greedy decode) plus the detection
side-outputs the eval harness reads. The attention dump: the detector in
eval mode, then the teacher-forced captioner over the greedy tokens.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from spacap3d_tpu_torch.config import ModelConfig, TrainConfig
from spacap3d_tpu_torch.device import resolve_device
from spacap3d_tpu_torch.ops.nn_distance import nn_distance
from spacap3d_tpu_torch.train.losses import NEAR_THRESHOLD, get_scene_cap_loss

# metrics a train step returns (the reference Solver's log keys)
METRIC_KEYS = (
    "loss", "det_loss", "cap_loss", "relation_loss", "vote_loss",
    "objectness_loss", "box_loss", "center_loss", "heading_cls_loss",
    "heading_reg_loss", "size_cls_loss", "size_reg_loss", "sem_cls_loss",
    "cap_acc", "obj_acc", "pos_ratio", "neg_ratio", "pred_ious",
    "x_loss", "y_loss", "z_loss", "x_acc", "y_acc", "z_acc",
)
# the batch keys the train step reads
TRAIN_KEYS = (
    "point_clouds", "vote_label", "vote_label_mask", "center_label",
    "heading_class_label", "heading_residual_label", "size_class_label",
    "size_residual_label", "sem_cls_label", "box_label_mask", "box_label_mask_int",
    "ref_center_label", "lang_ids", "lang_label", "x_label", "y_label", "z_label",
)

# the batch keys the eval step reads (outside point-table mode)
EVAL_INPUT_KEYS = ("point_clouds", "center_label")
COMPACT_KEYS = (
    "lang_cap", "bbox_lo", "bbox_hi", "bbox_mask",
    "objectness_scores", "sem_cls_scores",
    "object_assignment", "nonempty_box",
)
FULL_KEYS = (
    "lang_cap", "bbox_corner", "bbox_mask", "objectness_scores",
    "sem_cls_scores", "sem_cls", "center", "object_assignment",
    "objectness_label", "aggregated_vote_xyz", "nonempty_box",
)


def to_device_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``device``; floats as f32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.is_floating_point():
            t = t.to(torch.float32)
        out[k] = t.to(device)
    return out


def gather_point_table(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Point-table mode: each row names a scene of ``point_table`` and the
    indices of its subsampled points."""
    rows = batch["scene_row"].long()
    scene_pts = batch["point_table"][rows]                      # (B, P, C)
    choices = batch["pc_choices"].long()[..., None].expand(-1, -1, scene_pts.shape[-1])
    return {"point_clouds": torch.gather(scene_pts, 1, choices),
            "center_label": batch["center_table"][rows]}


def eval_tail(cfg: ModelConfig, ep: Dict[str, torch.Tensor],
              batch: Dict[str, torch.Tensor], compact: bool) -> Dict[str, torch.Tensor]:
    """Objectness label / GT assignment, the >= 5-points non-empty box test
    and the compact narrowing; returns the output dict."""
    dist1, ind1, _, _ = nn_distance(ep["aggregated_vote_xyz"], batch["center_label"][:, :, :3])
    ep["objectness_label"] = (torch.sqrt(dist1 + 1e-6) < NEAR_THRESHOLD).to(torch.int32)
    ep["object_assignment"] = ind1
    lo = ep["bbox_corner"].amin(dim=2)                          # (B, K, 3)
    hi = ep["bbox_corner"].amax(dim=2)
    pc3 = batch["point_clouds"][..., :3]
    inside = None
    for a in range(3):                                          # (B, K, N) per axis
        p = pc3[:, None, :, a]
        in_a = (p >= lo[:, :, None, a]) & (p <= hi[:, :, None, a])
        inside = in_a if inside is None else inside & in_a
    ep["nonempty_box"] = inside.sum(dim=-1) >= 5
    if compact:
        ep["bbox_lo"], ep["bbox_hi"] = lo, hi
        if "lang_cap" in ep and cfg.vocab_size < 65536:
            ep["lang_cap"] = ep["lang_cap"].to(torch.uint16)
        ep["bbox_mask"] = ep["bbox_mask"] != 0
        ep["object_assignment"] = ep["object_assignment"].to(torch.uint16)
    keys = COMPACT_KEYS if compact else FULL_KEYS
    return {k: ep[k] for k in keys if k in ep}


def make_eval_step(cfg: ModelConfig, device="cuda", compact: bool = False) -> Callable:
    """Returns step(model, batch) -> output dict of tensors on ``device``.

    ``batch`` holds ``point_clouds`` (B, N, 3 + D) and ``center_label``
    (B, G, 3+), or the point-table keys ``point_table``, ``scene_row``,
    ``pc_choices`` and ``center_table``."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(model, batch) -> Dict[str, torch.Tensor]:
        batch = to_device_batch(batch, dev)
        if "pc_choices" in batch:
            batch = gather_point_table(batch)
        model.eval()
        ep = model(batch["point_clouds"])
        return eval_tail(cfg, ep, batch, compact)

    return step


def make_attn_dump_step(device="cuda") -> Callable:
    """Returns dump(model, batch, tokens) -> (enc_attn (L, B, h, K, K),
    dec_attn (L, B*K, h, T', T')), as the JAX package's
    ``make_attn_dump_step``: the detector in eval mode over
    ``batch["point_clouds"]``, then ``Captioner.attention_dump`` over the
    generated ``tokens`` (B, K, T), on ``device``."""
    dev = resolve_device(device)

    @torch.no_grad()
    def dump(model, batch, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        ep = model.detect(to_device_batch({"point_clouds": batch["point_clouds"]},
                                          dev)["point_clouds"])
        return model.caption.attention_dump(ep, torch.as_tensor(tokens).to(dev))

    return dump


def make_optimizer(model: torch.nn.Module, tc: TrainConfig, steps_per_epoch: int
                   ) -> Tuple[torch.optim.Adam, Optional[torch.optim.lr_scheduler.MultiStepLR]]:
    """Adam (betas 0.9 / 0.999, eps 1e-8, coupled weight decay ``tc.wd``) in
    two groups: ``caption.*`` at ``tc.transformer_lr``, the rest at
    ``tc.lr``. ``no_detection`` leaves the trunk's parameters out (its BN
    running stats still move). Detection pretraining (``no_caption``) with
    ``lr_decay_step`` also returns a MultiStepLR, to be stepped once an
    update, that decays the rate by ``lr_decay_rate`` from the update of
    index ``epoch * steps_per_epoch`` on; else the scheduler is None."""
    groups = {"base": [], "caption": []}
    for name, p in model.named_parameters():
        if name.startswith("caption."):
            groups["caption"].append(p)
        elif not tc.no_detection:
            groups["base"].append(p)
    params = [{"params": groups["base"], "lr": tc.lr},
              {"params": groups["caption"], "lr": tc.transformer_lr}]
    opt = torch.optim.Adam([g for g in params if g["params"]], betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=tc.wd)
    sched = None
    if tc.no_caption and tc.lr_decay_step:
        sched = torch.optim.lr_scheduler.MultiStepLR(
            opt, [int(e) * steps_per_epoch for e in tc.lr_decay_step], gamma=tc.lr_decay_rate)
    return opt, sched


def make_train_step(cfg: ModelConfig, tc: TrainConfig, optimizer: torch.optim.Optimizer,
                    device="cuda", scheduler=None) -> Callable:
    """Returns step(model, batch, gen=None, bn_momentum=0.1, marks=None) ->
    metrics, a dict of 0-dim tensors on ``device`` (``METRIC_KEYS``) taken
    in the forward, before the update. A step sets ``model.train()``, runs
    the train forward (dropout masks from ``gen``, BN running stats moved
    at ``bn_momentum``), the losses and the backward, and steps
    ``optimizer`` (and ``scheduler``). The gradients stay in ``.grad``
    until the next step. ``batch`` holds ``TRAIN_KEYS`` as numpy arrays or
    tensors. On a CUDA device a list ``marks`` receives five timing events,
    recorded before the forward and after the forward, the losses, the
    backward and the optimizer step: the step's split into those parts."""
    dev = resolve_device(device)

    def mark(marks):
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

    def step(model, batch, gen: Optional[torch.Generator] = None,
             bn_momentum: float = 0.1, marks: Optional[list] = None
             ) -> Dict[str, torch.Tensor]:
        batch = to_device_batch({k: batch[k] for k in TRAIN_KEYS}, dev)
        model.train()
        mark(marks)
        ep = model.train_forward(batch, gen, bn_momentum)
        mark(marks)
        ep = get_scene_cap_loss(
            ep, model.mean_size_arr, cfg.num_heading_bin, cfg.num_size_cluster,
            detection=not tc.no_detection, caption=not tc.no_caption,
            use_relation=tc.use_relation and cfg.check_relation)
        mark(marks)
        model.zero_grad(set_to_none=True)
        ep["loss"].backward()
        mark(marks)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        mark(marks)
        return {k: ep[k].detach() for k in METRIC_KEYS if k in ep}

    return step

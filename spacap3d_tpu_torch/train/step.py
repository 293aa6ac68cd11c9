"""The eval step: the eval forward (with greedy decode) plus the detection
side-outputs the eval harness reads, as ``spacap3d_tpu/train/step.py::
make_eval_step``."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from spacap3d_tpu_torch.config import ModelConfig
from spacap3d_tpu_torch.device import resolve_device
from spacap3d_tpu_torch.ops.nn_distance import nn_distance

# proposals whose centre lies within this distance (m) of a GT centre are
# positive (spacap3d_tpu/train/losses.py)
NEAR_THRESHOLD = 0.3

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

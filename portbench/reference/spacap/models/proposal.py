"""Proposal module: vote aggregation + box / objectness / semantic head,
with the box corners computed on the device (as
``spacap3d_tpu/models/proposal.py``)."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from portbench.reference.spacap import ops
from portbench.reference.spacap.models.backbone import SAModule
from portbench.reference.spacap.models.core import BatchNorm, Dense, Momentum, run_layers


def head_out_dim(num_heading_bin: int, num_size_cluster: int, num_class: int) -> int:
    return 2 + 3 + num_heading_bin * 2 + num_size_cluster * 4 + num_class


class Proposal(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg.proposal_feature_dim
        self.num_heading_bin = cfg.num_heading_bin
        self.num_size_cluster = cfg.num_size_cluster
        self.size_decoded = cfg.size_decoded
        self.vote_aggregation = SAModule(
            cfg.num_proposals, cfg.agg_radius, cfg.agg_nsample,
            [cfg.seed_feature_dim, d, d, d])
        out_dim = head_out_dim(cfg.num_heading_bin, cfg.num_size_cluster, cfg.num_class)
        # reference Sequential indices: 0 conv, 1 bn, 3 conv, 4 bn, 6 conv
        self.proposal = nn.Sequential(
            Dense(d, d, bias=False, kernel_dims=(1,)), BatchNorm(d), nn.ReLU(),
            Dense(d, d, bias=False, kernel_dims=(1,)), BatchNorm(d), nn.ReLU(),
            Dense(d, out_dim, kernel_dims=(1,)),
        )

    def forward(self, vote_xyz, vote_features, mean_size_arr,
                momentum: Optional[Momentum] = None) -> Dict[str, torch.Tensor]:
        """``momentum`` moves the batch norms' running stats in train mode."""
        new_xyz, feats, inds = self.vote_aggregation(vote_xyz, vote_features, momentum)
        out = {
            "aggregated_vote_xyz": new_xyz,
            "aggregated_vote_features": feats,
            "aggregated_vote_inds": inds,
        }
        net = run_layers(self.proposal, feats, momentum)
        out.update(decode_scores(net, new_xyz, mean_size_arr, self.num_heading_bin,
                                 self.num_size_cluster, self.size_decoded))
        out["bbox_feature"] = feats
        return out


def decode_scores(net, base_xyz, mean_size_arr, num_heading_bin: int,
                  num_size_cluster: int, size_decoded: bool) -> Dict[str, torch.Tensor]:
    """Split the head logits into box parameters; corners on the device."""
    nh, ns = num_heading_bin, num_size_cluster
    b, k, _ = net.shape
    objectness_scores = net[..., 0:2]
    center = base_xyz + net[..., 2:5]
    heading_residuals_normalized = net[..., 5 + nh:5 + nh * 2]
    size_scores = net[..., 5 + nh * 2:5 + nh * 2 + ns]
    size_residuals_normalized = net[..., 5 + nh * 2 + ns:5 + nh * 2 + ns * 4].reshape(b, k, ns, 3)
    sem_cls_scores = net[..., 5 + nh * 2 + ns * 4:]
    size_residuals = size_residuals_normalized * mean_size_arr
    out = {
        "objectness_scores": objectness_scores,
        "center": center,
        "heading_scores": net[..., 5:5 + nh],
        "heading_residuals_normalized": heading_residuals_normalized,
        "heading_residuals": heading_residuals_normalized * (math.pi / nh),
        "size_scores": size_scores,
        "size_residuals_normalized": size_residuals_normalized,
        "size_residuals": size_residuals,
    }
    pred_size_class = torch.argmax(size_scores, dim=-1)                   # (B, K)
    size_recover = size_residuals + mean_size_arr                           # (B, K, NS, 3)
    pred_size = torch.gather(
        size_recover, 2, pred_size_class[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
    if size_decoded:
        out["pred_size"] = pred_size
    # ScanNet headings are always 0: axis-aligned corners, detached as the
    # reference detaches them
    out["bbox_corner"] = ops.get_3d_box_batch(pred_size.detach(), None, center.detach())
    out["sem_cls_scores"] = sem_cls_scores
    out["bbox_mask"] = torch.argmax(objectness_scores, dim=-1).to(torch.int32)
    out["bbox_sems"] = torch.argmax(sem_cls_scores, dim=-1).to(torch.int32)
    out["sem_cls"] = out["bbox_sems"]
    return out

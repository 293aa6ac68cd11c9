"""SpaCapNet: backbone -> voting -> proposal -> captioner, the eval forward
(greedy decode) and the train forward (teacher forcing).

The module tree carries the reference state-dict names
(``backbone_net.*``, ``vgen.*``, ``proposal.*``, ``caption.*``), so the
port's ``state_dict()`` and a reference checkpoint share their keys.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from portbench.reference.spacap.config import ModelConfig
from portbench.reference.spacap.data.scannet_config import mean_size_arr as default_mean_size_arr
from portbench.reference.spacap.device import resolve_device
from portbench.reference.spacap.models.backbone import Backbone
from portbench.reference.spacap.models.captioner import Captioner
from portbench.reference.spacap.models.core import Momentum, reset_parameters
from portbench.reference.spacap.models.proposal import Proposal
from portbench.reference.spacap.models.voting import Voting


class SpaCapNet(nn.Module):
    def __init__(self, cfg: ModelConfig, mean_size_arr: Optional[np.ndarray] = None):
        super().__init__()
        if cfg.d_model != cfg.proposal_feature_dim:
            raise ValueError("captioner d_model must equal the proposal feature dim")
        self.cfg = cfg
        self.backbone_net = Backbone(cfg)
        self.vgen = Voting(cfg.seed_feature_dim, cfg.vote_factor)
        self.proposal = Proposal(cfg)
        if not cfg.no_caption:
            self.caption = Captioner(cfg)
        msa = default_mean_size_arr() if mean_size_arr is None else mean_size_arr
        self.register_buffer("mean_size_arr", torch.as_tensor(np.asarray(msa, np.float32)),
                             persistent=False)

    def detect(self, point_clouds: torch.Tensor,
               bn_momentum: Optional[Momentum] = None) -> Dict[str, torch.Tensor]:
        """Detector trunk: point_clouds (B, N, 3 + D) -> endpoint dict. In
        train mode the batch norms move their running stats at
        ``bn_momentum``."""
        ep = self.backbone_net(point_clouds, bn_momentum)
        ep["seed_inds"] = ep["fp2_inds"]
        ep["seed_xyz"] = ep["fp2_xyz"]
        ep["seed_features"] = ep["fp2_features"]
        vote_xyz, vote_features = self.vgen(ep["seed_xyz"], ep["seed_features"], bn_momentum)
        vote_features = vote_features / torch.linalg.vector_norm(
            vote_features, dim=-1, keepdim=True)
        ep["vote_xyz"] = vote_xyz
        ep["vote_features"] = vote_features
        ep.update(self.proposal(vote_xyz, vote_features, self.mean_size_arr, bn_momentum))
        return ep

    def train_forward(self, batch: Dict[str, torch.Tensor],
                      gen: Optional[torch.Generator] = None,
                      bn_momentum: Momentum = 0.1) -> Dict[str, torch.Tensor]:
        """The batch (``point_clouds`` and the label keys) plus the detector
        and teacher-forced captioner endpoints, as the JAX package's
        ``apply_spacap(is_eval=False, train=True)``. In train mode (the
        caller's ``model.train()``) batch norm uses the batch statistics
        and moves its running stats at ``bn_momentum``, and the captioner
        drops out with masks drawn from ``gen``."""
        ep = dict(batch)
        ep.update(self.detect(batch["point_clouds"], bn_momentum))
        if not self.cfg.no_caption:
            ep.update(self.caption.train_forward(ep, gen, bn_momentum))
        return ep

    def forward(self, point_clouds: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Detector endpoints, plus greedy captions ``lang_cap`` (B, K, T)."""
        ep = self.detect(point_clouds)
        if not self.cfg.no_caption:
            ep["lang_cap"] = self.caption(ep)
        return ep


def init_spacap(cfg: ModelConfig, mean_size_arr: Optional[np.ndarray] = None,
                seed: int = 0, device="cuda") -> SpaCapNet:
    """A SpaCapNet with seeded random weights (the JAX package's init
    families), in eval mode, on ``device``."""
    dev = resolve_device(device)
    model = SpaCapNet(cfg, mean_size_arr)
    reset_parameters(model, seed)
    return model.eval().to(dev)

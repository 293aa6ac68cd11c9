"""Hough voting (as ``spacap3d_tpu/models/voting.py``): three 1x1 convs with
BN + ReLU on the first two; per-seed xyz offsets and feature residuals."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from spacap3d_tpu_torch.models.core import BatchNorm, Dense, Momentum


class Voting(nn.Module):
    def __init__(self, seed_feature_dim: int = 256, vote_factor: int = 1):
        super().__init__()
        d = seed_feature_dim
        self.vote_factor = vote_factor
        self.conv1 = Dense(d, d, kernel_dims=(1,))
        self.conv2 = Dense(d, d, kernel_dims=(1,))
        self.conv3 = Dense(d, (3 + d) * vote_factor, kernel_dims=(1,))
        self.bn1 = BatchNorm(d)
        self.bn2 = BatchNorm(d)

    def forward(self, seed_xyz: torch.Tensor, seed_features: torch.Tensor,
                momentum: Optional[Momentum] = None):
        """(B, M, 3), (B, M, C) -> vote_xyz (B, M*vf, 3), vote_features (B,
        M*vf, C); ``momentum`` moves the batch norms' running stats in train
        mode."""
        b, m, _ = seed_xyz.shape
        c = seed_features.shape[-1]
        vf = self.vote_factor
        net = torch.relu(self.bn1(self.conv1(seed_features), momentum))
        net = torch.relu(self.bn2(self.conv2(net), momentum))
        net = self.conv3(net).reshape(b, m, vf, 3 + c)
        vote_xyz = (seed_xyz[:, :, None, :] + net[..., 0:3]).reshape(b, m * vf, 3)
        vote_features = (seed_features[:, :, None, :] + net[..., 3:]).reshape(b, m * vf, c)
        return vote_xyz, vote_features

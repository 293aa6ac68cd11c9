"""PointNet++ backbone: 4 set-abstraction (SA) and 2 feature-propagation
(FP) layers, as ``spacap3d_tpu/models/backbone.py``.

SA = FPS -> gather -> ball query -> group (centre-subtract, / radius) ->
shared MLP -> max over neighbours. SA2-4 take the FPS identity order: their
inputs are already FPS-ordered. FP = 3-NN interpolation with weights
1 / (d^2 + 1e-8), normalised, then skip concat and shared MLP.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from portbench.reference.spacap import ops
from portbench.reference.spacap.models.core import BatchNorm, Dense, Momentum


class _BNWrap(nn.Module):
    """Holds the batch norm as ``.bn`` (reference key ``bn.bn.*``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.bn = BatchNorm(dim)

    def forward(self, x, momentum=None):
        return self.bn(x, momentum)


class SharedMLPLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv = Dense(in_dim, out_dim, bias=False, kernel_dims=(1, 1), init="kaiming")
        self.bn = _BNWrap(out_dim)

    def forward(self, x, momentum=None):
        return torch.relu(self.bn(self.conv(x), momentum))


class SharedMLP(nn.Module):
    """[dense (no bias) + BN + ReLU] x len(dims) - 1, as ``layer0``, ``layer1``..."""

    def __init__(self, dims: List[int]):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"layer{i}", SharedMLPLayer(dims[i], dims[i + 1]))

    def forward(self, x, momentum=None):
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x, momentum)
        return x


class SAModule(nn.Module):
    def __init__(self, npoint: int, radius: float, nsample: int, mlp: List[int],
                 use_xyz: bool = True, normalize_xyz: bool = True,
                 fps_identity: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz, self.normalize_xyz = use_xyz, normalize_xyz
        self.fps_identity = fps_identity
        dims = list(mlp)
        if use_xyz:
            dims[0] += 3
        self.mlp_module = SharedMLP(dims)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                momentum: Optional[Momentum] = None):
        """xyz (B, N, 3), features (B, N, C) or None -> (new_xyz (B, np, 3),
        new_features (B, np, mlp[-1]), inds (B, np) int32). ``momentum``
        moves the batch norms' running stats in train mode."""
        b = xyz.shape[0]
        xyz = xyz.contiguous()
        if self.fps_identity:
            inds = torch.arange(self.npoint, dtype=torch.int32,
                                device=xyz.device).expand(b, self.npoint)
        else:
            inds = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, inds)
        idx = ops.ball_query(xyz, new_xyz, self.radius, self.nsample)
        if features is not None and self.use_xyz:
            cat = torch.cat([xyz, features], dim=-1)
            grouped = ops.group_and_localize(
                cat, idx, new_xyz, self.radius if self.normalize_xyz else None)
        elif features is not None:
            grouped = ops.group_points(features, idx)
        else:
            grouped = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
            if self.normalize_xyz:
                grouped = grouped / self.radius
        new_features = self.mlp_module(grouped, momentum).amax(dim=2)
        return new_xyz, new_features, inds


class FPModule(nn.Module):
    def __init__(self, dims: List[int]):
        super().__init__()
        self.mlp = SharedMLP(dims)

    def forward(self, unknown, known, unknown_feats, known_feats, momentum=None):
        dist2, idx = ops.three_nn(unknown, known)
        dist_recip = 1.0 / (dist2 + 1e-8)
        weight = dist_recip / dist_recip.sum(dim=2, keepdim=True)
        new_features = ops.three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            new_features = torch.cat([new_features, unknown_feats], dim=-1)
        return self.mlp(new_features, momentum)


class Backbone(nn.Module):
    """point_clouds (B, N, 3 + input_feature_dim) -> endpoint dict;
    ``momentum`` moves the batch norms' running stats in train mode."""

    def __init__(self, cfg):
        super().__init__()
        in_dim = cfg.input_feature_dim
        for i in range(4):
            widths = list(cfg.sa_widths[i])
            self.add_module(f"sa{i + 1}", SAModule(
                cfg.sa_npoints[i], cfg.sa_radii[i], cfg.sa_nsamples[i],
                [in_dim] + widths, fps_identity=i > 0))
            in_dim = widths[-1]
        w = cfg.fp_width
        self.fp1 = FPModule([cfg.sa_widths[2][-1] + cfg.sa_widths[3][-1], w, w])
        self.fp2 = FPModule([cfg.sa_widths[1][-1] + w, w, w])

    def forward(self, point_clouds: torch.Tensor,
                momentum: Optional[Momentum] = None) -> Dict[str, torch.Tensor]:
        xyz = point_clouds[..., :3]
        features = point_clouds[..., 3:] if point_clouds.shape[-1] > 3 else None
        out: Dict[str, torch.Tensor] = {}
        for name in ("sa1", "sa2", "sa3", "sa4"):
            xyz, features, inds = getattr(self, name)(xyz, features, momentum)
            out[f"{name}_inds"] = inds
            out[f"{name}_xyz"] = xyz
            out[f"{name}_features"] = features
        feats = self.fp1(out["sa3_xyz"], out["sa4_xyz"],
                         out["sa3_features"], out["sa4_features"], momentum)
        feats = self.fp2(out["sa2_xyz"], out["sa3_xyz"], out["sa2_features"], feats, momentum)
        out["fp2_features"] = feats
        out["fp2_xyz"] = out["sa2_xyz"]
        out["fp2_inds"] = out["sa1_inds"][:, :out["fp2_xyz"].shape[1]]
        return out

"""ENet, the 2D semantic-segmentation CNN whose stage-3 feature map feeds the
multiview path, as ``spacap3d_tpu/models/enet.py`` (reference lib/enet.py:
130-715): an initial block, three bottleneck stages and a 1x1 classifier.
The multiview path reads the 128-channel map after stage 3 (1/8 of the
frame: 32 x 41 for 256 x 328 frames). NCHW throughout.

The module tree carries the reference checkpoint's ``nn.Sequential``
indices, so ``scannetv2_enet.pth`` loads with ``load_state_dict(strict=True)``
(parameterless modules fill the indices that hold no weights):

  0.0 initial 3x3/s2 conv (0.1 its max-pool) | 1 concat | 2 BN | 3 PReLU |
  4 s1_down | 5-8 s1_b0..3 | 9 s2_down | 10-17 stage 2 | 18-25 stage 3 |
  26.0 classifier (1x1, no bias)

A block X holds its extension branch at ``X.0.0``, its main branch at
``X.0.1``, the sum at ``X.1`` and the output PReLU at ``X.2``. The
extension branch is

  regular, down:  0 conv1 | 1 BN | 2 PReLU | 3 conv2 (with bias) | 4 BN |
                  5 PReLU | 6 conv3 | 7 BN | 8 dropout
  asymmetric:     0 conv1 | 1 BN | 2 PReLU | 3 conv 1x5 | 4 conv 5x1 (with
                  bias) | 5 BN | 6 PReLU | 7 conv3 | 8 BN | 9 dropout

BNs take eps 1e-3 and momentum 0.1, as the reference's
``BatchNorm2d(ch, 0.001, 0.1)``. The reference's dropout cancels torch's
``1 / (1 - p)`` rescaling (lib/enet.py:90-96): in eval mode the extension
branch is scaled by ``1 - p``; in train mode with a generator whole channels
are zeroed with probability ``p`` and the survivors are not rescaled; in
train mode without one the branch is scaled by ``1 - p``, as the JAX
package does without an rng.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spacap3d_tpu_torch.device import resolve_device

ENET_BN_EPS = 1e-3
ENET_BN_MOMENTUM = 0.1
NUM_CLASSES = 41
FEATURE_DIM = 128

# (name, kwargs) of each block of stages 2 and 3
STAGE2_3_PLAN = [
    ("b1", dict()),
    ("b2", dict(dilation=2)),
    ("b3", dict(asymmetric=True)),
    ("b4", dict(dilation=4)),
    ("b5", dict()),
    ("b6", dict(dilation=8)),
    ("b7", dict(asymmetric=True)),
    ("b8", dict(dilation=16)),
]

# the top-level index of each block, by the JAX package's block name
BLOCK_INDEX = {"s1_down": 4, "s2_down": 9, **{f"s1_b{i}": 5 + i for i in range(4)},
               **{f"s2_{n}": 10 + i for i, (n, _) in enumerate(STAGE2_3_PLAN)},
               **{f"s3_{n}": 18 + i for i, (n, _) in enumerate(STAGE2_3_PLAN)}}
CLASSIFIER_INDEX = 26

# The reference's create_enet_for_3d (lib/enet.py:697-715) freezes the body,
# keeps the last 8 bottlenecks (stage 3) trainable and splits off the
# classifier: the parameter-name prefixes of each part.
ENET_TRAINABLE_PREFIXES = tuple(f"{i}." for i in range(18, 26))
ENET_CLASSIFIER_KEY = f"{CLASSIFIER_INDEX}."


def _bn(ch: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=ENET_BN_EPS, momentum=ENET_BN_MOMENTUM)


class ExtDropout(nn.Module):
    """The reference's channel dropout without the survivors' rescaling."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training and gen is not None:
            keep = torch.rand(x.shape[:2] + (1, 1), generator=gen, device=x.device) >= self.p
            return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        return x * (1.0 - self.p)


class Bottleneck(nn.Sequential):
    """One ENet bottleneck: the extension branch (1x1 or 2x2/s2 projection to
    ``cout / 4``, a 3x3, dilated 3x3 or 1x5 + 5x1 conv, 1x1 expansion, BN
    after each, dropout) added to the main branch (identity, or a 2x2
    max-pool zero-padded to ``cout`` channels), then a PReLU."""

    def __init__(self, cin: int, cout: int, *, downsample: bool = False, dilation: int = 1,
                 asymmetric: bool = False, dropout_p: float = 0.1):
        internal = cout // 4
        if downsample:
            conv1 = nn.Conv2d(cin, internal, 2, stride=2, bias=False)
        else:
            conv1 = nn.Conv2d(cin, internal, 1, bias=False)
        if asymmetric:
            middle = [nn.Conv2d(internal, internal, (1, 5), padding=(0, 2), bias=False),
                      nn.Conv2d(internal, internal, (5, 1), padding=(2, 0), bias=True)]
        else:
            middle = [nn.Conv2d(internal, internal, 3, padding=dilation, dilation=dilation,
                                bias=True)]
        ext = nn.Sequential(conv1, _bn(internal), nn.PReLU(internal), *middle, _bn(internal),
                            nn.PReLU(internal), nn.Conv2d(internal, cout, 1, bias=False),
                            _bn(cout), ExtDropout(dropout_p))
        main = nn.MaxPool2d(2, 2) if downsample else nn.Identity()
        super().__init__(nn.ModuleList([ext, main]), nn.Identity(), nn.PReLU(cout))
        self.cout = cout

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        ext, main = self[0]
        h = x
        for layer in ext[:-1]:
            h = layer(h)
        h = ext[-1](h, gen)
        m = main(x)
        if m.shape[1] < self.cout:
            m = F.pad(m, (0, 0, 0, 0, 0, self.cout - m.shape[1]))
        return self[2](m + h)


class ENet(nn.Sequential):
    """The reference ENet's active modules: encoder and classifier (its
    decoder half is commented out upstream). ``forward(x, gen)`` maps frames
    (B, 3, H, W) to (features (B, 128, H/8, W/8), logits (B, num_classes,
    H/8, W/8)); ``encode`` stops at the features. ``classifier_bias`` adds a
    bias to the classifier, which the reference lacks: the JAX package's
    trees may carry one."""

    def __init__(self, num_classes: int = NUM_CLASSES, classifier_bias: bool = False):
        blocks = [Bottleneck(16, 64, downsample=True, dropout_p=0.01)]
        blocks += [Bottleneck(64, 64, dropout_p=0.01) for _ in range(4)]
        blocks += [Bottleneck(64, 128, downsample=True, dropout_p=0.1)]
        blocks += [Bottleneck(128, 128, dropout_p=0.1, **kw)
                   for _ in range(2) for _, kw in STAGE2_3_PLAN]
        super().__init__(
            nn.ModuleList([nn.Conv2d(3, 13, 3, stride=2, padding=1, bias=True),
                           nn.MaxPool2d(2, 2)]),
            nn.Identity(), _bn(16), nn.PReLU(16), *blocks,
            nn.ModuleList([nn.Conv2d(FEATURE_DIM, num_classes, 1, bias=classifier_bias)]))

    def encode(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        conv, pool = self[0]
        h = self[3](self[2](torch.cat([conv(x), pool(x)], dim=1)))
        for i in range(BLOCK_INDEX["s1_down"], CLASSIFIER_INDEX):
            h = self[i](h, gen)
        return h

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.encode(x, gen)
        return feats, self[CLASSIFIER_INDEX][0](feats)


def reset_parameters(model: ENet, seed: int) -> None:
    """Seeded initialisation in the JAX package's family: every conv's
    weight and bias uniform in +-1/sqrt(fan_in), in module order; BNs keep
    ones / zeros and mean 0, var 1; PReLUs 0.25."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                limit = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.copy_((torch.rand(m.weight.shape, generator=gen) * 2 - 1) * limit)
                if m.bias is not None:
                    m.bias.copy_((torch.rand(m.bias.shape, generator=gen) * 2 - 1) * limit)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)


def init_enet(num_classes: int = NUM_CLASSES, seed: int = 0, device="cuda") -> ENet:
    """An ENet with seeded random weights, in eval mode, on ``device``."""
    dev = resolve_device(device)
    model = ENet(num_classes)
    reset_parameters(model, seed)
    return model.eval().to(dev)


def enet_param_labels(model: nn.Module) -> Dict[str, str]:
    """'frozen' or 'trainable' for each parameter name, as the reference's
    fixed body, trainable stage-3 tail and classifier."""
    return {name: "trainable" if name.startswith(ENET_TRAINABLE_PREFIXES + (ENET_CLASSIFIER_KEY,))
            else "frozen" for name, _ in model.named_parameters()}

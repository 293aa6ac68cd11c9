"""Layers shared by the port's modules: dense (1x1 conv / linear over the
channel-last axis), eval-mode batch norm and the captioner's layer norm.

Parameters keep the reference PyTorch modules' shapes and names, so a
reference state dict loads by name: Linear weights are (out, in), Conv1d
(out, in, 1), Conv2d (out, in, 1, 1). The maths is channel-last, as in the
JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """x (..., in) @ weight(out, in, ...)^T + bias."""
    y = torch.matmul(x, weight.reshape(weight.shape[0], weight.shape[1]).t())
    if bias is not None:
        y = y + bias
    return y


class Dense(nn.Module):
    """A 1x1 convolution or linear layer over the channel-last axis.

    ``init`` names the JAX package's initialiser family: ``"kaiming"``
    (normal, std sqrt(2 / in)), ``"xavier"`` (uniform) or ``"torch"``
    (PyTorch's Linear default); biases take PyTorch's default."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 kernel_dims=(), init: str = "torch"):
        super().__init__()
        self.in_dim, self.out_dim, self.init = in_dim, out_dim, init
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, *kernel_dims))
        if bias:
            self.bias = nn.Parameter(torch.empty(out_dim))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        shape = self.weight.shape
        with torch.no_grad():
            if self.init == "kaiming":
                w = torch.randn(shape, generator=gen) * math.sqrt(2.0 / self.in_dim)
            else:
                limit = (math.sqrt(6.0 / (self.in_dim + self.out_dim))
                         if self.init == "xavier" else 1.0 / math.sqrt(self.in_dim))
                w = (torch.rand(shape, generator=gen) * 2 - 1) * limit
            self.weight.copy_(w)
            if self.bias is not None:
                limit = 1.0 / math.sqrt(self.in_dim)
                self.bias.copy_((torch.rand(self.out_dim, generator=gen) * 2 - 1) * limit)

    def matrix(self) -> torch.Tensor:
        """The weight as an (out, in) matrix."""
        return self.weight.reshape(self.out_dim, self.in_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class BatchNorm(nn.BatchNorm1d):
    """Eval-mode batch norm over the channel-last axis:
    ``(x - mean) * rsqrt(var + eps) * weight + bias``. The parameters and
    buffers are ``nn.BatchNorm1d``'s, so reference checkpoints load by name.
    Train-mode statistics belong to the training slice and are refused."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("train-mode batch norm is not ported; call .eval()")
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


def ref_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """scale * (x - mean) / (std + eps) + bias with the unbiased std."""
    d = x.shape[-1]
    mean = x.mean(-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).sum(-1, keepdim=True) / max(d - 1, 1)
    return scale * centered / (torch.sqrt(var) + eps) + bias


class RefLayerNorm(nn.Module):
    """The reference captioner's LayerNorm (parameters ``a_2``, ``b_2``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(dim))
        self.b_2 = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ref_layer_norm(x, self.a_2, self.b_2)


def reset_parameters(module: nn.Module, seed: int) -> None:
    """Seeded initialisation of every ``Dense`` and embedding in ``module``,
    in module order; norms keep ones / zeros and BN stats mean 0, var 1."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, Dense):
            m.reset_parameters(gen)
        elif isinstance(m, nn.Embedding):
            n, d = m.weight.shape
            limit = math.sqrt(6.0 / (n + d))
            with torch.no_grad():
                m.weight.copy_((torch.rand((n, d), generator=gen) * 2 - 1) * limit)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()

"""Layers shared by the port's modules: dense (1x1 conv / linear over the
channel-last axis), batch norm, dropout and the captioner's layer norm.

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


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode batch norm over all leading axes, as the JAX package's
    ``_bn_train``: a two-pass mean and biased variance, ``rsqrt(var +
    eps)``, and the hand-written backward (one reduction pass over (dy,
    xhat), one elementwise pass for dx). Returns (y, mean, var); the
    statistics carry no gradient (they feed only the running stats)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.square(x - mean).mean(axes)
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return (x - mean) * rstd * weight + bias, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        axes = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        xhat = (x - mean) * rstd
        dbias = dy.sum(axes)
        dweight = (dy * xhat).sum(axes)
        dx = (rstd * weight) * (dy - dbias / n - xhat * (dweight / n))
        return dx, dweight, dbias, None


class BatchNorm(nn.BatchNorm1d):
    """Batch norm over the channel-last axis. The parameters and buffers are
    ``nn.BatchNorm1d``'s, so reference checkpoints load by name.

    Eval: ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias``.
    Train: the batch statistics (``_BatchNormTrain``), and the running
    stats move as the JAX package's ``batch_norm`` moves them, with the
    unbiased variance ``var * n / (n - 1)`` and ``running = (1 - m) *
    running + m * batch`` at the ``momentum`` the caller passes (the train
    step's, which a solver schedules); train mode without one raises. The
    module's own ``momentum`` attribute is not read. ``F.batch_norm`` is
    not used: cuDNN's statistics are not the JAX forward's."""

    def forward(self, x: torch.Tensor, momentum: Optional[float] = None) -> torch.Tensor:
        if self.training:
            if momentum is None:
                raise ValueError("train-mode batch norm needs the momentum of the step")
            y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps)
            n = x.numel() // x.shape[-1]
            m = momentum
            with torch.no_grad():
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * (var * (n / max(n - 1, 1))))
            return y
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


def run_layers(layers: nn.Sequential, x: torch.Tensor,
               momentum: Optional[float] = None) -> torch.Tensor:
    """``layers(x)``, with ``momentum`` passed to each batch norm."""
    for layer in layers:
        x = layer(x, momentum) if isinstance(layer, BatchNorm) else layer(x)
    return x


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``gen``; the identity when
    ``rate`` is 0 or there is no generator (as the JAX package's ``dropout``
    without a key)."""
    if rate == 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=gen)
    return torch.where(mask.bool(), x / keep, 0.0)


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

"""Layers shared by the port's modules: dense (1x1 conv / linear over the
channel-last axis), batch norm, dropout and the captioner's layer norm.

Two of them take part in the parallel runtimes (``parallel/``): a train-mode
``BatchNorm`` whose ``group`` is set takes its statistics over the rows of
every rank of that process group, and a ``Dense`` whose ``tp`` is set is a
column- or row-parallel slice of a tensor-parallel layer.

Parameters keep the reference PyTorch modules' shapes and names, so a
reference state dict loads by name: Linear weights are (out, in), Conv1d
(out, in, 1), Conv2d (out, in, 1, 1). The maths is channel-last, as in the
JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.distributed as dist
from torch import nn


# a train step's BN momentum: a Python float, or a 0-dim f32 tensor on the
# model's device that the step fills each call (a captured step reads it
# where it lies, as the JAX step takes ``bn_momentum`` as a traced argument)
Momentum = Union[float, torch.Tensor]


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

    # tensor parallelism (parallel/tp.py::shard_model): None, or ("column",
    # group) / ("row", group) for a slice of the output / input dimension
    tp = None

    def matrix(self) -> torch.Tensor:
        """The weight (this rank's slice under TP) as an (out, in) matrix."""
        return self.weight.reshape(self.weight.shape[0], self.weight.shape[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return dense(x, self.weight, self.bias)
        kind, group = self.tp
        if kind == "column":
            return dense(copy_to_group(x, group), self.weight, self.bias)
        y = reduce_from_group(dense(x, self.weight), group)
        return y if self.bias is None else y + self.bias


def active_group(group) -> Optional["dist.ProcessGroup"]:
    """``group`` if it spans more than one rank, else None: over a group of
    one the layers run their single-process arithmetic."""
    if group is None or dist.get_world_size(group) == 1:
        return None
    return group


class _CopyToGroup(torch.autograd.Function):
    """Megatron's *f*: the identity forward, an all-reduce of the gradient
    (each rank's slice of a column-parallel layer contributes to it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's *g*: an all-reduce forward (the partial products of a
    row-parallel layer), the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromGroup(torch.autograd.Function):
    """Concatenates the ranks' equal slices along ``dim`` (one all-gather);
    the backward takes this rank's slice of the gradient, which every rank
    computes alike downstream of the gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        ctx.dim, ctx.start, ctx.n = dim, rank * x.shape[dim], x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.start, ctx.n), None, None


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFromGroup.apply(x, group, dim)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode batch norm over all leading axes, as the JAX package's
    ``_bn_train``: a two-pass mean and biased variance, ``rsqrt(var +
    eps)``, and the hand-written backward (one reduction pass over (dy,
    xhat), one elementwise pass for dx). Returns (y, mean, var); the
    statistics carry no gradient (they feed only the running stats).

    With a ``group`` (ranks holding equal row counts, as ``shard_batch``
    gives them) the statistics are those of the rows of every rank, as
    the JAX package's step takes them over a mesh-sharded batch: the
    per-channel sums are all-reduced for the mean, then the sums of
    squared deviations from that mean for the variance (the same two
    passes). The backward all-reduces ``dbias`` and ``dweight`` before it
    forms ``dx`` over the global row count, and returns this rank's own
    ``dbias`` and ``dweight`` as the parameters' gradients: the train step
    sums those over the ranks."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group=None):
        axes = tuple(range(x.dim() - 1))
        if group is None:
            n = x.numel() // x.shape[-1]
            mean = x.mean(axes)
            var = torch.square(x - mean).mean(axes)
        else:
            n = x.numel() // x.shape[-1] * dist.get_world_size(group)
            total = x.sum(axes)
            dist.all_reduce(total, group=group)
            mean = total / n
            sq = torch.square(x - mean).sum(axes)
            dist.all_reduce(sq, group=group)
            var = sq / n
        rstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return (x - mean) * rstd * weight + bias, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, rstd = ctx.saved_tensors
        axes = tuple(range(x.dim() - 1))
        n = ctx.n
        xhat = (x - mean) * rstd
        dbias = dy.sum(axes)
        dweight = (dy * xhat).sum(axes)
        gbias, gweight = dbias, dweight
        if ctx.group is not None:
            both = torch.cat([dbias, dweight])
            dist.all_reduce(both, group=ctx.group)
            gbias, gweight = both.chunk(2)
        dx = (rstd * weight) * (dy - gbias / n - xhat * (gweight / n))
        return dx, dweight, dbias, None, None


class BatchNorm(nn.BatchNorm1d):
    """Batch norm over the channel-last axis. The parameters and buffers are
    ``nn.BatchNorm1d``'s, so reference checkpoints load by name.

    Eval: ``(x - running_mean) * rsqrt(running_var + eps) * weight + bias``.
    Train: the batch statistics (``_BatchNormTrain``), and the running
    stats move as the JAX package's ``batch_norm`` moves them, with the
    unbiased variance ``var * n / (n - 1)`` and ``running = (1 - m) *
    running + m * batch`` at the ``momentum`` the caller passes (the train
    step's, which a solver schedules; a ``Momentum``: with a 0-dim f32
    tensor ``1 - m`` is taken on the device in f32, as the JAX step takes
    it); train mode without one raises. The
    module's own ``momentum`` attribute is not read. ``F.batch_norm`` is
    not used: cuDNN's statistics are not the JAX forward's. With ``group``
    set (``set_batch_norm_group``; a group of more than one rank) train
    mode takes the statistics over every rank's rows, so the running stats
    move identically on every rank."""

    group = None

    def forward(self, x: torch.Tensor, momentum: Optional[Momentum] = None) -> torch.Tensor:
        if self.training:
            if momentum is None:
                raise ValueError("train-mode batch norm needs the momentum of the step")
            group = active_group(self.group)
            y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps, group)
            n = x.numel() // x.shape[-1] * (1 if group is None else dist.get_world_size(group))
            m = momentum
            with torch.no_grad():
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * (var * (n / max(n - 1, 1))))
            return y
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


def set_batch_norm_group(model: nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``model`` takes its train-mode statistics
    over ``group`` (None: this rank's rows only)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def run_layers(layers: nn.Sequential, x: torch.Tensor,
               momentum: Optional[Momentum] = None) -> torch.Tensor:
    """``layers(x)``, with ``momentum`` passed to each batch norm."""
    for layer in layers:
        x = layer(x, momentum) if isinstance(layer, BatchNorm) else layer(x)
    return x


class SplitGenerators(NamedTuple):
    """The dropout generators of a tensor-parallel rank, as Megatron's
    model-parallel RNG tracker keeps them: ``whole`` draws the masks of
    tensors that every rank of the model group holds alike (the same masks
    on each rank), ``local`` those of the rank's own attention heads and
    FFN columns, its seed folding in the model rank, so that no two
    slices of one tensor share a mask."""
    whole: torch.Generator
    local: torch.Generator


def split_generators(gen: torch.Generator, model_rank: int) -> SplitGenerators:
    """``gen`` for the whole tensors, and a generator for this model rank's
    slices seeded from ``gen``'s seed and ``model_rank``."""
    local = torch.Generator(device=gen.device)
    local.manual_seed((gen.initial_seed() * 1_000_003 + 7919 * (model_rank + 1)) % (2 ** 63))
    return SplitGenerators(gen, local)


def dropout(x: torch.Tensor, rate: float, gen, local: bool = False) -> torch.Tensor:
    """Inverted dropout with masks drawn from ``gen`` (a ``torch.Generator``,
    or ``SplitGenerators`` under tensor parallelism, of which ``local``
    picks the generator of the rank's slices); the identity when ``rate``
    is 0 or there is no generator (as the JAX package's ``dropout`` without
    a key)."""
    if rate == 0.0 or gen is None:
        return x
    if isinstance(gen, SplitGenerators):
        gen = gen.local if local else gen.whole
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

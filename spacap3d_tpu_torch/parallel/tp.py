"""Tensor parallelism (TP) of the captioner, as the JAX package's
``parallel/tp.py``: Megatron's column / row split over a ``model`` group.

Layout, by the port's state-dict names:

* each attention's q/k/v projections (``linears.0-2``) are split by
  output rows, so a rank holds ``num_heads / tp`` whole heads, and their
  biases with them (column-parallel);
* the attention's output projection (``linears.3``) is split by input
  columns (row-parallel), its bias whole;
* the FFN's ``w_1`` is column-parallel, its ``w_2`` row-parallel;
* everything else is whole on every rank: the detector trunk, the
  embeddings, the generator, the relation head and the layer norms. Their
  gradients are averaged over the model group after each backward
  (``average_replicated_gradients``), so that the copies stay equal.

A column-parallel layer copies its input into the model group (Megatron's
*f*: identity forward, gradient all-reduce) and a row-parallel one sums
its partial products over it (*g*: all-reduce forward, identity
backward), adding its bias once, after the sum. Each block then pays one
all-reduce for its attention and one for its FFN. The relation head and
the attention dump read every head, so the captioner gathers the heads'
probabilities and values first; the greedy decode sizes its KV caches for
the rank's heads. Dropout on the rank's heads and FFN columns draws from a
generator that folds in the model rank (``models/core.py::
split_generators``), and on whole tensors from the step's generator, alike
on every rank of the group. A fused decode (``eval_decode_fused``) runs
each FFN's kernel on the rank's d_ff slice in its partial-sum mode
(``ops.ffn_partial``), then the FFN's one all-reduce, b2 and the rounding,
as the unfused decode; the generator's argmax kernel runs on the whole
hidden state and the whole generator on every rank.

Groups. ``make_tp_mesh(tp)`` splits a world of ``d * tp`` ranks as the
JAX package's ``(data, model)`` mesh does, ``tp`` on the inner axis: ranks
``k*tp ... k*tp + tp - 1`` form a model group and hold the same rows of
the batch; ranks with one model index form a data group, over which batch
norm, the losses and the gradients reduce. JAX runs TP in one process
over its devices; torch has no one-process multi-device mesh, so here TP
needs a process group: training with ``--tp k`` on ``d * k`` ranks, and
evaluation on exactly ``k`` (its grid then is not seed-sharded).

State dicts. ``gather_state_dict`` assembles whole tensors (checkpoints
hold them, as the JAX package's numpy snapshots do), ``shard_state_dict``
cuts them again; the optimizer's moments follow
(``gather_optimizer_state`` / ``shard_optimizer_state``).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from spacap3d_tpu_torch.models.core import Dense, gather_from_group
from spacap3d_tpu_torch.models.captioner import Captioner, MultiHeadedAttention

_ATTN = re.compile(r"^caption\.model\.(encoder|decoder)\.layers\.\d+\.(self_attn|src_attn)"
                   r"\.linears\.(\d)\.(weight|bias)$")
_FFN = re.compile(r"^caption\.model\.(encoder|decoder)\.layers\.\d+\.feed_forward"
                  r"\.(w_1|w_2)\.(weight|bias)$")


@dataclasses.dataclass
class TPMesh:
    """This rank's place in a (data, model) split of the world."""
    tp: int
    model: "dist.ProcessGroup"
    data: "dist.ProcessGroup"
    model_rank: int
    data_rank: int
    data_size: int


def make_tp_mesh(tp: int = 2) -> TPMesh:
    """Splits the process group's ``d * tp`` ranks into model groups of
    ``tp`` consecutive ranks and data groups of ranks ``j, j + tp, ...``.
    Every rank must call it (group creation is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("tensor parallelism needs a process group of d * tp ranks "
                           "(multihost.initialize_from_env)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if tp < 1 or world % tp:
        raise ValueError(f"{world} ranks not divisible by tp={tp}")
    model = data = None
    for k in range(world // tp):
        g = dist.new_group(list(range(k * tp, (k + 1) * tp)))
        if rank // tp == k:
            model = g
    for j in range(tp):
        g = dist.new_group(list(range(j, world, tp)))
        if rank % tp == j:
            data = g
    return TPMesh(tp, model, data, rank % tp, rank // tp, world // tp)


def tp_degree(mesh: Optional[TPMesh]) -> int:
    return 1 if mesh is None else mesh.tp


def tp_param_specs(shapes: Mapping[str, torch.Size], tp: int) -> Dict[str, Optional[int]]:
    """The dimension each state-dict entry splits over the model group (0:
    column-parallel, the output rows; 1: row-parallel, the input columns),
    or None for an entry every rank holds whole. ``shapes`` maps names to
    shapes (a state dict will do). Raises when ``tp`` does not divide a
    dimension the layout splits: a silently replicated "TP" run would burn
    ``tp`` times the work."""
    specs = {}
    for name, t in shapes.items():
        shape = tuple(getattr(t, "shape", t))
        m, f = _ATTN.match(name), _FFN.match(name)
        if m:
            col, kind = m.group(3) in "012", m.group(4)
            dim = 0 if col else (1 if kind == "weight" else None)
        elif f:
            dim = 0 if f.group(2) == "w_1" else (1 if f.group(3) == "weight" else None)
        else:
            dim = None
        if dim is not None and shape[dim] % tp:
            raise ValueError(f"TP: {name} dim {shape[dim]} not divisible by tp={tp}")
        specs[name] = dim
    return specs


def count_sharded(model: nn.Module) -> int:
    """Parameters of ``model`` that are tensor-parallel slices."""
    specs = getattr(model, "tp_specs", {})
    return sum(specs.get(n) is not None for n, _ in model.named_parameters())


def _slice(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).clone()


def shard_model(model: nn.Module, mesh: TPMesh) -> nn.Module:
    """Cuts ``model``'s captioner to this rank's slices in place (its
    parameters must be whole and equal on the model group's ranks) and
    wires the column / row layers and heads to ``mesh.model``. Build the
    optimizer after this. Returns ``model``."""
    if getattr(model, "tp_specs", None) is not None:
        raise ValueError("the model is already sharded")
    caption = getattr(model, "caption", None)
    if not isinstance(caption, Captioner):
        raise ValueError("tensor parallelism splits the captioner; this model has none")
    tp, rank = mesh.tp, mesh.model_rank
    if model.cfg.num_heads % tp:
        raise ValueError(f"TP: {model.cfg.num_heads} heads not divisible by tp={tp}")
    specs = tp_param_specs(model.state_dict(), tp)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, Dense):
                dim = specs.get(f"{name}.weight")
                if dim is None:
                    continue
                mod.weight = nn.Parameter(_slice(mod.weight, dim, rank, tp))
                if dim == 0 and mod.bias is not None:
                    mod.bias = nn.Parameter(_slice(mod.bias, 0, rank, tp))
                mod.tp = ("column" if dim == 0 else "row", mesh.model)
            elif isinstance(mod, MultiHeadedAttention):
                mod.h //= tp
    caption.tp_group, caption.tp_rank = mesh.model, mesh.model_rank
    model.tp_specs, model.tp_mesh = specs, mesh
    return model


def average_replicated_gradients(model: nn.Module, mesh: TPMesh) -> None:
    """Averages over the model group the gradients of the parameters that
    each of its ranks holds whole, in one all-reduce. The ranks compute
    them alike, but a CUDA backward sums with atomics, so their last bits
    differ, and the whole copies would drift apart step by step."""
    specs = model.tp_specs
    grads = [p.grad for n, p in model.named_parameters()
             if p.grad is not None and specs.get(n) is None]
    if mesh.tp == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.model)
    flat /= mesh.tp
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def shard_state_dict(state: Mapping[str, torch.Tensor], mesh: TPMesh,
                     specs: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """Whole tensors -> this rank's slices (``specs`` from the sharded
    model's ``tp_specs``)."""
    return {k: v if specs.get(k) is None else _slice(v, specs[k], mesh.model_rank, mesh.tp)
            for k, v in state.items()}


def gather_state_dict(state: Mapping[str, torch.Tensor], mesh: TPMesh,
                      specs: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """This rank's slices -> whole tensors, equal on every rank of the model
    group (a collective: every rank of the group must call it)."""
    with torch.no_grad():
        return {k: v if specs.get(k) is None else gather_from_group(v, mesh.model, specs[k])
                for k, v in state.items()}


def _optimizer_names(optimizer: torch.optim.Optimizer, model: nn.Module):
    """The parameter name behind each index of ``optimizer.state_dict()``."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_moments(osd: Dict, names, fn) -> Dict:
    state = {}
    for i, s in osd["state"].items():
        name = names[int(i)]
        state[i] = {k: fn(v, name) if isinstance(v, torch.Tensor) and v.dim() > 0 else v
                    for k, v in s.items()}
    return {**osd, "state": state}


def gather_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                           mesh: TPMesh) -> Dict:
    """The optimizer's state dict with whole moments (a collective)."""
    specs = model.tp_specs
    with torch.no_grad():
        return _map_moments(optimizer.state_dict(), _optimizer_names(optimizer, model),
                            lambda v, n: v if specs.get(n) is None else
                            gather_from_group(v, mesh.model, specs[n]))


def shard_optimizer_state(osd: Dict, optimizer: torch.optim.Optimizer, model: nn.Module,
                          mesh: TPMesh) -> Dict:
    """A state dict with whole moments -> this rank's slices of them."""
    specs = model.tp_specs
    return _map_moments(osd, _optimizer_names(optimizer, model),
                        lambda v, n: v if specs.get(n) is None else
                        _slice(v, specs[n], mesh.model_rank, mesh.tp))

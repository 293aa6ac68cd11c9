"""Weights across: JAX pytrees <-> the port's state dict.

The port's module tree carries the reference PyTorch state-dict names, so
``params_from_jax`` is the inverse of the JAX package's reference-key map
(``spacap3d_tpu/utils/convert.py::_map_key``):

  * Dense kernels (in, out) -> Linear (out, in), Conv1d (out, in, 1) or
    Conv2d (out, in, 1, 1) weights;
  * BatchNorm scale/bias (params) and mean/var (state) -> weight, bias,
    running_mean, running_var (+ num_batches_tracked = 0);
  * LayerNorm scale/bias -> a_2 / b_2; the embedding table is unchanged;
  * the captioner's BN state sits at ``state['caption']['src_embed']``
    (no ``model`` level), as in the JAX package.

``adam_moments_from_jax`` maps the JAX package's Adam state to the port's
parameter names, and ``payload_from_jax`` a whole JAX checkpoint
(``utils/jax_checkpoint.py``) to the port's checkpoint payload.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from spacap3d_tpu_torch.utils.jax_checkpoint import records, scalar


def params_from_jax(params: Mapping, state: Mapping) -> Dict[str, torch.Tensor]:
    """JAX (params, state) pytrees of numpy arrays -> the port's state dict."""
    sd: Dict[str, np.ndarray] = {}

    def dense(key, p, ndim):
        w = np.asarray(p["kernel"], np.float32).T
        sd[f"{key}.weight"] = w.reshape(w.shape + (1,) * (ndim - 2))
        if "bias" in p:
            sd[f"{key}.bias"] = p["bias"]

    def bn(key, p, s):
        sd.update({f"{key}.weight": p["scale"], f"{key}.bias": p["bias"],
                   f"{key}.running_mean": s["mean"], f"{key}.running_var": s["var"],
                   f"{key}.num_batches_tracked": np.zeros((), np.int64)})

    def ln(key, p):
        sd[f"{key}.a_2"], sd[f"{key}.b_2"] = p["scale"], p["bias"]

    def shared_mlp(key, p, s):
        for name in p:
            dense(f"{key}.{name}.conv", p[name]["conv"], 4)
            bn(f"{key}.{name}.bn.bn", p[name]["bn"], s[name]["bn"])

    bb, bbs = params["backbone_net"], state["backbone_net"]
    for i in range(1, 5):
        shared_mlp(f"backbone_net.sa{i}.mlp_module", bb[f"sa{i}"]["mlp_module"],
                   bbs[f"sa{i}"]["mlp_module"])
    for i in (1, 2):
        shared_mlp(f"backbone_net.fp{i}.mlp", bb[f"fp{i}"]["mlp"], bbs[f"fp{i}"]["mlp"])

    vg, vgs = params["vgen"], state["vgen"]
    for i in (1, 2, 3):
        dense(f"vgen.conv{i}", vg[f"conv{i}"], 3)
    for i in (1, 2):
        bn(f"vgen.bn{i}", vg[f"bn{i}"], vgs[f"bn{i}"])

    pr, prs = params["proposal"], state["proposal"]
    shared_mlp("proposal.vote_aggregation.mlp_module",
               pr["vote_aggregation"]["mlp_module"], prs["vote_aggregation"]["mlp_module"])
    for idx, name in (("0", "conv0"), ("3", "conv1"), ("6", "conv2")):
        dense(f"proposal.proposal.{idx}", pr[name], 3)
    for idx, name in (("1", "bn0"), ("4", "bn1")):
        bn(f"proposal.proposal.{idx}", pr[name], prs[name])

    if "caption" in params:
        cap = params["caption"]
        model = cap["model"]
        for stack in ("encoder", "decoder"):
            if stack not in model:
                continue
            for li, layer in enumerate(model[stack]["layers"]):
                base = f"caption.model.{stack}.layers.{li}"
                for attn in ("self_attn", "src_attn"):
                    if attn in layer:
                        for i in range(4):
                            dense(f"{base}.{attn}.linears.{i}", layer[attn][f"linears{i}"], 2)
                for w in ("w_1", "w_2"):
                    dense(f"{base}.feed_forward.{w}", layer["feed_forward"][w], 2)
                for name, sub in layer.items():
                    if name.startswith("sublayer"):
                        ln(f"{base}.sublayer.{name[len('sublayer'):]}.norm", sub["norm"])
            ln(f"caption.model.{stack}.norm", model[stack]["norm"])
        if "src_embed" in model:
            se, base = model["src_embed"], "caption.model.src_embed.position_embedding_head"
            dense(f"{base}.0", se["conv0"], 3)
            bn(f"{base}.1", se["bn"], state["caption"]["src_embed"]["bn"])
            dense(f"{base}.3", se["conv1"], 3)
        sd["caption.model.tgt_embed.0.lut.weight"] = model["tgt_embed"]["lut"]["kernel"]
        dense("caption.model.generator.proj", model["generator"]["proj"], 2)
        if "relation_proposal" in cap:
            for idx, name in (("0", "l0"), ("2", "l2"), ("4", "l4")):
                dense(f"caption.relation_proposal.{idx}", cap["relation_proposal"][name], 2)

    return {k: torch.as_tensor(np.array(v, dtype=np.int64 if k.endswith(
        "num_batches_tracked") else np.float32)) for k, v in sd.items()}


def jax_leaves(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) of a tree of dicts, lists and arrays in the order of
    ``jax.tree_util.tree_flatten``: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in jax_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in jax_leaves(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def param_label(top_key: str, no_detection: bool) -> str:
    """The JAX package's optimizer group of a parameter under ``params[top_key]``
    (``spacap3d_tpu/train/step.py::_param_labels``): the captioner's
    ``caption``; the rest ``base``, or ``frozen`` under ``no_detection``;
    ``mean_size_arr`` ``frozen``."""
    if top_key == "mean_size_arr":
        return "frozen"
    if top_key == "caption":
        return "caption"
    return "frozen" if no_detection else "base"


def _with_leaves(tree, leaves: Dict[Tuple, Any], path: Tuple = ()):
    """``tree`` with the leaf at each path of ``leaves`` put in its place
    and zeros at the others."""
    if isinstance(tree, dict):
        return {k: _with_leaves(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_leaves(v, leaves, path + (i,)) for i, v in enumerate(tree)]
    return leaves.get(path, np.zeros_like(np.asarray(tree)))


def adam_moments_from_jax(params: Mapping, state: Mapping, opt_state: Any,
                          no_detection: bool):
    """The JAX package's Adam moments as port state-dict entries.

    The JAX optimizer (``spacap3d_tpu/train/step.py::_flat_group_tx``) runs
    each group's chain (weight decay, ``scale_by_adam``, the rate) on one
    flat vector per group and dtype, keyed ``"{label}/{dtype}"``: the
    group's leaves of ``params`` in tree order, concatenated. Each group's
    ``ScaleByAdamState`` holds ``count`` and its ``mu`` / ``nu`` vectors.
    Returns ``(exp_avg, exp_avg_sq, count)``: two dicts by port parameter
    name and the update count."""
    leaves = jax_leaves(params)
    groups: Dict[str, List[int]] = {}
    for i, (path, leaf) in enumerate(leaves):
        label = param_label(path[0], no_detection)
        if label != "frozen":
            groups.setdefault(f"{label}/{np.asarray(leaf).dtype.name}", []).append(i)
    flat: Dict[str, Dict[str, np.ndarray]] = {"mu": {}, "nu": {}}
    counts = set()
    for adam in records(opt_state, "ScaleByAdamState"):
        count, mu, nu = adam[0], adam[1], adam[2]
        for g in groups:
            if isinstance(mu.get(g), np.ndarray):
                flat["mu"][g], flat["nu"][g] = mu[g], nu[g]
                counts.add(scalar(count))
    if set(flat["mu"]) != set(groups) or len(counts) != 1:
        raise ValueError(f"the optimizer state holds Adam moments for {sorted(flat['mu'])} "
                         f"with counts {sorted(counts)}; the parameters' groups are "
                         f"{sorted(groups)}")
    out = []
    for moment in ("mu", "nu"):
        split = {}
        for g, idx in groups.items():
            vec, off = flat[moment][g], 0
            for i in idx:
                path, leaf = leaves[i]
                size = int(np.prod(np.shape(leaf)))
                split[path] = vec[off:off + size].reshape(np.shape(leaf))
                off += size
            if off != vec.size:
                raise ValueError(f"group {g}: {vec.size} moments for {off} parameters")
        out.append(params_from_jax(_with_leaves(params, split), state))
    return out[0], out[1], counts.pop()


def payload_from_jax(payload: Mapping, model: nn.Module,
                     optimizer: Optional[torch.optim.Optimizer] = None, scheduler=None,
                     no_detection: bool = False) -> Dict:
    """A JAX-package checkpoint (``utils/jax_checkpoint.py::load_jax_checkpoint``)
    as the port's payload: ``model_state_dict`` and, with an optimizer,
    ``optimizer_state_dict`` (each parameter's ``exp_avg``, ``exp_avg_sq``
    and ``step``), ``scheduler_state_dict`` (a MultiStepLR moved to the
    checkpoint's update count), ``epoch``, ``iter`` and ``best`` as Python
    numbers."""
    out = {"model_state_dict": params_from_jax(payload["params"], payload["state"])}
    if optimizer is None:
        return out
    exp_avg, exp_avg_sq, count = adam_moments_from_jax(
        payload["params"], payload["state"], payload["opt_state"], no_detection)
    # whole tensors in the optimizer's own index order (a TP restore slices
    # them afterwards)
    names = {id(p): n for n, p in model.named_parameters()}
    opt_sd = optimizer.state_dict()
    index = [i for g in opt_sd["param_groups"] for i in g["params"]]
    opt_sd["state"] = {i: {"step": torch.tensor(float(count)),
                           "exp_avg": exp_avg[names[id(p)]],
                           "exp_avg_sq": exp_avg_sq[names[id(p)]]}
                       for i, p in zip(index, (p for g in optimizer.param_groups
                                               for p in g["params"]))}
    step = int(scalar(payload["step"]))
    sched_sd = None
    if scheduler is not None:
        sched_sd = scheduler.state_dict()
        decays = sum(1 for m in sched_sd["milestones"].elements() if m <= step)
        lrs = [g["initial_lr"] * sched_sd["gamma"] ** decays for g in opt_sd["param_groups"]]
        for g, lr in zip(opt_sd["param_groups"], lrs):
            g["lr"] = lr
        sched_sd.update(last_epoch=step, _step_count=step + 1, _last_lr=lrs)
    out.update(optimizer_state_dict=opt_sd, scheduler_state_dict=sched_sd,
               epoch=int(scalar(payload["epoch"])), iter=int(scalar(payload["iter"])),
               best={k: scalar(v) for k, v in payload["best"].items()})
    return out


# keys of a reference checkpoint that the port has no module for: the
# sinusoidal PE buffers (recomputed) and the cross-attention weights the
# reference allocates but never runs in early-guide decoder layers
_UNUSED_EARLY_GUIDE = re.compile(
    r"caption\.model\.decoder\.layers\.\d+\.(src_attn\.|sublayer\.1\.)")


def load_reference_state_dict(model: nn.Module, sd: Mapping[str, torch.Tensor],
                              strict: bool = True) -> int:
    """Loads a reference checkpoint's state dict by name, after dropping the
    keys listed above; returns the number of tensors loaded. ``strict=False``
    loads a part of the model (a detector-only checkpoint) but still raises
    on a key the model lacks."""
    early = getattr(model.cfg, "early_guide", True)
    keep = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    keep = {k: v for k, v in keep.items()
            if not k.endswith(".pe") and not (early and _UNUSED_EARLY_GUIDE.match(k))}
    unexpected = model.load_state_dict(keep, strict=strict).unexpected_keys
    if unexpected:
        raise KeyError(f"keys the model lacks: {unexpected[:5]}")
    return len(keep)

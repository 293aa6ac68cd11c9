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
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


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

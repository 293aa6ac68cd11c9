"""ENet weights into the port: the reference checkpoint's keys, and the JAX
package's ENet trees (``spacap3d_tpu/models/enet.py``'s named params and
state) mapped onto them.

The port's ``models/enet.py::ENet`` carries the reference keys, so a
``scannetv2_enet.pth`` loads as it is. A JAX tree maps by the inverse of the
JAX package's ``utils/convert_enet.py::_map_enet_key``: conv kernels
(kh, kw, in, out) -> (out, in, kh, kw), PReLU alpha -> weight, BN
scale / bias (params) and mean / var (state) -> weight, bias, running_mean,
running_var. ``num_batches_tracked`` is left to torch's BN loader, which
sets it to 0 where a state dict lacks it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from spacap3d_tpu_torch.device import resolve_device
from spacap3d_tpu_torch.models.enet import (BLOCK_INDEX, CLASSIFIER_INDEX, STAGE2_3_PLAN, ENet,
                                            init_enet)
from spacap3d_tpu_torch.utils.jax_checkpoint import load_jax_pickle

_BLOCK_OF_INDEX = {i: name for name, i in BLOCK_INDEX.items()}
_ASYM_BLOCKS = {f"{stage}_{name}" for stage in ("s2", "s3")
                for name, kw in STAGE2_3_PLAN if kw.get("asymmetric")}
# the extension branch's sub-index ("X.0.0.<i>") -> the JAX leaf group
_SUB_REGULAR = ("conv1", "conv1_bn", "prelu1", "conv2", "conv2_bn", "prelu2", "conv3",
                "conv3_bn")
_SUB_ASYM = ("conv1", "conv1_bn", "prelu1", "conv2a", "conv2b", "conv2_bn", "prelu2", "conv3",
             "conv3_bn")
_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("state", "mean"), "running_var": ("state", "var")}


def _jax_path(key: str) -> Tuple[str, Tuple[str, ...]]:
    """A reference key -> ('params' or 'state', the JAX tree path)."""
    parts = key.split(".")
    leaf, top = parts[-1], int(parts[0])

    def bn(group):
        which, name = _BN_LEAF[leaf]
        return which, group + (name,)

    def conv(group):
        return "params", group + ("kernel" if leaf == "weight" else "bias",)

    if top == 0:
        return conv(("initial_conv",))
    if top == 2:
        return bn(("initial_bn",))
    if top == 3:
        return "params", ("initial_prelu", "alpha")
    if top == CLASSIFIER_INDEX:
        return conv(("classifier",))
    block = _BLOCK_OF_INDEX[top]
    if parts[1] == "2":
        return "params", (block, "prelu_out", "alpha")
    name = (_SUB_ASYM if block in _ASYM_BLOCKS else _SUB_REGULAR)[int(parts[3])]
    if name.endswith("_bn"):
        return bn((block, name))
    if name.startswith("prelu"):
        return "params", (block, name, "alpha")
    return conv((block, name))


def enet_params_from_jax(params: Mapping, state: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ENet (params, state) trees of numpy arrays -> the port's state dict
    (reference keys). A classifier bias in ``params`` becomes ``26.0.bias``."""
    cls = params["classifier"]
    keys = ENet(np.shape(cls["kernel"])[-1], classifier_bias="bias" in cls).state_dict()
    trees = {"params": params, "state": state}
    sd = {}
    for key in keys:
        if key.endswith("num_batches_tracked"):
            continue
        which, path = _jax_path(key)
        node = trees[which]
        for p in path:
            node = node[p]
        v = np.asarray(node, np.float32)
        if path[-1] == "kernel":
            v = v.transpose(3, 2, 0, 1)
        sd[key] = torch.tensor(np.ascontiguousarray(v))
    return sd


def enet_from_state_dict(sd: Mapping[str, torch.Tensor], device="cuda") -> ENet:
    """An ENet sized by ``sd`` (classes, classifier bias) with ``sd`` loaded
    strictly, in eval mode, on ``device``."""
    dev = resolve_device(device)
    w = sd[f"{CLASSIFIER_INDEX}.0.weight"]
    model = ENet(w.shape[0], classifier_bias=f"{CLASSIFIER_INDEX}.0.bias" in sd)
    model.load_state_dict(dict(sd), strict=True)
    return model.eval().to(dev)


def load_enet(path: str = "", device="cuda") -> ENet:
    """The multiview CLIs' ENet: ``path`` empty -> seeded random weights
    (``init_enet``); a ``.pth`` -> a reference-keyed state dict (a
    ``model_state_dict`` payload and a leading ``module.`` are unwrapped);
    anything else -> a pickle of ``{"params", "state"}`` trees of numpy
    arrays or ``jax.Array``s in the JAX package's layout
    (``utils/jax_checkpoint.py::load_jax_pickle``)."""
    if not path:
        return init_enet(device=device)
    if path.endswith(".pth"):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        payload = payload.get("model_state_dict", payload)
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in payload.items()}
        print(f"loaded {len(sd)} ENet tensors")
    else:
        payload = load_jax_pickle(path)
        sd = enet_params_from_jax(payload["params"], payload["state"])
    return enet_from_state_dict(sd, device)

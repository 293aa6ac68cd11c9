"""The model's weights, made on the device from the seed in a few large
draws, with the init families of the model's layers: a ``Dense`` layer
uniform within 1 / sqrt(in) ("torch"), sqrt(6 / (in + out)) ("xavier") or
normal with std sqrt(2 / in) ("kaiming"), its bias uniform within
1 / sqrt(in); an embedding uniform within sqrt(6 / (n + d)); norms at
ones and zeros, batch-norm statistics at mean 0 and variance 1. The shapes
and families come from the reference's copy of the model, so the same
seed gives the same weights whatever the program does with them; both
sides load them by name."""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.spacap.models.core import BatchNorm, Dense, RefLayerNorm
from portbench.reference.spacap.models.spacap import SpaCapNet


def make_state(cfg, seed: int, device, objectness_bias: float = 0.0) -> Dict[str, torch.Tensor]:
    """A state dict (name -> f32 tensor on ``device``) for ``SpaCapNet(cfg)``.
    ``objectness_bias`` raises the objectness head's positive logit, so
    that random weights detect objects (the proposal head's last bias,
    index 1)."""
    with torch.device("meta"):
        model = SpaCapNet(cfg)
    uniform, normal, fixed = [], [], {}
    for prefix, m in model.named_modules():
        p = prefix + "." if prefix else ""
        if isinstance(m, Dense):
            if m.init == "kaiming":
                normal.append((p + "weight", m.weight.shape, math.sqrt(2.0 / m.in_dim)))
            else:
                limit = (math.sqrt(6.0 / (m.in_dim + m.out_dim)) if m.init == "xavier"
                         else 1.0 / math.sqrt(m.in_dim))
                uniform.append((p + "weight", m.weight.shape, limit))
            if m.bias is not None:
                uniform.append((p + "bias", m.bias.shape, 1.0 / math.sqrt(m.in_dim)))
        elif isinstance(m, torch.nn.Embedding):
            n, d = m.weight.shape
            uniform.append((p + "weight", m.weight.shape, math.sqrt(6.0 / (n + d))))
        elif isinstance(m, BatchNorm):
            c = m.num_features
            fixed.update({p + "weight": (c, 1.0), p + "bias": (c, 0.0),
                          p + "running_mean": (c, 0.0), p + "running_var": (c, 1.0)})
        elif isinstance(m, RefLayerNorm):
            fixed.update({p + "a_2": (m.a_2.shape[0], 1.0), p + "b_2": (m.b_2.shape[0], 0.0)})
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    state: Dict[str, torch.Tensor] = {}
    for leaves, draw in ((uniform, lambda n: torch.rand(n, generator=gen, device=device) * 2 - 1),
                         (normal, lambda n: torch.randn(n, generator=gen, device=device))):
        flat = draw(sum(math.prod(s) for _, s, _ in leaves)) if leaves else None
        offset = 0
        for name, shape, scale in leaves:
            n = math.prod(shape)
            state[name] = (flat[offset:offset + n] * scale).reshape(shape)
            offset += n
    for name, (c, value) in fixed.items():
        state[name] = torch.full((c,), value, device=device)
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            state[name] = torch.zeros((), dtype=torch.long, device=device)
        elif name not in state:
            raise KeyError(f"no init rule for {name}")
    if objectness_bias:
        state["proposal.proposal.6.bias"][1] += objectness_bias
    return state

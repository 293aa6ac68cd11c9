"""The plain reference of the train cells: it builds the loader's first
batches again from the raw scenes (the frozen copy of the dataset's item
builder and of the loader's index and RNG schedule), runs the frozen copy
of the model, its losses and a plain two-group Adam for the first steps in
float32 with TF32 off, from the benchmark's weights, with the dropout
generators the train loop seeds, and reads what the program's readings are
compared with: each step's loss, each leaf's first gradient as Adam holds
it (``exp_avg / (1 - beta1)`` after one step) and each leaf's change after
the steps. It imports nothing of the program."""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import synthetic
from portbench.reference.spacap.config import DataConfig, ModelConfig, TrainConfig
from portbench.reference.spacap.data.dataset import ScanReferDataset, Scene
from portbench.reference.spacap.data.loader import stack_batch
from portbench.reference.spacap.data.scannet_config import ScannetDatasetConfig
from portbench.reference.spacap.models.spacap import SpaCapNet
from portbench.reference.spacap.train.losses import get_scene_cap_loss

# the keys the train step reads
TRAIN_KEYS = (
    "point_clouds", "vote_label", "vote_label_mask", "center_label",
    "heading_class_label", "heading_residual_label", "size_class_label",
    "size_residual_label", "sem_cls_label", "box_label_mask", "box_label_mask_int",
    "ref_center_label", "lang_ids", "lang_label", "x_label", "y_label", "z_label",
)
BETA1 = 0.9


def dropout_generator(device, seed: int, global_iter: int) -> torch.Generator:
    """The train loop's dropout generator of a step (seeded from the train
    seed and the global iteration)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + global_iter) % (2 ** 63))
    return gen


def dataset(scenes: Dict, anns: List[dict], vocab_size: int, data: Dict) -> ScanReferDataset:
    return ScanReferDataset(anns, synthetic.store(Scene, scenes),
                            synthetic.reference_vocabulary(vocab_size), ScannetDatasetConfig(),
                            DataConfig(**data), split="train")


def loader_batches(ds: ScanReferDataset, batch: int, seed: int, count: int) -> List[Dict]:
    """The first ``count`` batches of a shuffled loader of epoch 0: the
    index order and each item's RNG as the program's loader keys them."""
    n = len(ds)
    order = np.random.RandomState((seed * 100003 + 0) % (2 ** 31)).permutation(n)
    out = []
    for b in range(count):
        items = [ds.__getitem__(int(i), rng=np.random.RandomState(
            (seed * 2654435761 + 0 * 97 + int(i)) % (2 ** 31)))
            for i in order[b * batch:(b + 1) * batch]]
        out.append(stack_batch(items))
    return out


def held_batches(ds: ScanReferDataset, batch: int, seed: int, count: int) -> List[Dict]:
    """``count`` batches of distinct items, each built with its own RNG,
    which the held-batch traffic cycles."""
    order = np.random.RandomState(seed).permutation(len(ds))[:batch * count]
    return [stack_batch([ds.__getitem__(int(i), rng=np.random.RandomState(
        (seed * 2654435761 + int(i)) % (2 ** 31))) for i in order[b * batch:(b + 1) * batch]])
        for b in range(count)]


def optimizer(model, tc: TrainConfig) -> torch.optim.Adam:
    """Adam (0.9, 0.999, eps 1e-8, coupled weight decay) in two groups:
    ``caption.*`` at ``transformer_lr``, the rest at ``lr``."""
    base = [p for n, p in model.named_parameters() if not n.startswith("caption.")]
    cap = [p for n, p in model.named_parameters() if n.startswith("caption.")]
    groups = [g for g in ({"params": base, "lr": tc.lr},
                          {"params": cap, "lr": tc.transformer_lr}) if g["params"]]
    return torch.optim.Adam(groups, betas=(BETA1, 0.999), eps=1e-8, weight_decay=tc.wd)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matmuls and convolutions on (the control's precision) or off."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def follow(model_fields: Dict, train_fields: Dict, batches: List[Dict],
           state0: Dict[str, torch.Tensor], device, steps: int = 3,
           precision: str = "float32", fault: Optional[str] = None) -> Dict:
    """The reference's readings over ``steps`` train steps on ``batches``:
    ``loss`` per step, ``grad`` (leaf -> norm of the first gradient as Adam
    holds it), ``raw_grad`` (leaf -> norm of the first step's gradient),
    ``change`` (leaf -> norm of its change after the steps, parameters and
    batch-norm statistics). ``precision`` "tf32" runs the control. A
    ``fault`` breaks the step as a faulty program would: "half" takes the
    loss over the first half of each batch, "stale" leaves the state as it
    was."""
    cfg, tc = ModelConfig(**model_fields), TrainConfig(**train_fields)
    model = SpaCapNet(cfg).to(device)
    model.load_state_dict({k: v.clone() for k, v in state0.items()})
    opt = optimizer(model, tc)
    momentum = torch.full((), 0.1, device=device)
    out: Dict = {"loss": []}
    with tf32(precision == "tf32"):
        for k in range(steps):
            host = batches[k]
            if fault == "half":
                host = {key: v[:len(v) // 2] for key, v in host.items()}
            batch = {key: torch.as_tensor(np.asarray(host[key])).to(device) for key in TRAIN_KEYS}
            batch = {key: v.float() if v.is_floating_point() else v for key, v in batch.items()}
            model.train()
            ep = model.train_forward(batch, dropout_generator(device, tc.seed, k), momentum)
            ep = get_scene_cap_loss(ep, model.mean_size_arr, cfg.num_heading_bin,
                                    cfg.num_size_cluster, detection=not tc.no_detection,
                                    caption=not tc.no_caption,
                                    use_relation=tc.use_relation and cfg.check_relation)
            model.zero_grad(set_to_none=True)
            ep["loss"].backward()
            if k == 0:
                out["raw_grad"] = leaf_norms({n: p.grad for n, p in model.named_parameters()
                                              if p.grad is not None})
            if fault != "stale":
                opt.step()
            out["loss"].append(float(ep["loss"].detach()))
            if k == 0:
                out["grad"] = adam_grads(model, opt)
    out["change"] = changes(model, state0)
    return out


def adam_grads(model, opt) -> Dict[str, float]:
    """Leaf -> norm of the first gradient as Adam holds it, from its first
    moment after one step."""
    out = {}
    for n, p in model.named_parameters():
        st = opt.state.get(p)
        out[n] = (float(torch.linalg.vector_norm(st["exp_avg"].double())) / (1 - BETA1)
                  if st and "exp_avg" in st else 0.0)
    return out


def changes(model, state0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Leaf -> norm of its change from ``state0``: parameters and the
    batch-norm running statistics."""
    now = model.state_dict()
    return {k: float(torch.linalg.vector_norm((now[k].double() - state0[k].double())))
            for k in state0 if now[k].is_floating_point()}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of a train check: ``loss_gap`` (the widest relative gap
    of a step's loss), ``loss1_gap`` (the first step's), ``grad_gap`` and
    ``change_gap`` (the worst leaf's gap between the two norms, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger), ``change_median_gap`` (the median leaf's gap). Leaves whose
    first gradient in the reference is under a thousandth of the median
    leaf's move under Adam by round-off alone and are left out of the
    change. The cell's limits name the numbers compared."""
    gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog["loss"], ref["loss"])]
    med = float(np.median([v for v in ref["raw_grad"].values()]))
    kept = [k for k in ref["change"]
            if k not in ref["raw_grad"] and k not in ref["grad"]
            or ref["raw_grad"].get(k, 0.0) >= 1e-3 * med]
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": worst(prog["grad"], ref["grad"], ref["grad"].keys()),
            "change_gap": worst(prog["change"], ref["change"], kept),
            "change_median_gap": worst(prog["change"], ref["change"], kept, np.median)}


def worst(prog: Dict[str, float], ref: Dict[str, float], keys, over=max) -> float:
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return float(over([abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keys]))

"""The train and eval steps, as ``spacap3d_tpu/train/step.py``.

Train: forward (batch-statistics BN, dropout), losses, backward, two-group
Adam with torch's coupled weight decay (the JAX chain
``add_decayed_weights -> scale_by_adam -> lr``) and the BN running-stat
update. Eval: the eval forward (with greedy decode) plus the detection
side-outputs the eval harness reads. The attention dump: the detector in
eval mode, then the teacher-forced captioner over the greedy tokens.

On CUDA both steps run captured by default (``train/capture.py``), the
counterparts of the JAX package's ``jax.jit`` of its steps: the train
step's forward, losses, backward and Adam update replay as one CUDA graph,
its scheduler steps on the host between replays. So do the data- and
tensor-parallel steps over NCCL groups, their collectives inside the
graphs, as the JAX package jits its steps over its mesh; a step with a
gloo group runs eagerly (``captured``).

Data parallelism (``group``): the train step on each rank of a process
group computes what the JAX package's step computes on one mesh-sharded
global batch. Each rank holds a row-block of the batch; batch norm takes
its statistics over every rank's rows and the losses divide by the global
counts (``models/core.py``, ``train/losses.py``), so this rank's loss is
its share of the global loss. After the backward one all-reduce sums the
gradients over the group, and the same Adam update on every rank keeps
the parameters equal. The metrics are the global batch's.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from spacap3d_tpu_torch.config import ModelConfig, TrainConfig
from spacap3d_tpu_torch.device import resolve_device
from spacap3d_tpu_torch.models.core import Momentum, set_batch_norm_group, split_generators
from spacap3d_tpu_torch.parallel.tp import average_replicated_gradients
from spacap3d_tpu_torch.ops.nn_distance import nn_distance
from spacap3d_tpu_torch.train.capture import CapturedFunction, optimizer_state
from spacap3d_tpu_torch.train.losses import NEAR_THRESHOLD, get_scene_cap_loss
from spacap3d_tpu_torch.utils import trace
from spacap3d_tpu_torch.utils.segments import Segments, run_eager

# metrics a train step returns (the reference Solver's log keys)
METRIC_KEYS = (
    "loss", "det_loss", "cap_loss", "relation_loss", "vote_loss",
    "objectness_loss", "box_loss", "center_loss", "heading_cls_loss",
    "heading_reg_loss", "size_cls_loss", "size_reg_loss", "sem_cls_loss",
    "cap_acc", "obj_acc", "pos_ratio", "neg_ratio", "pred_ious",
    "x_loss", "y_loss", "z_loss", "x_acc", "y_acc", "z_acc",
)
# metrics that are means over each rank's rows (the captioner's pred_ious):
# under data parallelism the ranks' values are averaged, the others summed
MEAN_METRIC_KEYS = ("pred_ious",)
# the batch keys the train step reads
TRAIN_KEYS = (
    "point_clouds", "vote_label", "vote_label_mask", "center_label",
    "heading_class_label", "heading_residual_label", "size_class_label",
    "size_residual_label", "sem_cls_label", "box_label_mask", "box_label_mask_int",
    "ref_center_label", "lang_ids", "lang_label", "x_label", "y_label", "z_label",
)

# the batch keys the eval step reads (outside point-table mode)
EVAL_INPUT_KEYS = ("point_clouds", "center_label")
COMPACT_KEYS = (
    "lang_cap", "bbox_lo", "bbox_hi", "bbox_mask",
    "objectness_scores", "sem_cls_scores",
    "object_assignment", "nonempty_box",
)
FULL_KEYS = (
    "lang_cap", "bbox_corner", "bbox_mask", "objectness_scores",
    "sem_cls_scores", "sem_cls", "center", "object_assignment",
    "objectness_label", "aggregated_vote_xyz", "nonempty_box",
)


def to_device_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``device``; floats as f32. An
    ``upload`` span (``utils/trace.py``): the ``bytes`` copied from other
    devices and whether all of them were ``pinned``."""
    out, moved = {}, []
    with trace.span("upload") as span:
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if t.is_floating_point():
                t = t.to(torch.float32)
            out[k] = t.to(device)
            if span and out[k].device != t.device:
                moved.append(t)
        if span:
            span.set(bytes=sum(t.nbytes for t in moved),
                     pinned=bool(moved) and all(t.is_pinned() for t in moved))
    return out


def gather_point_table(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Point-table mode: each row names a scene of ``point_table`` and the
    indices of its subsampled points."""
    rows = batch["scene_row"].long()
    scene_pts = batch["point_table"][rows]                      # (B, P, C)
    choices = batch["pc_choices"].long()[..., None].expand(-1, -1, scene_pts.shape[-1])
    return {"point_clouds": torch.gather(scene_pts, 1, choices),
            "center_label": batch["center_table"][rows]}


def eval_tail(cfg: ModelConfig, ep: Dict[str, torch.Tensor],
              batch: Dict[str, torch.Tensor], compact: bool) -> Dict[str, torch.Tensor]:
    """Objectness label / GT assignment, the >= 5-points non-empty box test
    and the compact narrowing; returns the output dict."""
    dist1, ind1, _, _ = nn_distance(ep["aggregated_vote_xyz"], batch["center_label"][:, :, :3])
    ep["objectness_label"] = (torch.sqrt(dist1 + 1e-6) < NEAR_THRESHOLD).to(torch.int32)
    ep["object_assignment"] = ind1
    lo = ep["bbox_corner"].amin(dim=2)                          # (B, K, 3)
    hi = ep["bbox_corner"].amax(dim=2)
    # contiguous: each of the K boxes reads every point, and a strided view of
    # a wide cloud (135 channels with multiview features) spans more than L2
    pc3 = batch["point_clouds"][..., :3].contiguous()
    inside = None
    for a in range(3):                                          # (B, K, N) per axis
        p = pc3[:, None, :, a]
        in_a = (p >= lo[:, :, None, a]) & (p <= hi[:, :, None, a])
        inside = in_a if inside is None else inside & in_a
    ep["nonempty_box"] = inside.sum(dim=-1) >= 5
    if compact:
        ep["bbox_lo"], ep["bbox_hi"] = lo, hi
        if "lang_cap" in ep and cfg.vocab_size < 65536:
            ep["lang_cap"] = ep["lang_cap"].to(torch.uint16)
        ep["bbox_mask"] = ep["bbox_mask"] != 0
        ep["object_assignment"] = ep["object_assignment"].to(torch.uint16)
    keys = COMPACT_KEYS if compact else FULL_KEYS
    return {k: ep[k] for k in keys if k in ep}


def eval_segments(cfg: ModelConfig, compact: bool) -> Callable[[torch.nn.Module], Segments]:
    """The eval forward of ``model`` as ``Segments`` (``utils/segments.py``):
    the point-table gather, the trunk and the object tokens, the greedy
    decode, then ``eval_tail``. The decode's parts are
    ``Captioner.decode_segments``, which ``greedy_decode`` runs too: one
    part, or with ``eval_decode_early_exit`` a part a stage of
    ``decode_plan`` (the trunk in the first, the tail after the last), the
    host's all-EOS test between them. Eager and captured steps run these
    parts alike."""

    def segments_of(model) -> Segments:
        cap = None if model.cfg.no_caption else model.caption

        def head(carry):
            batch = carry["inputs"]
            if "pc_choices" in batch:
                batch = gather_point_table(batch)
            carry["batch"] = batch
            carry["ep"] = model.detect(batch["point_clouds"])
            return None if cap is None else cap.object_tokens(carry["ep"])

        def tail(carry, tokens):
            ep = carry["ep"]
            if tokens is not None:
                b, k, _ = ep["aggregated_vote_features"].shape
                ep["lang_cap"] = tokens.reshape(b, k, -1)
            return eval_tail(cfg, ep, carry["batch"], compact)

        if cap is None:
            return Segments([lambda carry: tail(carry, head(carry))])
        return cap.decode_segments(head, tail)

    return segments_of


def group_backend(group) -> str:
    """The backend of a process group (``"nccl"`` or ``"gloo"``)."""
    return dist.get_backend(group)


def step_groups(model=None, group=None) -> list:
    """The process groups a step on ``model`` runs collectives over, each
    once: the data-parallel ``group``, and for a model cut by
    ``parallel/tp.py::shard_model`` its model group and data group."""
    groups = [] if group is None else [group]
    tp_group = getattr(getattr(model, "caption", None), "tp_group", None)
    if tp_group is not None:
        mesh = getattr(model, "tp_mesh", None)
        groups += [tp_group] + ([] if mesh is None else [mesh.data])
    return list({id(g): g for g in groups}.values())


def captured(capture: bool, device: torch.device, model=None, group=None) -> bool:
    """Whether an eval or train step on ``device`` runs captured (the
    steps' ``capture``): on CUDA unless ``capture`` is False, and only
    where every process group of the step (``step_groups``: a
    data-parallel ``group``, a tensor-parallel model's groups) is NCCL,
    whose collectives a CUDA graph records. A gloo group's collectives run
    on the host, so a step with one runs eagerly."""
    if not (capture and device.type == "cuda"):
        return False
    return all(group_backend(g) == "nccl" for g in step_groups(model, group))


def dropout_generators(model, gen):
    """The step's dropout generators for ``model``: ``gen``, or under
    tensor parallelism ``gen`` and the model rank's own
    (``models/core.py::split_generators``), split before the step's
    function so that a captured step owns and registers both."""
    tp_group = getattr(getattr(model, "caption", None), "tp_group", None)
    if gen is None or tp_group is None:
        return gen
    return split_generators(gen, model.caption.tp_rank)


def make_eval_step(cfg: ModelConfig, device="cuda", compact: bool = False,
                   capture: bool = True) -> Callable:
    """Returns step(model, batch) -> output dict of tensors on ``device``.

    ``batch`` holds ``point_clouds`` (B, N, 3 + D) and ``center_label``
    (B, G, 3+), or the point-table keys ``point_table``, ``scene_row``,
    ``pc_choices`` and ``center_table``; numpy arrays or tensors, uploaded
    to ``device`` first.

    ``capture``: True captures on CUDA and runs eagerly on the CPU; False
    runs eagerly. A captured step (``train/capture.py::CapturedFunction``,
    the counterpart of the JAX package's ``jax.jit`` of its eval step)
    replays the forward from CUDA graphs from the upload on: one graph, or
    with the decode's early exit a graph a stage and the tail, the host's
    all-EOS test between them. The point and centre tables are read where
    they lie. A model cut by ``parallel/tp.py::shard_model`` captures
    where its groups are NCCL (``captured``), its all-reduces inside the
    graphs, and runs eagerly over gloo; every rank of the model group
    calls the step at once. ``step.program`` is the captured program (None
    when eager)."""
    dev = resolve_device(device)
    segments_of = eval_segments(cfg, compact)
    program = (CapturedFunction(segments_of, by_address=("point_table", "center_table"),
                                groups_of=step_groups, name="eval")
               if captured(capture, dev) else None)

    @torch.no_grad()
    def step(model, batch) -> Dict[str, torch.Tensor]:
        batch = to_device_batch(batch, dev)
        model.eval()
        if program is not None and captured(capture, dev, model):
            return program(model, batch)
        return run_eager(segments_of(model), batch)

    step.program = program
    return step


def make_attn_dump_step(device="cuda") -> Callable:
    """Returns dump(model, batch, tokens) -> (enc_attn (L, B, h, K, K),
    dec_attn (L, B*K, h, T', T')), as the JAX package's
    ``make_attn_dump_step``: the detector in eval mode over
    ``batch["point_clouds"]``, then ``Captioner.attention_dump`` over the
    generated ``tokens`` (B, K, T), on ``device``."""
    dev = resolve_device(device)

    @torch.no_grad()
    def dump(model, batch, tokens) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        ep = model.detect(to_device_batch({"point_clouds": batch["point_clouds"]},
                                          dev)["point_clouds"])
        return model.caption.attention_dump(ep, torch.as_tensor(tokens).to(dev))

    return dump


def make_optimizer(model: torch.nn.Module, tc: TrainConfig, steps_per_epoch: int
                   ) -> Tuple[torch.optim.Adam, Optional[torch.optim.lr_scheduler.MultiStepLR]]:
    """Adam (betas 0.9 / 0.999, eps 1e-8, coupled weight decay ``tc.wd``) in
    two groups: ``caption.*`` at ``tc.transformer_lr``, the rest at
    ``tc.lr``. ``no_detection`` leaves the trunk's parameters out (its BN
    running stats still move). Detection pretraining (``no_caption``) with
    ``lr_decay_step`` also returns a MultiStepLR, to be stepped once an
    update, that decays the rate by ``lr_decay_rate`` from the update of
    index ``epoch * steps_per_epoch`` on; else the scheduler is None.

    On CUDA the Adam is ``capturable`` (its step counts on the device, so
    that a captured step may run it), eager steps too, and where the
    MultiStepLR moves the rate each group's ``lr`` is a 0-dim tensor on the
    device that the scheduler fills in place. torch allows ``capturable``
    only on CUDA-like devices: on the CPU it is the plain Adam."""
    dev = next(model.parameters()).device
    capturable = dev.type == "cuda"
    scheduled = bool(tc.no_caption and tc.lr_decay_step)
    groups = {"base": [], "caption": []}
    for name, p in model.named_parameters():
        if name.startswith("caption."):
            groups["caption"].append(p)
        elif not tc.no_detection:
            groups["base"].append(p)

    def rate(lr):
        return torch.tensor(float(lr), device=dev) if capturable and scheduled else lr
    params = [{"params": groups["base"], "lr": rate(tc.lr)},
              {"params": groups["caption"], "lr": rate(tc.transformer_lr)}]
    opt = torch.optim.Adam([g for g in params if g["params"]], betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=tc.wd, capturable=capturable)
    sched = None
    if scheduled:
        sched = torch.optim.lr_scheduler.MultiStepLR(
            opt, [int(e) * steps_per_epoch for e in tc.lr_decay_step], gamma=tc.lr_decay_rate)
    return opt, sched


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: Dict) -> None:
    """``optimizer.load_state_dict(state_dict)`` into the optimizer's own
    kind: a state written by a capturable Adam (``capturable`` groups,
    tensor rates) loads into the CPU's plain Adam, and the CPU's into a
    capturable one (which moves the step counts to the parameters' device
    as it loads them). Each group keeps its ``capturable`` flag and its
    kind of ``lr``: a tensor rate is filled in place with the saved value.
    New state tensors make a captured step's next call capture anew
    (``train/capture.py::optimizer_state``)."""
    live = [(g.get("capturable"), g["lr"]) for g in optimizer.param_groups]
    groups = []
    for g, (capturable, _) in zip(state_dict["param_groups"], live):
        g = dict(g, lr=float(g["lr"]))
        if capturable is not None:
            g["capturable"] = capturable
        groups.append(g)
    optimizer.load_state_dict({**state_dict, "param_groups": groups})
    for g, (_, lr) in zip(optimizer.param_groups, live):
        if torch.is_tensor(lr):
            lr.fill_(g["lr"])
            g["lr"] = lr


def allreduce_gradients(model: torch.nn.Module, group) -> None:
    """Sums every ``.grad`` of ``model`` over ``group``, in one all-reduce
    of the flattened gradients."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def global_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each rank's shares of the metrics -> the global batch's metrics, in
    one all-reduce: summed, ``MEAN_METRIC_KEYS`` averaged."""
    keys = list(metrics)
    both = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(both, group=group)
    world = dist.get_world_size(group)
    return {k: both[i] / world if k in MEAN_METRIC_KEYS else both[i]
            for i, k in enumerate(keys)}


def mark(marks: Optional[list]) -> None:
    """Records a timing event into ``marks``, where it is a list."""
    if marks is not None:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()


@contextlib.contextmanager
def warm_up_gradients(model: torch.nn.Module, carry: Dict):
    """Around the capture of a train step: the capture sets each ``.grad``
    to None and its backward allocates the graph's own, from the graph's
    pool, which every replay overwrites (torch's whole-network capture);
    they hold nothing until a replay, so after the capture they take the
    eager warm-up's gradients: ``.grad`` holds the step's gradients after a
    capture call as after any other. Under data or tensor parallelism the
    warm-up's gradients are already reduced over the groups, as a replay's
    are."""
    warm = [p.grad for p in model.parameters()]
    yield
    with torch.no_grad():
        for p, g in zip(model.parameters(), warm):
            if p.grad is not None and g is not None:
                p.grad.copy_(g)


def train_segments(cfg: ModelConfig, tc: TrainConfig, optimizer: torch.optim.Optimizer,
                   momentum: Momentum, group=None) -> Callable[[torch.nn.Module], Segments]:
    """The train step's work on ``model`` as ``Segments`` of one part, on a
    carry holding the batch (``"inputs"``), the dropout generator
    (``"gen"``) and, for an eager step, the timing ``"marks"``: the train
    forward with BN at ``momentum``, the losses, ``zero_grad`` to None and
    the backward (under tensor or data parallelism the gradients' reductions
    follow), and ``optimizer.step()``; it returns the metrics. Eager and
    captured steps run this part alike."""

    def segments_of(model) -> Segments:
        def part(carry):
            marks = carry.get("marks")
            mark(marks)
            ep = model.train_forward(carry["inputs"], carry.get("gen"), momentum)
            mark(marks)
            ep = get_scene_cap_loss(
                ep, model.mean_size_arr, cfg.num_heading_bin, cfg.num_size_cluster,
                detection=not tc.no_detection, caption=not tc.no_caption,
                use_relation=tc.use_relation and cfg.check_relation, group=group)
            mark(marks)
            model.zero_grad(set_to_none=True)
            ep["loss"].backward()
            tp_mesh = getattr(model, "tp_mesh", None)
            if tp_mesh is not None:
                average_replicated_gradients(model, tp_mesh)
            if group is not None:
                allreduce_gradients(model, group)
            mark(marks)
            optimizer.step()
            return {k: ep[k].detach() for k in METRIC_KEYS if k in ep}

        return Segments([part], around_capture=functools.partial(warm_up_gradients, model))

    return segments_of


def make_train_step(cfg: ModelConfig, tc: TrainConfig, optimizer: torch.optim.Optimizer,
                    device="cuda", scheduler=None, group=None, capture: bool = True) -> Callable:
    """Returns step(model, batch, gen=None, bn_momentum=0.1, marks=None) ->
    metrics, a dict of 0-dim tensors on ``device`` (``METRIC_KEYS``) taken
    in the forward, before the update. A step sets ``model.train()``, runs
    the train forward (dropout masks from ``gen``, BN running stats moved
    at ``bn_momentum``), the losses and the backward, and steps
    ``optimizer`` (and ``scheduler``). The gradients stay in ``.grad``
    until the next step. ``batch`` holds ``TRAIN_KEYS`` as numpy arrays or
    tensors. The momentum is a Python float; the step fills a 0-dim f32
    tensor of its own with it, which the batch norms read. On a CUDA
    device a list ``marks`` receives five timing events, recorded before
    the forward and after the forward, the losses, the backward and the
    optimizer step: an eager step's split into those parts.

    ``capture``: True captures on CUDA and runs eagerly on the CPU; False
    runs eagerly. A captured step (``train/capture.py::CapturedFunction``
    over ``train_segments``, the counterpart of the JAX package's
    ``jax.jit`` of its train step) replays the forward, losses, backward
    and Adam update from one CUDA graph from the batch's upload on; the
    scheduler steps on the host after it. Its first call of a key runs the
    step eagerly (a real update; its metrics are the call's), then
    captures; later calls copy the batch into the graph's inputs, load
    ``gen``'s state into the program's own generator, replay, write the
    advanced state back into ``gen`` and return copies of the metrics. It
    needs the optimizer of ``make_optimizer`` (capturable on CUDA); CUDA
    events recorded in a capture do not time a replay, so a captured step
    given ``marks`` raises ``ValueError``. With a ``group``, and for a
    model cut by ``parallel/tp.py::shard_model``, the step captures where
    every group is NCCL (``captured``), its collectives inside the graph,
    every rank of the world calling it at once, and runs eagerly over
    gloo. A capture or a replay that fails raises. ``step.program`` is the
    captured program (None when eager).

    ``group``: a process group whose ranks each pass their row-block of one
    global batch (module docstring); the gradients are summed over it
    before the update, and the metrics are the global batch's. Under tensor
    parallelism (a model cut by ``parallel/tp.py::shard_model``) it is the
    data group, and the gradients of the parameters every rank of a model
    group holds whole are first averaged over that group."""
    dev = resolve_device(device)
    momentum = torch.zeros((), device=dev)
    segments_of = train_segments(cfg, tc, optimizer, momentum, group)
    program = (CapturedFunction(segments_of, state_of=lambda: optimizer_state(optimizer),
                                groups_of=functools.partial(step_groups, group=group),
                                name="train")
               if captured(capture, dev, group=group) else None)

    def step(model, batch, gen: Optional[torch.Generator] = None,
             bn_momentum: float = 0.1, marks: Optional[list] = None
             ) -> Dict[str, torch.Tensor]:
        use_program = program is not None and captured(capture, dev, model, group)
        if use_program and marks is not None:
            raise ValueError("a captured train step takes no marks: CUDA events recorded in "
                             "a capture do not time its replays; pass capture=False")
        batch = to_device_batch({k: batch[k] for k in TRAIN_KEYS}, dev)
        model.train()
        momentum.fill_(bn_momentum)
        gen = dropout_generators(model, gen)
        set_batch_norm_group(model, group)
        try:
            if use_program:
                metrics = program(model, batch, gen)
            else:
                metrics = run_eager(segments_of(model), batch, gen=gen, marks=marks)
        finally:
            set_batch_norm_group(model, None)
        if scheduler is not None:
            scheduler.step()
        mark(marks)
        return metrics if group is None else global_metrics(metrics, group)

    step.program = program
    return step

"""The port's train step against the JAX package on the CPU: the tiny
config with dropout 0 (JAX's dropout is the identity at rate 0; the two
frameworks' random streams differ), the same weights (JAX init ->
``params_from_jax``) and the same synthetic batch.

Tolerances, per test: indices exactly equal; losses and metrics within
rtol 1e-4 (the JAX package's loss tolerance); captioner endpoints within
5e-4 (PARITY.md's trunk tolerance: the frameworks sum matmuls in other
orders); each gradient leaf within 1e-3 of its largest entry (see
``GRAD_SHARE``); BN running stats within 1e-5; the optimizer's parameters
within 1e-6 after 3 steps on the same gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from spacap3d_tpu.config import TrainConfig as JaxTrainConfig
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu.data.synthetic import synthetic_batch
from spacap3d_tpu.models import init_spacap as jax_init_spacap
from spacap3d_tpu.models.captioner import captioner_train
from spacap3d_tpu.models.spacap import apply_spacap
from spacap3d_tpu.train.losses import get_scene_cap_loss as jax_scene_cap_loss
from spacap3d_tpu.train.step import init_train_state
from spacap3d_tpu.train.step import make_optimizer as jax_make_optimizer
from spacap3d_tpu.train.step import make_train_step as jax_make_train_step
from spacap3d_tpu.utils.convert import convert_state_dict
from spacap3d_tpu_torch.config import SOS_ID, ModelConfig, TrainConfig
from spacap3d_tpu_torch.data.scannet_config import mean_size_arr
from spacap3d_tpu_torch.data.spatiality import generate_relation_labels
from spacap3d_tpu_torch.data.synthetic import train_batch
from spacap3d_tpu_torch.models import SpaCapNet
from spacap3d_tpu_torch.train.step import (
    METRIC_KEYS,
    TRAIN_KEYS,
    make_optimizer,
    make_train_step,
    to_device_batch,
)
from spacap3d_tpu_torch.utils.convert import params_from_jax

LOSS_RTOL = 1e-4
FLOAT_TOL = 5e-4
# A gradient leaf may differ from JAX's by this share of its largest entry:
# the two sides' forwards differ by rounding, which the backward's long
# sums (SA1's BN over B x 128 x 16 rows) carry into the gradients. A floor
# of 1e-4 of the largest entry over all leaves covers the leaves whose
# gradient is zero up to rounding: attention key biases (softmax is
# invariant to them) and biases ahead of a train-mode BN.
GRAD_SHARE = 1e-3
GRAD_FLOOR = 1e-4
CPU = torch.device("cpu")


def torch_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(cfg, sd):
    model = SpaCapNet(torch_cfg(cfg))
    model.load_state_dict(sd, strict=True)
    return model


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    """Tiny config, dropout 0; the JAX package's synthetic batch with the
    real boxes' GT centres moved onto proposals (found by one port forward
    in train mode), so that objectness, box and relation terms all see
    positives; JAX's loss, gradients and new BN state."""
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), transformer_dropout=0.0)
    params, state = jax_init_spacap(jax.random.PRNGKey(0), cfg,
                                    ScannetDatasetConfig().mean_size_arr)
    sd = params_from_jax(to_np(params), to_np(state))
    batch, _, _ = synthetic_batch(cfg, batch_size=2, seed=3, vocab_size=cfg.vocab_size)
    batch = {k: batch[k] for k in TRAIN_KEYS}
    with torch.no_grad():
        ep = port_model(cfg, sd).train().train_forward(to_device_batch(batch, CPU))
    nobj = batch["box_label_mask_int"].sum(1)
    for b in range(2):
        batch["center_label"][b, :nobj[b]] = ep["aggregated_vote_xyz"][b, :nobj[b]].numpy() + 0.05

    def loss_fn(p, s, bt):
        ep, new_state = apply_spacap(p, s, cfg, bt, is_eval=False, train=True,
                                     rng=jax.random.PRNGKey(0), bn_momentum=0.1)
        ep = jax_scene_cap_loss(ep, p["mean_size_arr"], cfg.num_heading_bin,
                                cfg.num_size_cluster, detection=True, caption=True,
                                use_relation=True)
        return ep["loss"], new_state

    (_, new_state), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(cfg=cfg, params=params, state=state, sd=sd, batch=batch, grads=grads,
                new_state=new_state)


def test_whole_model_gradients_match_jax(setup):
    """``jax.value_and_grad`` of ``apply_spacap`` plus ``get_scene_cap_loss``
    against the port's backward, leaf by leaf through ``convert_state_dict``:
    each within ``GRAD_SHARE`` of its largest entry (floored at
    ``GRAD_FLOOR`` of the largest entry of all); every leaf but
    ``mean_size_arr`` (frozen, a buffer in the port) is compared."""
    model = port_model(setup["cfg"], setup["sd"])
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    metrics = make_train_step(torch_cfg(setup["cfg"]), TrainConfig(), opt, device="cpu")(
        model, setup["batch"])
    assert float(metrics["relation_loss"]) > 0 and float(metrics["pos_ratio"]) > 0
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert len(grads) == len(setup["sd"]) - sum(k.endswith(("running_mean", "running_var",
                                                             "num_batches_tracked"))
                                                for k in setup["sd"])
    got, _, report = convert_state_dict(grads, setup["params"], setup["state"], strict=True)
    assert len(report["loaded"]) == len(grads) and not report["skipped"]
    got, want = leaves(got), leaves(setup["grads"])
    del want["['mean_size_arr']"]
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        tol = GRAD_SHARE * max(np.abs(w).max(), GRAD_FLOOR * top)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol, err_msg=k)
    assert np.abs(got["['caption']['relation_proposal']['l0']['kernel']"]).max() > 0


def test_train_step_metrics_and_bn_state_match_jax(setup):
    """One ``make_train_step`` step of each package from the same weights:
    every metric within rtol 1e-4 (atol 1e-6); the new BN running stats
    within rtol 1e-5, atol 1e-5. The weights' update is compared in
    ``test_optimizer_matches_optax_on_the_same_gradients``: Adam's first
    step is about lr * sign(g), which flips where g is near 0."""
    cfg, params, state = setup["cfg"], setup["params"], setup["state"]
    jtc = JaxTrainConfig()
    tx = jax_make_optimizer(params, jtc, steps_per_epoch=10)
    _, want = jax_make_train_step(cfg, jtc, tx)(
        init_train_state(params, state, tx),
        {k: jnp.asarray(v) for k, v in setup["batch"].items()}, jax.random.PRNGKey(0), 0.1)
    model = port_model(cfg, setup["sd"])
    opt, sched = make_optimizer(model, TrainConfig(), steps_per_epoch=10)
    assert sched is None
    got = make_train_step(torch_cfg(cfg), TrainConfig(), opt, device="cpu")(
        model, setup["batch"], None, 0.1)
    assert sorted(got) == sorted(METRIC_KEYS) == sorted(want)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _, new_state, _ = convert_state_dict(sd, params, state, strict=True)
    got, want = leaves(new_state), leaves(setup["new_state"])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
        assert not np.array_equal(w, leaves(state)[k]), k


CAPTIONER_VARIANTS = [
    dict(early_guide=True, use_transformer_encoder=True, src_pos_type="xyz"),
    dict(early_guide=False, use_transformer_encoder=True, src_pos_type="xyz"),
    dict(early_guide=True, use_transformer_encoder=True, src_pos_type=None),
    dict(early_guide=False, use_transformer_encoder=False, src_pos_type="center"),
]


@pytest.mark.parametrize("variant", range(len(CAPTIONER_VARIANTS)))
def test_captioner_train_endpoints_match_jax(rng, variant):
    """``captioner_train`` (train mode, dropout 0) on the same proposals and
    captions: ``lang_cap`` log-probs and ``relation_pred`` within 5e-4,
    ``match_idx`` and ``good_bbox_masks`` equal, ``pred_ious`` within rtol
    1e-5, the source-embedding BN's new running stats within 1e-5."""
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), transformer_dropout=0.0,
                              **CAPTIONER_VARIANTS[variant])
    params, state = jax_init_spacap(jax.random.PRNGKey(variant), cfg,
                                    ScannetDatasetConfig().mean_size_arr)
    b, k, d, t = 2, cfg.num_proposals, cfg.d_model, cfg.max_des_len
    lang = np.zeros((b, t + 3), np.int64)
    lang[:, 0] = 1
    lang[0, 1:7] = [SOS_ID, 9, 17, 5, 40, 3]
    lang[1, 1:t + 3] = [SOS_ID, *rng.randint(4, cfg.vocab_size, t), 3]
    ep = {
        "aggregated_vote_features": rng.randn(b, k, d).astype(np.float32),
        "aggregated_vote_xyz": (rng.rand(b, k, 3) * 4).astype(np.float32),
        "center": (rng.rand(b, k, 3) * 4).astype(np.float32),
        "bbox_mask": rng.randint(0, 2, (b, k)).astype(np.int32),
        "ref_center_label": (rng.rand(b, 3) * 4).astype(np.float32),
        "lang_label": lang,
    }
    want, new_s = captioner_train(params["caption"], state["caption"], cfg,
                                  {n: jnp.asarray(v) for n, v in ep.items()},
                                  jax.random.PRNGKey(1), True, 0.1)
    model = port_model(cfg, params_from_jax(to_np(params), to_np(state))).train()
    with torch.no_grad():
        got = model.caption.train_forward({n: torch.from_numpy(v) for n, v in ep.items()})
    keys = ["lang_cap", "match_idx", "good_bbox_masks", "pred_ious"]
    if cfg.use_transformer_encoder:
        keys.append("relation_pred")
    assert sorted(got) == sorted(keys)
    assert got["lang_cap"].shape == (b, t + 1, cfg.vocab_size)
    for n in keys[:1] + keys[4:]:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), atol=FLOAT_TOL, rtol=0,
                                   err_msg=n)
    for n in ("match_idx", "good_bbox_masks"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]), err_msg=n)
    np.testing.assert_allclose(float(got["pred_ious"]), float(want["pred_ious"]), rtol=1e-5)
    if "src_embed" in new_s:
        bn = model.caption.model.src_embed.position_embedding_head[1]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_s["src_embed"]["bn"]
                                                                       ["mean"]), atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_s["src_embed"]["bn"]
                                                                      ["var"]), atol=1e-5)


OPTIMIZER_CASES = {
    "two groups": (dict(lr=1e-3, transformer_lr=3e-4, wd=1e-2), {}),
    "no_detection": (dict(lr=1e-3, transformer_lr=3e-4, wd=1e-2, no_detection=True), {}),
    "no_caption, MultiStepLR": (dict(lr=1e-3, wd=1e-2, no_caption=True, lr_decay_step=(1, 2),
                                     lr_decay_rate=0.1), dict(no_caption=True)),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_optax_on_the_same_gradients(rng, case):
    """Three updates from the same random gradients, fed to both sides:
    the port's Adam groups against ``make_optimizer(flat=False)``, every
    parameter within 1e-6. ``no_detection`` leaves the trunk exactly as it
    was; ``no_caption`` decays the rate at updates 1 and 2 (epochs 1 and 2
    at one step an epoch), as optax's piecewise-constant schedule does."""
    tkw, ckw = OPTIMIZER_CASES[case]
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), **ckw)
    params, state = jax_init_spacap(jax.random.PRNGKey(0), cfg,
                                    ScannetDatasetConfig().mean_size_arr)
    tx = jax_make_optimizer(params, JaxTrainConfig(**tkw), steps_per_epoch=1, flat=False)
    opt_state = tx.init(params)
    model = port_model(cfg, params_from_jax(to_np(params), to_np(state)))
    opt, sched = make_optimizer(model, TrainConfig(**tkw), steps_per_epoch=1)
    assert (sched is not None) == ("MultiStepLR" in case)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    jp = params
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda x: rng.randn(*np.shape(x)).astype(np.float32), jp)
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = params_from_jax(to_np(g), to_np(state))
        for n, p in model.named_parameters():
            p.grad = tg[n].clone()
        opt.step()
        if sched is not None:
            sched.step()
    sd = {n: p.detach().numpy() for n, p in model.named_parameters()}
    got, _, _ = convert_state_dict(sd, params, state, strict=True)
    got, want = leaves(got), leaves(jp)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        assert moved != (tkw.get("no_detection", False) and not n.startswith("caption.")), n


def test_train_step_loss_falls_on_one_batch():
    """16 steps on one batch, dropout 0.1 from a seeded generator: the best
    loss of the second half is 30% below the first (the JAX package's gate,
    tests/test_train_e2e.py); every metric finite; ``mean_size_arr``
    unchanged."""
    cfg = torch_cfg(_flagship_cfg(tiny=True))
    model = port_model(cfg, params_from_jax(*(to_np(t) for t in jax_init_spacap(
        jax.random.PRNGKey(0), cfg, ScannetDatasetConfig().mean_size_arr))))
    msa = model.mean_size_arr.clone()
    batch = train_batch(cfg, 4, seed=1)
    opt, _ = make_optimizer(model, TrainConfig(), steps_per_epoch=10)
    step = make_train_step(cfg, TrainConfig(), opt, device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(16):
        metrics = step(model, batch, gen, 0.1)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        losses.append(float(metrics["loss"]))
    assert min(losses[8:]) < losses[0] * 0.7, losses
    assert torch.equal(model.mean_size_arr, msa)


def test_train_batch_carries_the_dataset_keys_shapes_and_dtypes():
    """The port's ``train_batch`` against the JAX package's dataset batch:
    every key the train step reads, with equal shapes and dtypes; votes
    point at their box's centre; ``lang_label`` is ``[1] ++ lang_ids``;
    the relation labels are those of the boxes."""
    cfg = _flagship_cfg(tiny=True)
    want, _, _ = synthetic_batch(cfg, batch_size=2, seed=0, vocab_size=cfg.vocab_size)
    got = train_batch(cfg, 2, seed=0)
    assert sorted(got) == sorted(TRAIN_KEYS)
    for k in TRAIN_KEYS:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (
            k, got[k].shape, want[k].shape, got[k].dtype, want[k].dtype)
    assert (got["lang_label"][:, 0] == 1).all()
    np.testing.assert_array_equal(got["lang_label"][:, 1:], got["lang_ids"])
    assert (got["lang_ids"][:, 0] == SOS_ID).all() and got["lang_ids"].max() < cfg.vocab_size
    mask = got["vote_label_mask"].astype(bool)
    assert 0 < mask.mean() < 1
    target = got["point_clouds"][..., :3] + got["vote_label"][..., :3]
    centres = got["center_label"][got["box_label_mask_int"].astype(bool)]
    assert np.abs(target[mask][:, None] - centres[None]).max(-1).min(-1).max() < 0.05
    for b in range(2):
        n = int(got["box_label_mask_int"][b].sum())
        boxes = np.concatenate([got["center_label"][b, :n],
                                got["size_residual_label"][b, :n]
                                + mean_size_arr()[got["size_class_label"][b, :n]]], 1)
        rel = generate_relation_labels(boxes)
        for ax in "xyz":
            np.testing.assert_array_equal(got[f"{ax}_label"][b, :n, :n], rel[ax])


def test_train_step_refuses_cuda_when_absent():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = torch_cfg(_flagship_cfg(tiny=True))
    model = SpaCapNet(cfg)
    opt, _ = make_optimizer(model, TrainConfig(), steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, TrainConfig(), opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, TrainConfig(), opt, device="cuda")

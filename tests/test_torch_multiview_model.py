"""The multiview + normal input width (``DataConfig(use_multiview=True,
use_normal=True)`` with height: 128 + 3 + 1 = 132 feature channels) through
the port's ``make_eval_step`` and ``make_train_step`` against the JAX
package's on the CPU: the tiny config, JAX weights carried across with
``params_from_jax``, the same batch. The tolerances are those of
``tests/test_torch_eval_step.py`` (f32 decode: index outputs equal, floats
within 5e-4) and ``tests/test_torch_train_step.py`` (dropout 0: metrics
within rtol 1e-4, BN state within 1e-5, each gradient leaf within 1e-3 of
its largest entry)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from spacap3d_tpu.config import DataConfig as JaxDataConfig
from spacap3d_tpu.config import TrainConfig as JaxTrainConfig
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu.data.synthetic import synthetic_batch
from spacap3d_tpu.models import init_spacap as jax_init_spacap
from spacap3d_tpu.models.spacap import apply_spacap
from spacap3d_tpu.train.losses import get_scene_cap_loss as jax_scene_cap_loss
from spacap3d_tpu.train.step import init_train_state
from spacap3d_tpu.train.step import make_eval_step as jax_make_eval_step
from spacap3d_tpu.train.step import make_optimizer as jax_make_optimizer
from spacap3d_tpu.train.step import make_train_step as jax_make_train_step
from spacap3d_tpu.utils.convert import convert_state_dict
from spacap3d_tpu_torch.config import DataConfig, TrainConfig
from spacap3d_tpu_torch.train.step import (
    METRIC_KEYS,
    TRAIN_KEYS,
    make_eval_step,
    make_optimizer,
    make_train_step,
    to_device_batch,
)
from spacap3d_tpu_torch.utils.convert import params_from_jax
from test_torch_eval_step import assert_outputs_match
from test_torch_train_step import (
    CPU,
    GRAD_FLOOR,
    GRAD_SHARE,
    LOSS_RTOL,
    leaves,
    port_model,
    to_np,
    torch_cfg,
)

MULTIVIEW = DataConfig(use_multiview=True, use_normal=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def multiview_clouds(point_clouds, seed):
    """(B, N, 3 + 1) xyz + height -> (B, N, 3 + 132): xyz, unit normals,
    128 multiview channels (seeded, ENet-like: most near 0, some large),
    height, in the dataset's order."""
    rng = np.random.RandomState(seed)
    b, n, _ = point_clouds.shape
    normals = rng.normal(0, 1, (b, n, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    mv = np.maximum(rng.normal(0, 1, (b, n, 128)), 0) * rng.uniform(0, 3, (b, n, 1))
    return np.concatenate([point_clouds[..., :3], normals, mv, point_clouds[..., 3:]],
                          -1).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    assert MULTIVIEW.input_feature_dim == JaxDataConfig(
        use_multiview=True, use_normal=True).input_feature_dim == 132
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), transformer_dropout=0.0,
                              input_feature_dim=MULTIVIEW.input_feature_dim)
    params, state = jax_init_spacap(jax.random.PRNGKey(0), cfg,
                                    ScannetDatasetConfig().mean_size_arr)
    sd = params_from_jax(to_np(params), to_np(state))
    batch, _, _ = synthetic_batch(cfg, batch_size=2, seed=3, vocab_size=cfg.vocab_size)
    batch = {k: batch[k] for k in TRAIN_KEYS}
    batch["point_clouds"] = multiview_clouds(batch["point_clouds"], seed=5)
    assert batch["point_clouds"].shape[-1] == 3 + 132
    return dict(cfg=cfg, params=params, state=state, sd=sd, batch=batch)


def test_multiview_eval_step_matches_jax(setup):
    cfg = dataclasses.replace(setup["cfg"], eval_decode_dtype="float32")
    batch = {k: setup["batch"][k] for k in ("point_clouds", "center_label")}
    want = jax_make_eval_step(cfg)(setup["params"], setup["state"],
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(cfg, setup["sd"])
    assert model.backbone_net.sa1.mlp_module.layer0.conv.weight.shape[1] == 3 + 132
    got = make_eval_step(torch_cfg(cfg), device="cpu")(model, batch)
    assert_outputs_match({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()})


def test_multiview_train_step_matches_jax(setup):
    """One step of each package at dropout 0, with the batch's GT centres
    moved onto proposals (as tests/test_torch_train_step.py does) so that
    every loss term sees positives: metrics, new BN state, and the
    gradients of the whole model through ``convert_state_dict``."""
    cfg, params, state = setup["cfg"], setup["params"], setup["state"]
    batch = {k: v.copy() for k, v in setup["batch"].items()}
    with torch.no_grad():
        ep = port_model(cfg, setup["sd"]).train().train_forward(to_device_batch(batch, CPU))
    nobj = batch["box_label_mask_int"].sum(1)
    for b in range(2):
        batch["center_label"][b, :nobj[b]] = ep["aggregated_vote_xyz"][b, :nobj[b]].numpy() + 0.05
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p, s):
        out, new_state = apply_spacap(p, s, cfg, jbatch, is_eval=False, train=True,
                                      rng=jax.random.PRNGKey(0), bn_momentum=0.1)
        out = jax_scene_cap_loss(out, p["mean_size_arr"], cfg.num_heading_bin,
                                 cfg.num_size_cluster, detection=True, caption=True,
                                 use_relation=True)
        return out["loss"], new_state

    (_, want_state), want_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, state)
    jtc = JaxTrainConfig()
    tx = jax_make_optimizer(params, jtc, steps_per_epoch=10)
    _, want = jax_make_train_step(cfg, jtc, tx)(init_train_state(params, state, tx), jbatch,
                                                jax.random.PRNGKey(0), 0.1)

    model = port_model(cfg, setup["sd"])
    opt, _ = make_optimizer(model, TrainConfig(), steps_per_epoch=10)
    got = make_train_step(torch_cfg(cfg), TrainConfig(), opt, device="cpu")(
        model, batch, None, 0.1)
    assert float(got["relation_loss"]) > 0 and float(got["pos_ratio"]) > 0
    assert sorted(got) == sorted(METRIC_KEYS) == sorted(want)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    _, new_state, _ = convert_state_dict(sd, params, state, strict=True)
    got_s, want_s = leaves(new_state), leaves(want_state)
    assert sorted(got_s) == sorted(want_s)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5, err_msg=k)

    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    got_g, _, report = convert_state_dict(grads, params, state, strict=True)
    assert len(report["loaded"]) == len(grads) and not report["skipped"]
    got_g, want_g = leaves(got_g), leaves(want_grads)
    del want_g["['mean_size_arr']"]
    top = max(np.abs(w).max() for w in want_g.values())
    for k, w in want_g.items():
        tol = GRAD_SHARE * max(np.abs(w).max(), GRAD_FLOOR * top)
        np.testing.assert_allclose(got_g[k], w, rtol=0, atol=tol, err_msg=k)
    sa1 = "['backbone_net']['sa1']['mlp_module']['layer0']['conv']['kernel']"
    assert sa1 in want_g and np.abs(got_g[sa1][3:135]).max() > 0   # the 132 channels learn

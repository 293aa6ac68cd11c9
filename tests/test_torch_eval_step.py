"""The port's ``make_eval_step`` against the JAX package's on the CPU: the
same converted weights, the same synthetic batch.

f32 decode: ``lang_cap``, ``bbox_mask``, ``sem_cls``, ``object_assignment``
and ``nonempty_box`` identical; float outputs within 5e-4, the trunk
tolerance of PARITY.md (different matmul summation orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu.data.synthetic import synthetic_batch
from spacap3d_tpu.models import init_spacap as jax_init_spacap
from spacap3d_tpu.train.step import make_eval_step as jax_make_eval_step
from spacap3d_tpu_torch.config import ModelConfig
from spacap3d_tpu_torch.models import SpaCapNet
from spacap3d_tpu_torch.train.step import make_eval_step
from spacap3d_tpu_torch.utils.convert import params_from_jax

FLOAT_TOL = 5e-4
EXACT = ("lang_cap", "bbox_mask", "sem_cls", "object_assignment", "nonempty_box",
         "objectness_label")


@pytest.fixture(scope="module")
def setup():
    cfg = _flagship_cfg(tiny=True)
    params, state = jax_init_spacap(jax.random.PRNGKey(0), cfg,
                                    ScannetDatasetConfig().mean_size_arr)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    batch, _, _ = synthetic_batch(cfg, batch_size=2, seed=7)
    batch = {"point_clouds": batch["point_clouds"], "center_label": batch["center_label"]}
    return cfg, params, state, sd, batch


def run_both(setup, compact=False, batch=None, **overrides):
    cfg, params, state, sd, default_batch = setup
    batch = default_batch if batch is None else batch
    cfg = dataclasses.replace(cfg, **overrides)
    want = jax_make_eval_step(cfg, compact=compact)(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    model = SpaCapNet(ModelConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(sd, strict=True)
    got = make_eval_step(ModelConfig(**dataclasses.asdict(cfg)), device="cpu",
                         compact=compact)(model, batch)
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()}


def assert_outputs_match(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if k in EXACT or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=FLOAT_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("stages", [1, 4])
def test_eval_step_f32_matches_jax(setup, stages, compact):
    got, want = run_both(setup, compact=compact, eval_decode_dtype="float32",
                         eval_decode_stages=stages)
    assert_outputs_match(got, want)
    assert got["lang_cap"].shape == (2, 16, 8)
    if compact:
        assert got["lang_cap"].dtype == np.uint16 and got["bbox_mask"].dtype == bool


def test_eval_step_point_table_mode_matches_jax(setup, rng):
    cfg, _, _, _, batch = setup
    pcs = batch["point_clouds"]
    table = np.concatenate([pcs, pcs[:, ::-1]], axis=1)                  # (2, 2N, C)
    choices = np.stack([rng.permutation(table.shape[1])[:pcs.shape[1]] for _ in range(3)])
    pt_batch = {"point_table": table, "center_table": batch["center_label"],
                "scene_row": np.array([1, 0, 1], np.int32), "pc_choices": choices}
    got, want = run_both(setup, batch=pt_batch, eval_decode_dtype="float32")
    assert_outputs_match(got, want)


def test_eval_step_bf16_runs_and_mostly_agrees(setup):
    """The flagship decode dtype. Token-level agreement with near-tie
    tolerance is pinned by test_torch_models; here the whole step runs in
    bf16 and the detector outputs stay exact."""
    got, want = run_both(setup)
    for k in ("bbox_mask", "sem_cls", "object_assignment", "nonempty_box"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    same_rows = (got["lang_cap"] == want["lang_cap"]).all(-1).mean()
    assert same_rows >= 0.75, same_rows


def test_eval_step_refuses_cuda_when_absent(setup):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(ModelConfig())

"""The port's attention dump and ``eval_visualize`` against the JAX
package's on the CPU.

``make_attn_dump_step`` (the detector in eval mode, then the teacher-forced
captioner over the greedy tokens) against the JAX package's on the same
weights (``params_from_jax``), batch and tokens, with the early guide and
the encoder each on and off: equal shapes, probabilities within 1e-5 (f32
softmax over the trunk's features, which lie within rounding of JAX's).
Through ``eval_cap``: the same ``attn_weights.pkl`` keys, tokens and
proposals, weights within 1e-5. ``eval_visualize``: the same files and
``predictions.json``, ply vertices within 1e-5."""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from spacap3d_tpu.data.loader import DataLoader as JaxDataLoader
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig as JaxDatasetConfig
from spacap3d_tpu.data.synthetic import synthetic_batch
from spacap3d_tpu.eval.eval_helper import eval_cap as jax_eval_cap
from spacap3d_tpu.eval.eval_helper import eval_visualize as jax_eval_visualize
from spacap3d_tpu.eval.eval_helper import organize_annotations as jax_organize
from spacap3d_tpu.models import init_spacap as jax_init_spacap
from spacap3d_tpu.train.step import make_attn_dump_step as jax_make_attn_dump_step
from spacap3d_tpu.train.step import make_eval_step as jax_make_eval_step
from spacap3d_tpu_torch.config import ModelConfig
from spacap3d_tpu_torch.data.loader import DataLoader
from spacap3d_tpu_torch.eval.eval_helper import eval_cap, eval_visualize, organize_annotations
from spacap3d_tpu_torch.models import SpaCapNet
from spacap3d_tpu_torch.train.step import make_attn_dump_step, make_eval_step
from spacap3d_tpu_torch.utils.convert import params_from_jax
from test_torch_mul_eval import MIN_IOU, build_both
from test_torch_solver import one_torch_thread  # noqa: F401  (autouse fixture)

ATTN_TOL = 1e-5
PLY_TOL = 1e-5


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return build_both(str(tmp_path_factory.mktemp("torch_attn_dump")))


@pytest.mark.parametrize("early_guide", [True, False])
@pytest.mark.parametrize("encoder", [True, False])
def test_attn_dump_step_matches_jax(early_guide, encoder):
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), early_guide=early_guide,
                              use_transformer_encoder=encoder, transformer_dropout=0.0)
    params, state = jax_init_spacap(jax.random.PRNGKey(1), cfg,
                                    JaxDatasetConfig().mean_size_arr)
    batch, _, _ = synthetic_batch(cfg, batch_size=2, seed=4, vocab_size=cfg.vocab_size)
    model = SpaCapNet(ModelConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(params_from_jax(to_np(params), to_np(state)))
    # raise the objectness-1 logit by the median margin, so that the
    # encoder's mask holds both kept and masked proposals
    with torch.no_grad():
        scores = model.eval().detect(torch.as_tensor(batch["point_clouds"]))[
            "objectness_scores"].numpy()
    bias = np.asarray(params["proposal"]["conv2"]["bias"]).copy()
    bias[1] += np.median(scores[..., 0] - scores[..., 1])
    params["proposal"]["conv2"]["bias"] = jnp.asarray(bias)
    model.load_state_dict(params_from_jax(to_np(params), to_np(state)))
    tokens = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              (2, cfg.num_proposals, cfg.max_des_len + 1))
    want_enc, want_dec = (np.asarray(a) for a in jax_make_attn_dump_step(cfg)(
        params, state, {"point_clouds": jnp.asarray(batch["point_clouds"])},
        jnp.asarray(tokens, jnp.int32)))

    enc, dec = make_attn_dump_step(device="cpu")(model, batch, tokens.astype(np.int32))
    b, k, t = tokens.shape
    t_dec = t + 1 if early_guide else t
    assert dec.shape == want_dec.shape == (cfg.num_layers, b * k, cfg.num_heads, t_dec, t_dec)
    if encoder:
        assert enc.shape == want_enc.shape == (cfg.num_layers, b, cfg.num_heads, k, k)
        np.testing.assert_allclose(enc.numpy(), want_enc, atol=ATTN_TOL, rtol=0)
        masked = want_enc[0, :, 0, 0, :] < 1e-6       # keys outside the mask
        assert masked.any() and not masked.all()
    else:
        assert enc.numel() == 0 and want_enc.size == 0
    np.testing.assert_allclose(dec.numpy(), want_dec, atol=ATTN_TOL, rtol=0)
    np.testing.assert_allclose(dec.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_eval_cap_attention_dump_matches_jax(both, tmp_path):
    """--save_encoder_attn / --save_decoder_attn through ``eval_cap``."""
    anns, j, p = both
    jax_eval_cap(
        jax_make_eval_step(j["cfg"]), j["params"], j["state"], j["ds"],
        JaxDataLoader(j["ds"], batch_size=3, shuffle=False, seed=3, num_workers=1),
        j["vocab"], j["dc"], anns, min_iou=MIN_IOU,
        attn_dump_step=jax_make_attn_dump_step(j["cfg"]), dump_dir=str(tmp_path / "jax"))
    eval_cap(make_eval_step(p["cfg"], device="cpu"), p["model"], p["ds"],
             DataLoader(p["ds"], batch_size=3, shuffle=False, seed=3, num_workers=1),
             p["vocab"], p["dc"], anns, min_iou=MIN_IOU,
             attn_dump_step=make_attn_dump_step(device="cpu"), dump_dir=str(tmp_path / "port"),
             device="cpu")
    with open(tmp_path / "jax" / "attn_weights.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port" / "attn_weights.pkl", "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want) and got
    for key, entry in want.items():
        assert sorted(got[key]) == sorted(entry)
        assert got[key]["token"] == entry["token"] and got[key]["prop_id"] == entry["prop_id"]
        for name in ("encoder_attn_weights", "decoder_attn_weights"):
            assert got[key][name].shape == entry[name].shape
            np.testing.assert_allclose(got[key][name], entry[name], atol=ATTN_TOL, rtol=0,
                                       err_msg=f"{key} {name}")


def read_plys(root):
    out = {}
    for scene in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, scene))):
            with open(os.path.join(root, scene, name)) as f:
                out[f"{scene}/{name}"] = f.read()
    return out


def ply_vertices(text):
    lines = text.splitlines()
    n = int(next(x for x in lines if x.startswith("element vertex")).split()[-1])
    start = lines.index("end_header") + 1
    return np.array([[float(v) for v in x.split()] for x in lines[start:start + n]])


def test_eval_visualize_matches_jax(both, tmp_path):
    anns, j, p = both
    want = jax_eval_visualize(
        jax_make_eval_step(j["cfg"]), j["params"], j["state"], j["ds"],
        JaxDataLoader(j["ds"], batch_size=2, shuffle=False, seed=3, num_workers=1),
        j["vocab"], jax_organize(anns), j["dc"], str(tmp_path / "jax"), min_iou=MIN_IOU,
        nodryrun=True)
    got = eval_visualize(
        make_eval_step(p["cfg"], device="cpu"), p["model"], p["ds"],
        DataLoader(p["ds"], batch_size=2, shuffle=False, seed=3, num_workers=1),
        p["vocab"], organize_annotations(anns), p["dc"], str(tmp_path / "port"),
        min_iou=MIN_IOU, nodryrun=True, device="cpu")
    assert got == want and any(want.values())
    want_files = read_plys(str(tmp_path / "jax" / "vis"))
    files = read_plys(str(tmp_path / "port" / "vis"))
    assert sorted(files) == sorted(want_files)
    assert sum(f.split("/")[1].startswith("pred-") for f in files) == sum(
        len(c) for c in want.values())
    for name, text in want_files.items():
        if name.endswith(".json"):
            assert files[name] == text, name
            continue
        head = text[:text.index("end_header")]
        assert files[name][:files[name].index("end_header")] == head, name
        np.testing.assert_allclose(ply_vertices(files[name]), ply_vertices(text),
                                   atol=PLY_TOL, rtol=0, err_msg=name)
        if "element face" in head:
            assert files[name].splitlines()[-1] == text.splitlines()[-1]

    # the dry run writes nothing and returns the same candidates
    dry = eval_visualize(
        make_eval_step(p["cfg"], device="cpu"), p["model"], p["ds"],
        DataLoader(p["ds"], batch_size=2, shuffle=False, seed=3, num_workers=1),
        p["vocab"], organize_annotations(anns), p["dc"], str(tmp_path / "dry"),
        min_iou=MIN_IOU, device="cpu")
    assert dry == want and not os.path.exists(tmp_path / "dry")
    assert torch.is_grad_enabled()

"""The PyTorch port's models against the JAX package on the CPU, with the
same weights on both sides (JAX init -> ``params_from_jax``) and the same
numpy inputs.

Tolerances: index outputs (FPS / ball-query / argmax) exactly equal;
float endpoints within 5e-4, the trunk tolerance of PARITY.md, since the
two frameworks sum matmuls in different orders."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu.data.synthetic import synthetic_batch
from spacap3d_tpu.models import core as jcore
from spacap3d_tpu.models import init_spacap as jax_init_spacap
from spacap3d_tpu.models.captioner import _cast_tree, _decode_step, _fuse_qkv, captioner_eval
from spacap3d_tpu.models.spacap import make_forward
from spacap3d_tpu.utils.convert import convert_state_dict
from spacap3d_tpu_torch.config import ModelConfig
from spacap3d_tpu_torch.data.meta import mean_size_arr
from spacap3d_tpu_torch.models import SpaCapNet, init_spacap
from spacap3d_tpu_torch.models.captioner import _DecodeWeights
from spacap3d_tpu_torch.models.core import BatchNorm, dense, ref_layer_norm
from spacap3d_tpu_torch.utils.convert import load_reference_state_dict, params_from_jax

FLOAT_TOL = 5e-4


def torch_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def jax_model(cfg, seed=0):
    params, state = jax_init_spacap(jax.random.PRNGKey(seed), cfg,
                                    ScannetDatasetConfig().mean_size_arr)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return params, state, params_from_jax(to_np(params), to_np(state))


def port_model(cfg, sd):
    model = SpaCapNet(torch_cfg(cfg))
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), eval_decode_dtype="float32")
    params, state, sd = jax_model(cfg)
    batch, _, _ = synthetic_batch(cfg, batch_size=2, seed=3)
    return cfg, params, state, sd, batch["point_clouds"]


def test_core_layers_match_jax(rng):
    x = rng.randn(4, 5, 6).astype(np.float32)
    w = rng.randn(6, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    got = dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    want = jcore.dense({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    p = {"scale": rng.rand(6).astype(np.float32) + 0.5, "bias": rng.randn(6).astype(np.float32)}
    s = {"mean": rng.randn(6).astype(np.float32), "var": rng.rand(6).astype(np.float32) + 0.5}
    bn = BatchNorm(6).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    want, _ = jcore.batch_norm(p, s, jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    want, _ = jcore.batch_norm(p, s, jnp.asarray(x), train=True)
    np.testing.assert_allclose(bn.train()(torch.from_numpy(x), 0.1).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):     # train mode takes the step's momentum
        bn(torch.from_numpy(x))

    got = ref_layer_norm(torch.from_numpy(x), torch.from_numpy(p["scale"]),
                         torch.from_numpy(p["bias"]))
    want = jcore.ref_layer_norm(p, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_detector_endpoints_match_jax(tiny):
    cfg, params, state, sd, pc = tiny
    ep_j, _ = make_forward(cfg, is_eval=True, train=False)(params, state,
                                                           {"point_clouds": jnp.asarray(pc)})
    with torch.no_grad():
        ep_t = port_model(cfg, sd)(torch.from_numpy(pc))
    exact = ["sa1_inds", "sa2_inds", "sa3_inds", "sa4_inds", "fp2_inds",
             "aggregated_vote_inds", "bbox_mask", "sem_cls", "lang_cap"]
    close = ["sa1_xyz", "sa1_features", "sa2_features", "sa4_features", "fp2_features",
             "vote_xyz", "vote_features", "aggregated_vote_features", "objectness_scores",
             "center", "size_residuals", "sem_cls_scores", "bbox_corner"]
    for k in exact:
        np.testing.assert_array_equal(ep_t[k].numpy(), np.asarray(ep_j[k]), err_msg=k)
    for k in close:
        np.testing.assert_allclose(ep_t[k].numpy(), np.asarray(ep_j[k]), atol=FLOAT_TOL,
                                   rtol=0, err_msg=k)


CAPTIONER_VARIANTS = [
    dict(early_guide=True, use_transformer_encoder=True, src_pos_type="xyz"),
    dict(early_guide=False, use_transformer_encoder=True, src_pos_type="xyz"),
    dict(early_guide=True, use_transformer_encoder=True, src_pos_type=None),
    dict(early_guide=True, use_transformer_encoder=True, src_pos_type="loc"),
    dict(early_guide=False, use_transformer_encoder=False, src_pos_type="center"),
]


def _proposals(cfg, rng, b=2):
    k, d = cfg.num_proposals, cfg.d_model
    return {
        "aggregated_vote_features": rng.randn(b, k, d).astype(np.float32),
        "aggregated_vote_xyz": (rng.rand(b, k, 3) * 4).astype(np.float32),
        "center": (rng.rand(b, k, 3) * 4).astype(np.float32),
        "pred_size": (rng.rand(b, k, 3) + 0.3).astype(np.float32),
        "bbox_mask": rng.randint(0, 2, (b, k)).astype(np.int32),
    }


def _decode_both(cfg, rng, seed=1, jit=True):
    """Port and JAX tokens on the same weights and proposals; ``jit=False``
    runs ``captioner_eval`` op by op (``jax.disable_jit``), each op rounding
    to its dtype as the JAX code says."""
    params, state, sd = jax_model(cfg, seed)
    ep = _proposals(cfg, rng)
    run = lambda p, s, e: captioner_eval(p, s, cfg, e)["lang_cap"]  # noqa: E731
    args = (params["caption"], state["caption"], {k: jnp.asarray(v) for k, v in ep.items()})
    if jit:
        want = np.asarray(jax.jit(run)(*args))
    else:
        with jax.disable_jit():
            want = np.asarray(run(*args))
    model = port_model(cfg, sd)
    with torch.no_grad():
        got = model.caption({k: torch.from_numpy(v) for k, v in ep.items()}).numpy()
    return got, want, model, ep


@pytest.mark.parametrize("stages", [1, 4])
@pytest.mark.parametrize("variant", range(len(CAPTIONER_VARIANTS)))
def test_captioner_f32_tokens_match_jax(rng, variant, stages):
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), eval_decode_dtype="float32",
                              eval_decode_stages=stages, **CAPTIONER_VARIANTS[variant])
    got, want, _, _ = _decode_both(cfg, rng)
    assert got.shape == (2, cfg.num_proposals, cfg.max_des_len + 1)
    np.testing.assert_array_equal(got, want)


def _forced_logits(model, ep, tokens):
    """The port's f32 logits at every step when fed ``tokens`` (R, T)."""
    cap = model.caption
    with torch.no_grad():
        obj = cap.object_tokens({k: torch.from_numpy(v) for k, v in ep.items()})
        w, caches, cross_kv, offset = cap.start_decode(obj)
        prev = torch.full((obj.shape[0],), 2, dtype=torch.long)      # SOS
        out = []
        for i in range(tokens.shape[1]):
            out.append(cap.next_logits(w, prev, i, caches, offset, cross_kv))
            prev = torch.from_numpy(tokens[:, i].copy()).long()
    return torch.stack(out, 1).numpy()


def assert_tokens_match_or_tie(got, want, model, ep):
    """At most a quarter of the rows differ, and on each of them the two
    candidates' f32 logits at the first differing step are within bf16
    rounding of each other."""
    r = got.shape[0] * got.shape[1]
    got, want = got.reshape(r, -1), want.reshape(r, -1)
    differ = (got != want).any(1)
    rows = np.nonzero(differ)[0]
    assert len(rows) <= r // 4, f"{len(rows)} of {r} rows differ"
    logits = _forced_logits(model, ep, want)
    np.testing.assert_array_equal(logits.argmax(-1)[~differ], got[~differ])
    for row in rows:
        t = int(np.argmax(got[row] != want[row]))
        l_j, l_t = logits[row, t, want[row, t]], logits[row, t, got[row, t]]
        assert abs(l_j - l_t) <= 2 ** -7 * max(abs(l_j), 1.0), (row, t, l_j, l_t)


def test_captioner_bf16_tokens_match_jax_or_tie(rng):
    """bf16 decode against the jitted JAX decode: tokens equal the JAX
    tokens, or tie within bf16 rounding (``assert_tokens_match_or_tie``).
    Under jit, XLA keeps excess precision in its fusions: the layer norm
    after each residual add reads the f32 sum before its bf16 rounding,
    which the JAX code and the port both round. The two tests below show
    that this is the only difference."""
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), eval_decode_dtype="bfloat16")
    got, want, model, ep = _decode_both(cfg, rng)
    assert_tokens_match_or_tie(got, want, model, ep)


@pytest.mark.parametrize("stages", [1, 4])
@pytest.mark.parametrize("variant", range(len(CAPTIONER_VARIANTS)))
def test_captioner_bf16_tokens_equal_jax_op_by_op(rng, variant, stages):
    """bf16 decode against captioner_eval run op by op: equal tokens. Each
    bf16 op rounds, the embedding's multiply and add included."""
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), eval_decode_dtype="bfloat16",
                              eval_decode_stages=stages, **CAPTIONER_VARIANTS[variant])
    got, want, _, _ = _decode_both(cfg, rng, jit=False)
    np.testing.assert_array_equal(got, want)


def test_bf16_decode_step_differs_from_jit_only_by_fusion():
    """One bf16 decode step, the same bf16 input and caches on both sides.
    Op by op, JAX and the port differ only in the last f32 bits (dot
    summation order; the first op whose bits differ is the fused qkv
    projection). Under jit they differ by bf16 steps, because XLA's fusion
    feeds each layer norm the f32 sum of its residual add before the bf16
    rounding that the JAX code and the port apply."""
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), eval_decode_dtype="bfloat16")
    params, _, sd = jax_model(cfg, 1)
    cap = port_model(cfg, sd).caption
    rng = np.random.RandomState(1)
    r, h, pos = 32, cfg.num_heads, 3
    dk, lmax = cfg.d_model // h, cfg.max_des_len + 3
    x = jnp.asarray(rng.randn(r, 1, cfg.d_model), jnp.bfloat16)
    caches = [tuple(jnp.asarray(np.where(np.arange(lmax)[:, None] < pos,
                                         rng.randn(r, h, lmax, dk), 0.0), jnp.bfloat16)
                    for _ in range(2)) for _ in range(cfg.num_layers)]
    dec = {"decoder": _cast_tree(params["caption"]["model"]["decoder"], jnp.bfloat16)}
    qkv = [_fuse_qkv(layer) for layer in dec["decoder"]["layers"]]

    def jax_step(x, c):
        return _decode_step(dec, cfg, x, c, jnp.int32(pos), None, qkv, dd=jnp.bfloat16)[0]

    with jax.disable_jit():
        op_by_op = np.asarray(jax_step(x, caches))
    fused = np.asarray(jax.jit(jax_step)(x, caches))
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)  # noqa: E731
    w = _DecodeWeights(cap.model, cap.cfg, torch.bfloat16)
    with torch.no_grad():
        got = cap._decode_step(w, to_t(x), [(to_t(k), to_t(v)) for k, v in caches], pos,
                               None).numpy()
    np.testing.assert_allclose(got, op_by_op, rtol=0, atol=1e-5)
    assert np.abs(got - fused).max() > 1e-3


def test_captioner_bf16_tokens_equal_jax_without_excess_precision():
    """With ``--xla_allow_excess_precision=false`` the jitted JAX decode
    rounds where its code says, and the port's bf16 tokens equal it."""
    code = (
        "import dataclasses, jax, numpy as np\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_default_matmul_precision', 'highest')\n"
        "from __graft_entry__ import _flagship_cfg\n"
        "import test_torch_models as t\n"
        "cfg = dataclasses.replace(_flagship_cfg(tiny=True), eval_decode_dtype='bfloat16')\n"
        "for seed in (0, 1, 4):\n"
        "    got, want, _, _ = t._decode_both(cfg, np.random.RandomState(seed), seed=seed)\n"
        "    np.testing.assert_array_equal(got, want)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([root, os.path.join(root, "tests")]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=root)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]


def test_early_exit_fills_eos_after_all_rows_ended(rng):
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), eval_decode_dtype="float32",
                              eval_decode_stages=4, eval_decode_early_exit=True)
    params, state, sd = jax_model(cfg, 2)
    model = port_model(cfg, sd)
    with torch.no_grad():   # make EOS the arg max everywhere
        model.caption.model.generator.proj.bias[3] = 1e4
    ep = _proposals(cfg, rng)
    with torch.no_grad():
        got = model.caption({k: torch.from_numpy(v) for k, v in ep.items()}).numpy()
    np.testing.assert_array_equal(got, 3)


def test_params_round_trip_through_jax_converter(tiny):
    cfg, params, state, sd, _ = tiny
    p2, s2, report = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                        params, state, strict=True)
    assert not report["skipped"]
    for a, b in ((p2, params), (s2, state)):
        flat_a, tree_a = jax.tree_util.tree_flatten(a)
        flat_b, tree_b = jax.tree_util.tree_flatten(b)
        assert tree_a == tree_b
        for x, y in zip(flat_a, flat_b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # every leaf of the port's own tree is covered, with the same shapes
    own = SpaCapNet(torch_cfg(cfg)).state_dict()
    assert set(own) == set(sd)
    assert all(own[k].shape == sd[k].shape for k in own)


def test_reference_checkpoint_keys_load(tiny):
    """A reference checkpoint also carries PE buffers and, in early-guide
    decoder layers, cross-attention weights it never runs."""
    cfg, _, _, sd, _ = tiny
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.caption.model.tgt_embed.1.pe"] = torch.zeros(1, 40, cfg.d_model)
    ref["module.caption.model.decoder.layers.0.src_attn.linears.0.weight"] = torch.zeros(2, 2)
    ref["module.caption.model.decoder.layers.1.sublayer.1.norm.a_2"] = torch.zeros(2)
    model = SpaCapNet(torch_cfg(cfg))
    load_reference_state_dict(model, ref)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())


def test_seeded_init_is_deterministic_and_keeps_init_families():
    cfg = torch_cfg(_flagship_cfg(tiny=True))
    a = init_spacap(cfg, seed=5, device="cpu").state_dict()
    b = init_spacap(cfg, seed=5, device="cpu").state_dict()
    c = init_spacap(cfg, seed=6, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vgen.conv1.weight"], c["vgen.conv1.weight"])
    w = a["backbone_net.sa2.mlp_module.layer1.conv.weight"]          # kaiming normal
    assert abs(float(w.std()) - np.sqrt(2.0 / w.shape[1])) < 0.1 * np.sqrt(2.0 / w.shape[1])
    lut = a["caption.model.tgt_embed.0.lut.weight"]                  # xavier uniform
    assert float(lut.abs().max()) <= np.sqrt(6.0 / sum(lut.shape))
    assert torch.equal(a["backbone_net.sa1.mlp_module.layer0.bn.bn.running_var"],
                       torch.ones_like(a["backbone_net.sa1.mlp_module.layer0.bn.bn.running_var"]))
    np.testing.assert_array_equal(mean_size_arr(), ScannetDatasetConfig().mean_size_arr)


def test_entry_points_refuse_cuda_when_absent():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_spacap(torch_cfg(_flagship_cfg(tiny=True)))

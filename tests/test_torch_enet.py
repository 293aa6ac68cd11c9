"""The port's ENet (``spacap3d_tpu_torch/models/enet.py``) against the JAX
package's ``enet_for_3d`` on the CPU: the same seeded JAX weights carried
across with ``enet_params_from_jax``, the same numpy frames.

Features and logits within 1e-4 of the output's largest magnitude (f32; the
two sides sum the convolutions in other orders). The port's state dict is
read back by the JAX package's own reference-key decoder
(``spacap3d_tpu/utils/convert_enet.py::convert_enet_state_dict``)."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacap3d_tpu.models.enet import enet_for_3d
from spacap3d_tpu.models.enet import enet_param_labels as jax_param_labels
from spacap3d_tpu.models.enet import init_enet as jax_init_enet
from spacap3d_tpu.utils.convert_enet import convert_enet_state_dict
from spacap3d_tpu_torch.models.enet import ENet, ExtDropout, enet_param_labels, init_enet
from spacap3d_tpu_torch.utils.convert_enet import (
    _jax_path,
    enet_from_state_dict,
    enet_params_from_jax,
    load_enet,
)

REL_TOL = 1e-4
FRAMES = (2, 64, 80)      # B, H, W


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_weights(seed):
    """Seeded JAX ENet weights with BN scales, biases and running stats moved
    off their initial values, so that every BN leaf is exercised."""
    params, state = to_np(jax_init_enet(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(100 + seed)

    def bn(p, s):
        for k in list(p):
            if k.endswith("_bn"):
                n = p[k]["scale"].shape
                p[k] = {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
                        "bias": rng.normal(0, 0.05, n).astype(np.float32)}
                s[k] = {"mean": rng.normal(0, 0.05, n).astype(np.float32),
                        "var": rng.uniform(0.8, 1.2, n).astype(np.float32)}
            elif isinstance(p[k], dict) and k in s:
                bn(p[k], s[k])

    bn(params, state)
    return params, state


def frames(seed):
    return np.random.RandomState(seed).rand(*FRAMES, 3).astype(np.float32)


def port_forward(model, img, gen=None):
    with torch.no_grad():
        f, lg = model(torch.from_numpy(img).permute(0, 3, 1, 2), gen)
    return f.permute(0, 2, 3, 1).numpy(), lg.permute(0, 2, 3, 1).numpy()


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_state_dict_round_trips_through_the_jax_decoder():
    """Reference keys: the JAX decoder maps every key of the port's state
    dict (strict, nothing skipped) and writes every JAX leaf (each starts as
    NaN) with the value it came from; torch's BN loader supplies
    ``num_batches_tracked``."""
    params, state = jax_weights(1)
    sd = enet_params_from_jax(params, state)
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    model = enet_from_state_dict(sd, "cpu")
    full = {k: v.numpy() for k, v in model.state_dict().items()}
    assert all(int(v) == 0 for k, v in full.items() if k.endswith("num_batches_tracked"))
    tops = {int(k.split(".")[0]) for k in full}
    assert tops == {0, 2, 3, *range(4, 27)}
    assert full["12.0.0.3.weight"].shape == (32, 32, 1, 5)            # s2_b3: 1x5, no bias
    assert "12.0.0.3.bias" not in full and full["12.0.0.4.bias"].shape == (32,)
    assert full["9.0.0.0.weight"].shape == (32, 64, 2, 2)             # s2_down: 2x2/s2
    assert full["26.0.weight"].shape == (41, 128, 1, 1) and "26.0.bias" not in full

    nan_p, nan_s = (jax.tree_util.tree_map(lambda v: np.full_like(v, np.nan), t)
                    for t in to_np(jax_init_enet(jax.random.PRNGKey(2))))
    got_p, got_s, report = convert_enet_state_dict(full, nan_p, nan_s, strict=True)
    assert len(report["loaded"]) == sum(not k.endswith("num_batches_tracked") for k in full)
    assert not report["skipped"]
    for got, want in ((got_p, params), (got_s, state)):
        got, want = leaves(got), leaves(want)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_features_and_logits_match_jax(seed):
    params, state = jax_weights(seed)
    img = frames(10 + seed)
    want_f, want_l, _ = jax.jit(enet_for_3d)(params, state, jnp.asarray(img))
    want_f, want_l = np.asarray(want_f), np.asarray(want_l)
    got_f, got_l = port_forward(enet_from_state_dict(enet_params_from_jax(params, state), "cpu"),
                                img)
    assert got_f.shape == (2, 8, 10, 128) and got_l.shape == (2, 8, 10, 41)
    assert rel_err(got_f, want_f) <= REL_TOL, rel_err(got_f, want_f)
    assert rel_err(got_l, want_l) <= REL_TOL, rel_err(got_l, want_l)


def test_train_mode_batch_norm_matches_jax():
    """Train mode without a generator: batch statistics in every BN, the
    dropouts scaled by (1 - p), and the running stats moved at momentum 0.1
    with the unbiased variance, as JAX's ``train=True, rngs=None``."""
    params, state = jax_weights(0)
    img = frames(20)
    want_f, want_l, new_state = jax.jit(
        lambda p, s, x: enet_for_3d(p, s, x, train=True))(params, state, jnp.asarray(img))
    model = enet_from_state_dict(enet_params_from_jax(params, state), "cpu").train()
    got_f, got_l = port_forward(model, img)
    assert rel_err(got_f, np.asarray(want_f)) <= REL_TOL
    assert rel_err(got_l, np.asarray(want_l)) <= REL_TOL
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert all(int(v) == 1 for k, v in sd.items() if k.endswith("num_batches_tracked"))
    _, got_s, _ = convert_enet_state_dict(sd, params, state, strict=True)
    got, want, old = leaves(got_s), leaves(to_np(new_state)), leaves(state)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
        assert not np.array_equal(w, old[k]), k


def test_eval_dropout_scaling_is_load_bearing():
    """The reference's dropout scales the extension branch by (1 - p) in eval
    mode; without the factor the port leaves the JAX features by far more
    than the tolerance (as tests/test_enet_reference_parity.py checks the
    JAX ENet against the reference)."""
    params, state = jax_weights(0)
    img = frames(30)[:1, :16, :16]
    want, _, _ = enet_for_3d(params, state, jnp.asarray(img))
    model = enet_from_state_dict(enet_params_from_jax(params, state), "cpu")
    assert rel_err(port_forward(model, img)[0], np.asarray(want)) <= REL_TOL
    drops = [m for m in model.modules() if isinstance(m, ExtDropout)]
    assert sorted({m.p for m in drops}) == [0.01, 0.1] and len(drops) == 22
    for m in drops:
        m.p = 0.0
    assert rel_err(port_forward(model, img)[0], np.asarray(want)) > 1e-2


@pytest.mark.parametrize("p", [0.01, 0.1])
def test_train_dropout_zeroes_whole_channels_without_rescaling(p):
    drop = ExtDropout(p).train()
    x = torch.randn(64, 128, 3, 5, generator=torch.Generator().manual_seed(0)) + 5.0
    y = drop(x, torch.Generator().manual_seed(7))
    zero = (y == 0).all(3).all(2)
    kept = (y == x).all(3).all(2)
    assert bool((zero ^ kept).all())                 # each channel all zero or untouched
    share = float(zero.float().mean())
    assert abs(share - p) < 5 * np.sqrt(p * (1 - p) / zero.numel()), share
    assert torch.equal(drop(x, torch.Generator().manual_seed(7)), y)
    assert torch.equal(drop(x), x * (1 - p))          # no generator: the eval scaling
    assert torch.equal(drop.eval()(x, torch.Generator().manual_seed(7)), x * (1 - p))


def test_train_dropout_runs_through_the_model():
    model = init_enet(seed=3, device="cpu").train()
    img = frames(40)
    gen = torch.Generator().manual_seed(5)
    a = port_forward(model, img, gen)[0]
    b = port_forward(model, img, torch.Generator().manual_seed(5))[0]
    c = port_forward(model, img)[0]
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_frozen_and_trainable_split_matches_jax():
    params, state = jax_weights(0)
    want = jax_param_labels(params)
    model = enet_from_state_dict(enet_params_from_jax(params, state), "cpu")
    got = enet_param_labels(model)
    assert sorted(got) == sorted(n for n, _ in model.named_parameters())
    for name, label in got.items():
        assert label == want[_jax_path(name)[1][0]], name
    trainable = {n.split(".")[0] for n, v in got.items() if v == "trainable"}
    assert trainable == {str(i) for i in range(18, 27)}


def test_load_enet_reads_pth_and_numpy_pickles(tmp_path):
    params, state = jax_weights(1)
    ref = enet_from_state_dict(enet_params_from_jax(params, state), "cpu").state_dict()
    pth = str(tmp_path / "enet.pth")
    torch.save({f"module.{k}": v for k, v in ref.items()}, pth)
    pkl = str(tmp_path / "enet.pkl")
    bias = np.arange(41, dtype=np.float32)
    with open(pkl, "wb") as f:
        pickle.dump({"params": {**params, "classifier": {**params["classifier"],
                                                         "bias": bias}},
                     "state": state}, f)
    from_pth = load_enet(pth, device="cpu").state_dict()
    from_pkl = load_enet(pkl, device="cpu").state_dict()
    assert sorted(from_pth) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(from_pth[k], v) and torch.equal(from_pkl[k], v), k
    np.testing.assert_array_equal(from_pkl["26.0.bias"].numpy(), bias)
    default, seeded = load_enet("", device="cpu").state_dict(), init_enet(device="cpu").state_dict()
    assert all(torch.equal(v, seeded[k]) for k, v in default.items())


def test_load_enet_refuses_a_pickle_of_jax_arrays(tmp_path):
    """A pickle of ``jax.Array``s, as the JAX package writes one, loads
    through ``utils/jax_checkpoint.py`` (no JAX import) into the weights
    of the same trees as numpy; a pickle that names any other global is
    still refused."""
    params, state = jax_init_enet(jax.random.PRNGKey(0))
    path = str(tmp_path / "jax_arrays.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": params, "state": state}, f)
    got = load_enet(path, device="cpu").state_dict()
    want = enet_from_state_dict(enet_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state)), "cpu").state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    other = str(tmp_path / "other.pkl")
    with open(other, "wb") as f:
        pickle.dump({"params": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing posix.getcwd"):
        load_enet(other, device="cpu")


def test_init_enet_refuses_cuda_when_absent():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_enet()
    assert isinstance(init_enet(device="cpu"), ENet)

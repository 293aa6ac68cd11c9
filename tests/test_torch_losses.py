"""The port's losses and the train path's two custom backwards against the
JAX package on the CPU, with the same numpy inputs.

Tolerances, per test: index and label outputs exactly equal; loss values
within rtol 1e-4 (the JAX package's own loss tolerance,
tests/test_losses.py); elementwise values and gradients of small ops
within rtol 1e-5, atol 1e-6 (float32 reassociation of a few terms)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacap3d_tpu.data.spatiality import generate_relation_labels as jax_relation_labels
from spacap3d_tpu.models import core as jcore
from spacap3d_tpu.ops.grouping import group_and_localize as jax_group_and_localize
from spacap3d_tpu.ops.nn_distance import huber_loss as jax_huber_loss
from spacap3d_tpu.ops.nn_distance import nn_distance as jax_nn_distance
from spacap3d_tpu.train import losses as jlosses
from spacap3d_tpu_torch.data.spatiality import generate_relation_labels
from spacap3d_tpu_torch.models.core import BatchNorm
from spacap3d_tpu_torch.ops import group_and_localize
from spacap3d_tpu_torch.ops.nn_distance import huber_loss, nn_distance
from spacap3d_tpu_torch.train import losses

LOSS_RTOL = 1e-4


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("mode", ["l2", "l1", "l1smooth"])
def test_nn_distance_modes_and_gradients_match_jax(rng, mode):
    """Distances rtol 1e-5, indices equal (first index on ties), and the
    gradient of a weighted sum of both distances equal within rtol 1e-5,
    atol 1e-6: duplicate points make exact ties, whose gradient JAX's
    ``min`` and the port's ``amin`` split evenly."""
    pc1 = (rng.rand(2, 30, 3) * 3).astype(np.float32)
    pc2 = (rng.rand(2, 11, 3) * 3).astype(np.float32)
    pc2[:, 4] = pc2[:, 1]
    pc1[:, 7] = pc1[:, 2]
    w1, w2 = rng.rand(2, 30).astype(np.float32), rng.rand(2, 11).astype(np.float32)
    kw = {"l1": dict(l1=True), "l1smooth": dict(l1smooth=True, delta=0.5), "l2": {}}[mode]

    def jfun(a, b):
        d1, i1, d2, i2 = jax_nn_distance(a, b, **kw)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2), (d1, i1, d2, i2)

    (_, want), (ga, gb) = jax.value_and_grad(jfun, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pc1), jnp.asarray(pc2))
    a, b = _t(pc1, True), _t(pc2, True)
    got = nn_distance(a, b, **kw)
    ((got[0] * _t(w1)).sum() + (got[2] * _t(w2)).sum()).backward()
    for g, w in zip(got, want):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("delta", [1.0, 0.5])
def test_huber_loss_and_gradient_match_jax(rng, delta):
    """Values and gradients within rtol 1e-6, on both sides of delta."""
    e = (rng.randn(200) * 2).astype(np.float32)
    want, gwant = jax.value_and_grad(lambda x: jnp.sum(jax_huber_loss(x, delta)))(jnp.asarray(e))
    x = _t(e, True)
    got = huber_loss(x, delta)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jax_huber_loss(jnp.asarray(e),
                                                                               delta)), rtol=1e-6)
    np.testing.assert_allclose(float(got.detach().sum()), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gwant), rtol=1e-6)


def test_relation_labels_equal_jax(rng):
    """Every class of the three axes equal, and the dtype: random boxes,
    boxes with equal extents (the symmetric 'same' class) and stacked
    boxes (above / below)."""
    boxes = np.concatenate([rng.uniform(0, 6, (9, 3)), rng.uniform(0.2, 1.5, (9, 3))], 1)
    boxes[3] = boxes[1]
    boxes[5, :2], boxes[5, 3:5] = boxes[2, :2], boxes[2, 3:5]
    boxes[5, 2] = boxes[2, 2] + boxes[2, 5]
    boxes = np.concatenate([boxes, np.arange(9)[:, None]], 1)
    got, want = generate_relation_labels(boxes), jax_relation_labels(boxes)
    assert sorted(got) == sorted(want) == ["x", "y", "z"]
    for ax in "xyz":
        assert got[ax].dtype == want[ax].dtype
        np.testing.assert_array_equal(got[ax], want[ax], err_msg=ax)
        assert set(np.unique(got[ax])) <= {0, 1, 2}


def _endpoints(rng, b=2, k=16, num_seed=32, n=64, nobj=6, t=8, vocab=20, ns=18):
    """Loss inputs: labels as the dataset lays them out (128 GT slots),
    predictions random, with the first proposals near GT centres
    (positives), others far (negatives) or between (masked out)."""
    m = 128
    centers = rng.uniform(0.5, 5.5, (b, nobj, 3))
    center_label = np.zeros((b, m, 3))
    center_label[:, :nobj] = centers
    agg = rng.uniform(0, 6, (b, k, 3))
    agg[:, :nobj] = centers + rng.uniform(-0.12, 0.12, (b, nobj, 3))
    agg[:, nobj:nobj + 2] = centers[:, :2] + 0.45 / np.sqrt(3)
    seed_xyz = rng.uniform(0, 6, (b, num_seed, 3))
    box_mask = np.zeros((b, m))
    box_mask[:, :nobj] = 1
    lang_ids = np.zeros((b, t + 1), np.int64)
    lang_ids[0, :6] = [2, 5, 9, 7, 11, 3]
    lang_ids[1, :9] = [2, 4, 8, 12, 19, 6, 4, 10, 3]
    scores = rng.randn(b, k, 2)
    ep = {
        "seed_xyz": seed_xyz, "seed_inds": rng.randint(0, n, (b, num_seed)).astype(np.int32),
        "vote_xyz": seed_xyz + rng.randn(b, num_seed, 3) * 0.3,
        "vote_label": rng.randn(b, n, 9), "vote_label_mask": rng.randint(0, 2, (b, n)),
        "aggregated_vote_xyz": agg, "center_label": center_label,
        "center": agg + rng.randn(b, k, 3) * 0.1,
        "objectness_scores": scores, "bbox_mask": scores.argmax(-1).astype(np.int32),
        "heading_scores": rng.randn(b, k, 1), "heading_residuals_normalized": rng.randn(b, k, 1),
        "size_scores": rng.randn(b, k, ns), "size_residuals_normalized": rng.randn(b, k, ns, 3),
        "sem_cls_scores": rng.randn(b, k, ns),
        "heading_class_label": np.zeros((b, m), np.int64),
        "heading_residual_label": rng.randn(b, m) * 0.1,
        "size_class_label": rng.randint(0, ns, (b, m)),
        "size_residual_label": rng.randn(b, m, 3) * 0.1,
        "sem_cls_label": rng.randint(0, ns, (b, m)),
        "box_label_mask": box_mask, "box_label_mask_int": box_mask.astype(np.int64),
        "lang_cap": np.log(rng.dirichlet(np.ones(vocab), (b, t))),
        "lang_ids": lang_ids, "good_bbox_masks": np.array([True, False]),
        "pred_ious": np.float32(0.25),
        "relation_pred": rng.randn(b, k, k, 9),
    }
    for ax in "xyz":
        ep[f"{ax}_label"] = rng.randint(0, 3, (b, m, m))
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in ep.items()}


FLOAT_INPUTS = ("vote_xyz", "seed_xyz", "center", "objectness_scores",
                "heading_residuals_normalized", "size_scores", "size_residuals_normalized",
                "sem_cls_scores", "lang_cap", "relation_pred")


def _mean_size(rng):
    return rng.uniform(0.3, 2.0, (18, 3)).astype(np.float32)


@pytest.mark.parametrize("detection,caption,use_relation",
                         list(itertools.product([True, False], repeat=3)))
def test_scene_cap_loss_matches_jax_under_every_flag(rng, detection, caption, use_relation):
    """Every loss scalar and metric within rtol 1e-4 (atol 1e-6 for the
    zeros); objectness label, mask and assignment equal."""
    ep, msa = _endpoints(rng), _mean_size(rng)
    flags = dict(detection=detection, caption=caption, use_relation=use_relation)
    want = jlosses.get_scene_cap_loss({k: jnp.asarray(v) for k, v in ep.items()},
                                      jnp.asarray(msa), 1, 18, **flags)
    got = losses.get_scene_cap_loss({k: _t(v) for k, v in ep.items()}, _t(msa), 1, 18, **flags)
    assert float(want["pos_ratio"]) > 0 and float(want["neg_ratio"]) > 0
    for k in ("objectness_label", "objectness_mask", "object_assignment"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    scalars = [k for k, v in want.items() if np.ndim(v) == 0 and k not in ep]
    assert len(scalars) >= 23
    for k in scalars:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)


def test_each_loss_term_and_its_gradient_match_jax(rng):
    """Each term's value within rtol 1e-4; the total loss's gradient with
    respect to every float endpoint that carries one within rtol 1e-4 of
    its largest entry."""
    ep, msa = _endpoints(rng), _mean_size(rng)
    jep = {k: jnp.asarray(v) for k, v in ep.items()}
    tep = {k: _t(v) for k, v in ep.items()}
    np.testing.assert_allclose(float(losses.compute_vote_loss(tep)),
                               float(jlosses.compute_vote_loss(jep)), rtol=LOSS_RTOL)
    obj_t, obj_j = losses.compute_objectness_loss(tep), jlosses.compute_objectness_loss(jep)
    np.testing.assert_allclose(float(obj_t[0]), float(obj_j[0]), rtol=LOSS_RTOL)
    for k, (g, w) in zip(("objectness_label", "objectness_mask", "object_assignment"),
                         zip(obj_t[1:], obj_j[1:])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        tep[k], jep[k] = g, w
    box_t = losses.compute_box_and_sem_cls_loss(tep, _t(msa), 1, 18)
    box_j = jlosses.compute_box_and_sem_cls_loss(jep, jnp.asarray(msa), 1, 18)
    np.testing.assert_allclose([float(v) for v in box_t], [float(v) for v in box_j],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([float(v) for v in losses.compute_cap_loss(tep)],
                               [float(v) for v in jlosses.compute_cap_loss(jep)], rtol=LOSS_RTOL)
    np.testing.assert_allclose([float(v) for v in losses.compute_relation_loss(tep)],
                               [float(v) for v in jlosses.compute_relation_loss(jep)],
                               rtol=LOSS_RTOL)

    def jtotal(floats):
        return jlosses.get_scene_cap_loss({**jep, **floats}, jnp.asarray(msa), 1, 18,
                                          use_relation=True)["loss"]

    gj = jax.grad(jtotal)({k: jep[k] for k in FLOAT_INPUTS})
    tep = {k: _t(v, k in FLOAT_INPUTS) for k, v in ep.items()}
    losses.get_scene_cap_loss(tep, _t(msa), 1, 18, use_relation=True)["loss"].backward()
    for k in FLOAT_INPUTS:
        w = np.asarray(gj[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(tep[k].grad.numpy(), w, rtol=0,
                                   atol=LOSS_RTOL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("shape", [(2, 5, 7, 6), (40, 6)])
def test_train_batch_norm_matches_jax(rng, shape):
    """Train-mode BN against ``core.batch_norm(train=True)``: the output and
    the new running stats (momentum 0.3) within rtol 1e-5, atol 1e-6; the
    gradients of x, scale and bias against ``jax.vjp`` of the custom VJP
    within rtol 1e-5, atol 1e-6."""
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    p = {"scale": rng.rand(c).astype(np.float32) + 0.5, "bias": rng.randn(c).astype(np.float32)}
    s = {"mean": rng.randn(c).astype(np.float32), "var": rng.rand(c).astype(np.float32) + 0.5}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jax.tree_util.tree_map(jnp.asarray, s)
    (want, new_s), vjp = jax.vjp(lambda pp, xx: jcore.batch_norm(pp, js, xx, True, 0.3),
                                 jp, jnp.asarray(x))
    gp, gx = vjp((jnp.asarray(dy), jax.tree_util.tree_map(jnp.zeros_like, new_s)))

    bn = BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(_t(p["scale"]))
        bn.bias.copy_(_t(p["bias"]))
        bn.running_mean.copy_(_t(s["mean"]))
        bn.running_var.copy_(_t(s["var"]))
    xt = _t(x, True)
    got = bn(xt, 0.3)
    got.backward(_t(dy))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_s["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_s["var"]), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), **tol)


@pytest.mark.parametrize("radius", [0.4, None])
def test_group_and_localize_backward_matches_jax(rng, radius):
    """The backward against the JAX custom VJP: d_cat (a scatter-add over
    repeated indices, as ball query pads with the first neighbour) and
    d_new_xyz within rtol 1e-5, atol 1e-6; the forward bit-equal."""
    cat = rng.randn(2, 64, 8).astype(np.float32)
    idx = rng.randint(0, 64, (2, 16, 8)).astype(np.int32)
    idx[:, :, 5:] = idx[:, :, :1]
    centers = rng.randn(2, 16, 3).astype(np.float32)
    g = rng.randn(2, 16, 8, 8).astype(np.float32)
    want, vjp = jax.vjp(lambda c, n: jax_group_and_localize(c, jnp.asarray(idx), n, radius),
                        jnp.asarray(cat), jnp.asarray(centers))
    d_cat, d_new = vjp(jnp.asarray(g))
    ct, nt = _t(cat, True), _t(centers, True)
    got = group_and_localize(ct, _t(idx), nt, radius)
    got.backward(_t(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(d_cat), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nt.grad.numpy(), np.asarray(d_new), rtol=1e-5, atol=1e-6)

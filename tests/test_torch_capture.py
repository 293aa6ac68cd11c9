"""The captured eval step (``train/capture.py``, ``train/step.py``) on the
CPU, where no CUDA graph can be made: which steps capture, the graph key,
the static inputs, and the replays through a stand-in backend whose graph
reruns the captured part (``Rerun``). The staged greedy decode
(``Captioner.decode_segments``) against the JAX package's
``captioner_eval``, and the eval step with the decode's early exit against
the JAX package's eval step: f32 tokens equal, with the early exit on and
off, its stage ends equal to the JAX package's ``bounds``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from spacap3d_tpu.data.synthetic import synthetic_batch
from spacap3d_tpu.models import captioner as jax_captioner
from spacap3d_tpu.models.captioner import captioner_eval
from spacap3d_tpu_torch.config import EOS_ID, ModelConfig
from spacap3d_tpu_torch.models import SpaCapNet, init_spacap
from spacap3d_tpu_torch.models.captioner import decode_plan
from spacap3d_tpu_torch.ops.ball_query import ball_query
from spacap3d_tpu_torch.ops.boxes import _CORNER_SIGNS, corner_signs
from spacap3d_tpu_torch.ops.decode import ffn, ffn_partial, generator_argmax
from spacap3d_tpu_torch.ops.fps import furthest_point_sample
from spacap3d_tpu_torch.train import capture
from spacap3d_tpu_torch.train import step as step_module
from spacap3d_tpu_torch.train.step import captured, eval_segments, make_eval_step, to_device_batch
from spacap3d_tpu_torch.utils.segments import Segments, run_eager
from test_torch_eval_step import assert_outputs_match, run_both
from test_torch_eval_step import setup as eval_setup  # noqa: F401 (a fixture)
from test_torch_models import _proposals, jax_model, port_model

CPU, CUDA = torch.device("cpu"), torch.device("cuda")
# the JAX package's EOS logit raised by this much: on seed 1's weights and
# proposals every row emits EOS by step 6 of 8, at different steps, and some
# rows emit other tokens after it, so that the early exit changes tokens
EOS_BIAS = 2.5
# the kernel wrappers, each counting its launches in ``launches``
COUNTED = (furthest_point_sample, ball_query, generator_argmax, ffn, ffn_partial)


def launch_counts():
    return tuple(f.launches for f in COUNTED)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RerunGraph:
    def __init__(self, fn, static):
        self.fn, self.static = fn, static

    def replay(self):
        """A graph replay runs no Python: the launch counters stay put, and
        the results land in the captured tensors."""
        counts = launch_counts()
        copy_into(self.static, self.fn())
        for f, n in zip(COUNTED, counts):
            f.launches = n


def copy_into(static, new):
    if isinstance(static, dict):
        for k in static:
            copy_into(static[k], new[k])
    elif static is not None:
        static.copy_(new)


class Rerun:
    """Stand-in for ``capture.CudaGraphs`` on the CPU: the warm-up runs the
    function; a capture runs the part once (its results are the static
    tensors) and its graph reruns the part on replay, drawing from the
    generators a real capture registers (the carry's)."""

    def __init__(self, device, keep_graphs=False):
        pass

    def warm_up(self, fn):
        return fn()

    def capture(self, fn, generators=()):
        static = fn()
        return RerunGraph(fn, static), static


def tiny_cfg(**kw):
    return ModelConfig(**dataclasses.asdict(dataclasses.replace(
        _flagship_cfg(tiny=True), eval_decode_dtype="float32", **kw)))


def cpu_batch(cfg, seed, b=2):
    batch, _, _ = synthetic_batch(cfg, batch_size=b, seed=seed)
    return to_device_batch({k: batch[k] for k in ("point_clouds", "center_label")}, CPU)


def test_capture_resolves_by_device_and_tensor_parallelism(monkeypatch):
    """A TP model's eval step captures on CUDA where its groups are NCCL (a
    stubbed backend) and runs eagerly over gloo, as with ``capture=False``
    and on the CPU."""
    model = SpaCapNet(tiny_cfg())
    assert captured(True, CUDA) and captured(True, CUDA, model)
    assert not captured(True, CPU, model) and not captured(False, CUDA, model)
    assert make_eval_step(tiny_cfg(), device="cpu").program is None
    assert make_eval_step(tiny_cfg(), device="cpu", capture=False).program is None
    model.caption.tp_group = object()       # as parallel/tp.py::shard_model sets it
    for backend, want in (("gloo", False), ("nccl", True)):
        monkeypatch.setattr(step_module, "group_backend", lambda g, backend=backend: backend)
        assert captured(True, CUDA, model) == want and not captured(False, CUDA, model)
        assert not captured(True, CPU, model)


def test_graph_key_follows_replaced_weights_not_in_place_updates():
    model = init_spacap(tiny_cfg(), seed=0, device="cpu")
    inputs = cpu_batch(model.cfg, 1)
    inputs["point_table"] = torch.zeros(3, 5, 4)
    key = capture.graph_key(model, inputs, ("point_table",))
    with torch.no_grad():
        model.proposal.proposal[6].bias.copy_(torch.randn_like(model.proposal.proposal[6].bias))
        model.backbone_net.sa1.mlp_module.layer0.bn.bn.running_mean.add_(1.0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert capture.graph_key(model, inputs, ("point_table",)) == key
    table = dict(inputs, point_table=torch.zeros(3, 5, 4))
    assert capture.graph_key(model, table, ("point_table",)).addresses != key.addresses
    half = dict(inputs, point_clouds=inputs["point_clouds"].half())
    assert capture.graph_key(model, half, ("point_table",)).static != key.static
    lin = model.caption.model.generator.proj
    lin.bias = torch.nn.Parameter(lin.bias.detach().clone())
    new = capture.graph_key(model, inputs, ("point_table",))
    assert new.model == key.model and new.weights != key.weights


def test_static_inputs_refuse_another_shape_or_dtype():
    batch = {"x": torch.zeros(2, 3), "table": torch.ones(4)}
    static = capture.StaticInputs(batch, ("table",))
    assert static["x"] is not batch["x"] and static["table"] is batch["table"]
    other = torch.ones(4)
    static.load({"x": torch.full((2, 3), 5.0), "table": other})
    assert torch.equal(static["x"], torch.full((2, 3), 5.0)) and static["table"] is other
    static.release()
    assert "table" not in static
    for bad in ({"x": torch.zeros(1, 3), "table": other},          # copy_ would broadcast
                {"x": torch.zeros(2, 3, dtype=torch.float64), "table": other},
                {"x": torch.zeros(2, 3)}):
        with pytest.raises(ValueError, match="captured inputs"):
            static.load(bad)


def counting_segments(model):
    """Two parts, each launching (as the wrappers count) and the first
    ending in a test; skip writes -1 into the outputs."""
    def first(carry):
        COUNTED[0].launches += 2
        carry["h"] = carry["inputs"]["x"] * 2
        return carry["h"].sum() > 100

    def last(carry):
        COUNTED[3].launches += 1
        return {"y": carry["h"] + 1}

    def skip(carry, k):
        carry["h"].fill_(-2)
    return Segments([first, last], skip)


def test_replays_count_launches_and_return_owned_outputs():
    """The wrappers count where they launch: the first call's warm-up and
    its capture each count, a replay counts nothing. Outputs kept from a
    replay stay as they were through later replays."""
    fn = capture.CapturedFunction(counting_segments, backend=Rerun)
    model = torch.nn.Linear(2, 2)

    def call(x):
        before = launch_counts()
        out = fn(model, {"x": torch.full((3,), float(x))})
        return out, tuple(b - a for a, b in zip(before, launch_counts()))

    out0, got = call(1)                        # the warm-up and the capture launch
    assert fn.last["captured"] and got == (4, 0, 0, 2, 0)
    assert torch.equal(out0["y"], torch.full((3,), 3.0))
    kept = []
    for i in range(2, 12):
        out, got = call(i)
        assert not fn.last["captured"] and fn.last["replayed"] == [0, 1] and got == (0,) * 5
        assert torch.equal(out["y"], torch.full((3,), 2.0 * i + 1))
        kept.append((i, out))
    for i, out in kept:                        # later replays left each kept output alone
        assert torch.equal(out["y"], torch.full((3,), 2.0 * i + 1))
    out, got = call(50)                        # the test is true: skip, then the last part
    assert torch.equal(out["y"], torch.full((3,), -1.0)) and got == (0,) * 5
    assert fn.last["replayed"] == [0, 1] and len(fn.entries) == 1


def test_new_weights_and_tables_drop_old_graphs():
    fn = capture.CapturedFunction(counting_segments, by_address=("t",), backend=Rerun)
    model = torch.nn.Linear(2, 2)
    x = torch.ones(3)
    fn(model, {"x": x, "t": torch.zeros(2)})
    fn(model, {"x": x, "t": torch.zeros(2)})   # a new table
    assert len(fn.entries) == 1
    model.bias = torch.nn.Parameter(model.bias.detach().clone())
    fn(model, {"x": torch.ones(4)})            # replaced weights
    assert len(fn.entries) == 1
    for n in range(5, 6 + capture.MAX_LIVE):    # the least recently used go first
        fn(model, {"x": torch.ones(n)})
    assert [k.static[1][0][1] for k in fn.entries] == [
        (n,) for n in range(6, 6 + capture.MAX_LIVE)]
    fn.clear()
    assert not fn.entries
    fn(model, {"x": torch.ones(5)})            # captures anew
    assert fn.last["captured"] and len(fn.entries) == 1


@pytest.mark.parametrize("kind", ["full", "compact", "early_exit", "point_table"])
def test_rerun_program_equals_the_eager_step(kind):
    """The eval step's segments through the stand-in backend: every output
    equal to the eager step's, on each call and after later calls."""
    cfg = tiny_cfg(eval_decode_stages=4, eval_decode_early_exit=kind == "early_exit")
    model = init_spacap(cfg, seed=1, device="cpu")
    if kind == "early_exit":
        with torch.no_grad():
            model.caption.model.generator.proj.bias[EOS_ID] += 6.0
    compact = kind == "compact"
    fn = capture.CapturedFunction(eval_segments(cfg, compact), backend=Rerun,
                                  by_address=("point_table", "center_table"))
    batches = [cpu_batch(cfg, s) for s in (3, 4, 5)]
    if kind == "point_table":
        table = torch.cat([batches[0]["point_clouds"], batches[1]["point_clouds"]], 1)
        centres = batches[0]["center_label"]
        batches = [{"point_table": table, "center_table": centres,
                    "scene_row": torch.tensor([1, 0], dtype=torch.int32),
                    "pc_choices": torch.from_numpy(np.stack([
                        np.random.RandomState(s + i).permutation(table.shape[1])[
                            :cfg.num_points] for i in range(2)]).astype(np.int32))}
                   for s in (3, 4, 5)]
    model.eval()
    with torch.no_grad():
        want = [run_eager(eval_segments(cfg, compact)(model), b) for b in batches]
        got = [fn(model, b) for b in batches + batches[::-1]]
    assert [fn.last["captured"], len(fn.entries)] == [False, 1]
    if kind == "early_exit":
        assert fn.last["replayed"] == [0, 4]    # the first stage, then the tail
        assert (want[0]["lang_cap"] == EOS_ID).all()
    for g, w in zip(got, want + want[::-1]):
        assert sorted(g) == sorted(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k
    assert not torch.equal(want[0]["objectness_scores"], want[1]["objectness_scores"])


def test_corner_signs_are_the_table():
    assert torch.equal(corner_signs(torch.float32, CPU),
                       torch.tensor(_CORNER_SIGNS, dtype=torch.float32))


def recorded_bounds(monkeypatch):
    """The ends of the JAX decode's scans, as ``captioner_eval`` traces them."""
    ends = []
    real = jax.lax.scan

    def scan(f, init, xs, *a, **kw):
        ends.append(int(xs.shape[0]) + (ends[-1] if ends else 0))
        return real(f, init, xs, *a, **kw)

    class Lax:
        def __getattr__(self, name):
            return scan if name == "scan" else getattr(jax.lax, name)
    monkeypatch.setattr(jax_captioner, "lax", Lax())
    return ends


@pytest.fixture(scope="module")
def decode_setup():
    cfg = dataclasses.replace(_flagship_cfg(tiny=True), eval_decode_dtype="float32")
    params, state, sd = jax_model(cfg, 1)
    bias = np.asarray(params["caption"]["model"]["generator"]["proj"]["bias"]).copy()
    bias[EOS_ID] += np.float32(EOS_BIAS)
    params["caption"]["model"]["generator"]["proj"]["bias"] = jnp.asarray(bias)
    sd["caption.model.generator.proj.bias"] = torch.from_numpy(bias)
    return cfg, params, state, sd, _proposals(cfg, np.random.RandomState(1))


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("stages", [1, 4, 31])
def test_staged_decode_tokens_equal_jax(monkeypatch, decode_setup, stages, early_exit):
    base, params, state, sd, ep = decode_setup
    cfg = dataclasses.replace(base, eval_decode_stages=stages, eval_decode_early_exit=early_exit)
    ends = recorded_bounds(monkeypatch)
    want = np.asarray(jax.jit(lambda p, s, e: captioner_eval(p, s, cfg, e)["lang_cap"])(
        params["caption"], state["caption"], {k: jnp.asarray(v) for k, v in ep.items()}))
    model = port_model(cfg, sd)
    with torch.no_grad():
        got = model.caption({k: torch.from_numpy(v) for k, v in ep.items()}).numpy()
    plan = decode_plan(model.cfg)
    assert [end for _, end in plan] == ends == [round(8 * (s + 1) / min(stages, 8))
                                                for s in range(min(stages, 8))]
    np.testing.assert_array_equal(got, want)
    eos = (want == EOS_ID).reshape(-1, 8)
    # every row emits EOS, and only an early exit ends every row in EOS
    assert eos.any(1).all() and eos[:, -1].all() == (early_exit and stages > 1)


@pytest.mark.parametrize("eos_bias", [0.0, 2.0, 6.0])
def test_eval_step_early_exit_matches_jax(eval_setup, eos_bias):
    """The eval step at 4 stages (ends 2, 4, 6, 8) with the early exit, the
    path the captured step cuts into a graph a stage, against the JAX
    package's eval step on the same weights. With the EOS logit as it is no
    row emits EOS; raised by 2.0, rows emit it first at steps 3 and 6, so
    that the test at the third stage's end skips the last; raised by 6.0,
    every row at step 0, so that the first stage's test skips the rest."""
    cfg, params, state, sd, batch = eval_setup
    params = jax.tree_util.tree_map(lambda x: x, params)
    bias = np.asarray(params["caption"]["model"]["generator"]["proj"]["bias"]).copy()
    bias[EOS_ID] += np.float32(eos_bias)
    params["caption"]["model"]["generator"]["proj"]["bias"] = jnp.asarray(bias)
    sd = dict(sd, **{"caption.model.generator.proj.bias": torch.from_numpy(bias)})
    got, want = run_both((cfg, params, state, sd, batch), eval_decode_dtype="float32",
                         eval_decode_stages=4, eval_decode_early_exit=True)
    assert_outputs_match(got, want)
    eos = (got["lang_cap"] == EOS_ID).reshape(-1, 8)
    first = {int(i) for i in eos.argmax(1)[eos.any(1)]}
    assert first == {0.0: set(), 2.0: {3, 6}, 6.0: {0}}[eos_bias]
    assert eos.any(1).all() == (eos_bias > 0)

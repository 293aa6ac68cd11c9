"""Data parallelism of the port on the CPU, over gloo.

Two ranks, started as processes of ``python -m
spacap3d_tpu_torch.parallel.mp_dryrun``, each run the train step on its
4-row block of a global batch of 8. They are held against the JAX
package's step on its 8-device CPU mesh (the conftest's devices) over the
whole batch, from the same weights (``params_from_jax``): ``loss``,
``cap_loss`` and the updated parameters' absolute sum within rel 2e-5 (the
tolerance of tests/test_multihost.py's 2-process JAX step), every metric
within the port-vs-JAX tolerances of tests/test_torch_train_step.py (rtol
1e-4, atol 1e-6). They are held against the port's own one-process step on
the 8 rows with plain SGD: every parameter and BN buffer within rtol 1e-5,
atol 1e-6 (Adam's first step is about lr * sign(g), which flips on the
gradients that are zero up to rounding, so the equality run takes SGD, as
tests/test_tp.py does). The ranks' parameters and BN buffers are bit-equal
(equal SHA-256 digests). Also: a world of one through the group path gives
the plain step bit for bit, the loader's process slicing, ``shard_batch``'s
refusal, and the kernel build's lock under processes started together.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from spacap3d_tpu.config import TrainConfig as JaxTrainConfig
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig as JaxDatasetConfig
from spacap3d_tpu.data.synthetic import synthetic_batch
from spacap3d_tpu.models import init_spacap as jax_init_spacap
from spacap3d_tpu.parallel.mesh import shard_batch as jax_shard_batch
from spacap3d_tpu.train.step import init_train_state
from spacap3d_tpu.train.step import make_optimizer as jax_make_optimizer
from spacap3d_tpu.train.step import make_train_step as jax_make_train_step
from spacap3d_tpu_torch.config import ModelConfig, TrainConfig
from spacap3d_tpu_torch.data.loader import DataLoader
from spacap3d_tpu_torch.models import SpaCapNet
from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.parallel import multihost
from spacap3d_tpu_torch.parallel.mesh import make_mesh, shard_batch
from spacap3d_tpu_torch.parallel.mp_dryrun import TINY, launch
from spacap3d_tpu_torch.train.step import METRIC_KEYS, TRAIN_KEYS, make_train_step
from spacap3d_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO}
# seconds: each rank's rendezvous and collectives, and each whole world
INIT_TIMEOUT, WORLD_TIMEOUT = 60, 240
B = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread while the module runs (as
    tests/test_torch_solver.py: several test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_world(out, world=2, *args):
    """``mp_dryrun`` on ``world`` gloo ranks on the CPU; returns each rank's
    JSON."""
    done = launch(["-m", "spacap3d_tpu_torch.parallel.mp_dryrun", "--out", str(out),
                   "--device", "cpu", "--timeout", str(INIT_TIMEOUT), *map(str, args)],
                  world, WORLD_TIMEOUT, env=ENV)
    for p in done:
        assert p.returncode == 0, p.stderr[-4000:]
    return [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(world)]


def jax_cfg():
    from __graft_entry__ import _flagship_cfg

    return dataclasses.replace(_flagship_cfg(tiny=True), transformer_dropout=0.0)


def make_setup(root, use_relation):
    """JAX weights and their port copy (a state dict on disk), and a global
    batch of 8 whose real boxes' GT centres sit on proposals (found by one
    port train-mode forward), so that objectness, box and relation terms
    all see positives. Without the relation loss the model has no relation
    head, as the train CLI's ``--no_relation`` builds it."""
    cfg = dataclasses.replace(jax_cfg(), check_relation=use_relation)
    assert {k: getattr(cfg, k) for k in TINY} == TINY
    params, state = jax_init_spacap(jax.random.PRNGKey(0), cfg,
                                    JaxDatasetConfig().mean_size_arr)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    batch, _, _ = synthetic_batch(cfg, batch_size=B, seed=3, vocab_size=cfg.vocab_size)
    batch = {k: np.asarray(batch[k]) for k in TRAIN_KEYS}
    model = SpaCapNet(ModelConfig(**dataclasses.asdict(cfg)))
    model.load_state_dict(sd)
    with torch.no_grad():
        ep = model.train().train_forward({k: torch.as_tensor(v) for k, v in batch.items()})
    nobj = batch["box_label_mask_int"].sum(1)
    for b in range(B):
        batch["center_label"][b, :nobj[b]] = ep["aggregated_vote_xyz"][b, :nobj[b]].numpy() + .05
    os.makedirs(root, exist_ok=True)
    torch.save(sd, os.path.join(root, "weights.pt"))
    np.savez(os.path.join(root, "batch.npz"), **batch)
    return dict(root=root, cfg=cfg, params=params, state=state, sd=sd, batch=batch)


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    return {rel: make_setup(str(root / str(rel)), rel) for rel in (True, False)}


@pytest.fixture(scope="module")
def setup(setups):
    return setups[True]


def world_args(setup, *extra):
    r = setup["root"]
    return ["--legs", "dp", "--config", "tiny", "--weights", os.path.join(r, "weights.pt"),
            "--batch", os.path.join(r, "batch.npz"), *extra]


def check_ranks_agree(results):
    a, b = (r["dp"] for r in results)
    assert a["rows"] == b["rows"] == B // 2
    assert a["param_digest"] == b["param_digest"]
    assert a["bn_digest"] == b["bn_digest"]
    assert a["steps"][0]["metrics"] == b["steps"][0]["metrics"]
    assert a["losses"] == b["losses"]


@pytest.mark.parametrize("use_relation", [True, False])
def test_two_rank_step_matches_jax_mesh_step(setups, tmp_path, use_relation):
    """The port's 2-rank gloo step against the JAX package's 8-device mesh
    step on the same global batch, with Adam (the two packages' default
    optimizers)."""
    setup = setups[use_relation]
    extra = [] if use_relation else ["--no_relation"]
    results = run_world(tmp_path, 2, *world_args(setup, *extra))
    check_ranks_agree(results)
    cfg, params, state = setup["cfg"], setup["params"], setup["state"]
    jtc = JaxTrainConfig(batch_size=B, use_relation=use_relation)
    tx = jax_make_optimizer(params, jtc, steps_per_epoch=10)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    ts, want = jax_make_train_step(cfg, jtc, tx, mesh=mesh)(
        init_train_state(params, state, tx),
        jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in setup["batch"].items()}),
        jax.random.PRNGKey(0), 0.1)
    want_abs = float(sum(jnp.sum(jnp.abs(v)) for k, v in ts.params.items()
                         if k != "mean_size_arr" for v in jax.tree_util.tree_leaves(v)))
    got = results[0]["dp"]
    metrics = got["steps"][0]["metrics"]
    assert sorted(metrics) == sorted(METRIC_KEYS)
    for k in ("loss", "cap_loss"):
        assert metrics[k] == pytest.approx(float(want[k]), rel=2e-5), k
    assert got["param_abs_sum"] == pytest.approx(want_abs, rel=2e-5)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(metrics[k], float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert (metrics["relation_loss"] > 0) == use_relation and metrics["pos_ratio"] > 0


def plain_step(setup, optimizer, group=None):
    """The port's step on the whole batch from the setup's weights; returns
    (model, metrics)."""
    cfg = ModelConfig(**dataclasses.asdict(setup["cfg"]))
    model = SpaCapNet(cfg)
    model.load_state_dict(setup["sd"])
    metrics = make_train_step(cfg, TrainConfig(), optimizer(model), device="cpu",
                              group=group)(model, setup["batch"], None, 0.1)
    return model, {k: float(v) for k, v in metrics.items()}


def test_two_rank_step_matches_one_process_step(setup, tmp_path):
    """SGD at lr 1e-4, so that an update is proportional to its gradient
    (the largest, ~0.016, is above Adam's 1e-3 at the default rate): the
    2-rank step's parameters and BN buffers against the port's one-process
    step on all 8 rows, within rtol 1e-5, atol 1e-6; each leaf's update
    within 1e-3 of its largest entry, floored at 1e-4 of the largest of all
    leaves (tests/test_torch_train_step.py's gradient share and floor: the
    ranks' sums reassociate the batch's, and some leaves' gradients are
    zero up to rounding)."""
    results = run_world(tmp_path, 2, *world_args(setup, "--optimizer", "sgd", "--lr", "1e-4"))
    check_ranks_agree(results)
    model, metrics = plain_step(setup, lambda m: torch.optim.SGD(m.parameters(), lr=1e-4))
    got = torch.load(tmp_path / "dp_state.pt", weights_only=True)
    want = model.state_dict()
    assert sorted(got) == sorted(want)
    steps = {k: (w - setup["sd"][k].to(w.dtype)).abs().max() for k, w in want.items()}
    top = max(steps.values())
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-6, msg=k)
        assert (got[k] - w).abs().max() <= 1e-3 * max(steps[k], 1e-4 * top), k
    moved = sum(bool(v > 0) for v in steps.values())
    assert moved > len(want) // 2
    for k, v in metrics.items():
        assert results[0]["dp"]["steps"][0]["metrics"][k] == pytest.approx(v, rel=1e-5,
                                                                           abs=1e-6), k


def test_world_of_one_group_path_is_the_plain_step(setup):
    """A gloo group of one rank in this process: the group path's metrics,
    parameters and BN buffers equal the plain step's bit for bit (batch
    norm and the losses keep their single-process arithmetic; the gradient
    and metric all-reduces over one rank are the identity)."""
    adam = lambda m: torch.optim.Adam(m.parameters(), lr=1e-3)  # noqa: E731
    assert multihost.initialize_from_env(f"localhost:{multihost.free_port()}", 1, 0,
                                         device="cpu", timeout_s=INIT_TIMEOUT) == (0, 1)
    try:
        grouped, gm = plain_step(setup, adam, group=make_mesh())
    finally:
        multihost.shutdown()
    plain, pm = plain_step(setup, adam)
    assert gm == pm
    for k, v in plain.state_dict().items():
        assert torch.equal(grouped.state_dict()[k], v), k


class ListDataset:
    """Items keyed by their index, with the item's RNG draw (the loader's
    per-item RNG schedule)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return {"dataset_idx": np.int64(i), "draw": np.float64(rng.rand())}


@pytest.mark.parametrize("n", [16, 13, 3])
def test_loader_row_blocks_concatenate_to_the_global_batch(n):
    """Two processes' row-blocks of every batch (``__valid__`` included)
    concatenate to the one-process batch, shuffled and with a wrapped
    final batch, also when the split is shorter than the wrap (3 items, a
    batch of 8); a batch the processes do not divide raises."""
    ds = ListDataset(n)
    whole = list(DataLoader(ds, 8, shuffle=True, seed=3, num_workers=2))
    parts = [list(DataLoader(ds, 8, shuffle=True, seed=3, num_workers=2, process_index=r,
                             process_count=2)) for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == -(-n // 8)
    for w, a, b in zip(whole, *parts):
        assert sorted(w) == sorted(a)
        for k in w:
            np.testing.assert_array_equal(np.concatenate([a[k], b[k]]), w[k], err_msg=k)
    assert whole[-1]["__valid__"].sum() == (n % 8 or 8)
    assert sorted(set(np.concatenate([w["dataset_idx"] for w in whole]))) == list(range(n))
    with pytest.raises(ValueError, match="divide evenly"):
        DataLoader(ds, 8, shuffle=False, process_count=3)


def test_shard_batch_takes_row_blocks_and_refuses_a_ragged_batch(monkeypatch):
    import torch.distributed as dist

    group = object()
    batch = {"x": np.arange(8).reshape(8, 1), "n": np.float32(2.0)}
    monkeypatch.setattr(dist, "get_rank", lambda g: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda g: 2)
    got = shard_batch(group, batch)
    np.testing.assert_array_equal(got["x"][:, 0], [4, 5, 6, 7])
    assert got["n"] == 2.0
    monkeypatch.setattr(dist, "get_world_size", lambda g: 3)
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch(group, batch)
    np.testing.assert_array_equal(shard_batch(None, batch)["x"], batch["x"])


STUB_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open({count!r}, "a") as f:
        f.write(("compile " if "-c" in sys.argv else "link ") + os.path.basename(out) + "\\n")
    time.sleep(0.5)
    with open(out, "wb") as f:
        f.write(b"stub")
    if "-c" in sys.argv:
        print("ptxas info    : Compiling entry function 'k' for 'sm_90a'")
        print("ptxas info    : Used 32 registers")
""")
BUILD_SCRIPT = textwrap.dedent("""\
    import sys
    from pathlib import Path
    from spacap3d_tpu_torch.ops import _build
    _build.CSRC, _build.BUILD_DIR = Path(sys.argv[1]), Path(sys.argv[2])
    _build._nvcc = lambda: sys.argv[3]
    print(_build.build())
""")


def test_kernel_build_runs_once_for_processes_started_together(tmp_path):
    """Four processes ask for the library at once, with a stub compiler
    that takes half a second: the sources compile once and link once, and
    every process gets the same library path, which exists; the ptxas log
    is in place."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    count = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB_NVCC.format(python=sys.executable, count=str(count)))
    stub.chmod(0o755)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(csrc), str(build),
                               str(stub)], env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    calls = count.read_text().splitlines()
    assert sorted(c.split()[0] for c in calls) == ["compile", "compile", "link"], calls
    assert sorted(p.name for p in build.glob("*.log")) == ["a.log", "b.log"]
    orig = _build.CSRC, _build.BUILD_DIR
    try:
        _build.CSRC, _build.BUILD_DIR = csrc, build
        assert _build.ptxas_info() == {"k": {"registers": 32, "static_smem": 0}}
    finally:
        _build.CSRC, _build.BUILD_DIR = orig

"""The port's eval harness as a whole against the JAX package's on the CPU:
the seed x scene ``mul_eval_grid`` on the same synthetic files with
weights converted by ``params_from_jax``, and, within the port, the grid
against its per-row upload (``point_table='off'``) and the serial
protocol (``eval_cap`` over ``DataLoader(seed=s)``).

f32 decode, so both sides emit equal tokens, and equal tokens with boxes
within the trunk's float tolerance give equal host decisions: per-seed
rows are compared with ``==``. ``min_iou`` 0.05, so that random weights
leave real, seed-dependent candidates (at 0.5 nothing survives and every
seed scores the same all-backfill corpus)."""
import itertools
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacap3d_tpu.config import DataConfig as JaxDataConfig
from spacap3d_tpu.config import ModelConfig as JaxModelConfig
from spacap3d_tpu.data.dataset import ScanReferDataset as JaxDataset
from spacap3d_tpu.data.dataset import SceneStore as JaxSceneStore
from spacap3d_tpu.data.scannet_config import ScannetDatasetConfig as JaxDatasetConfig
from spacap3d_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from spacap3d_tpu.eval.eval_helper import organize_annotations as jax_organize
from spacap3d_tpu.eval.eval_helper import prepare_corpus as jax_corpus
from spacap3d_tpu.eval.mul_eval import mul_eval_grid as jax_mul_eval_grid
from spacap3d_tpu.models import init_spacap as jax_init_spacap
from spacap3d_tpu.train.step import make_eval_step as jax_make_eval_step
from spacap3d_tpu_torch.config import DataConfig, ModelConfig
from spacap3d_tpu_torch.data.dataset import ScanReferDataset, SceneStore
from spacap3d_tpu_torch.data.loader import DataLoader
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu_torch.data.synthetic import write_synthetic_dataset
from spacap3d_tpu_torch.data.vocabulary import Vocabulary
from spacap3d_tpu_torch.eval import capeval, eval_helper, mul_eval
from spacap3d_tpu_torch.eval.eval_helper import eval_cap, organize_annotations, prepare_corpus
from spacap3d_tpu_torch.eval.mul_eval import mul_eval_grid
from spacap3d_tpu_torch.models import SpaCapNet
from spacap3d_tpu_torch.train.step import make_eval_step
from spacap3d_tpu_torch.utils import trace
from spacap3d_tpu_torch.utils.convert import params_from_jax

# tests/test_mul_eval_grid.py's config, f32 decode
MODEL = dict(
    num_points=1024, num_proposals=16, num_layers=2, num_heads=4,
    d_model=32, d_ff=64, max_des_len=7,
    sa_npoints=(128, 64, 32, 16), sa_nsamples=(16, 8, 8, 4),
    sa_widths=((16, 16, 32), (32, 32, 64), (32, 32, 64), (32, 32, 64)),
    fp_width=64, seed_feature_dim=64, proposal_feature_dim=32,
    eval_decode_dtype="float32",
)
SEEDS = [0, 1]
MIN_IOU = 0.05
FAKE_JAR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fake_meteor_jar.py")


def build_both(root):
    """The same 3-scene synthetic split, one annotation a scene (the eval
    protocol), for both packages, and seeded JAX weights (objectness-1
    logit biased by +2, so that random weights detect) with their port
    copy."""
    anns, scene_ids = write_synthetic_dataset(root, num_scenes=3, seed=11)
    seen = set()
    eval_list = [a for a in anns if not (a["scene_id"] in seen or seen.add(a["scene_id"]))]
    scene_dir = os.path.join(root, "scannet", "scannet_data")
    data = dict(data_root=root, num_points=MODEL["num_points"], augment=False,
                use_relation=False, max_des_len=7)

    jdc, jvocab = JaxDatasetConfig(), JaxVocabulary.build(anns, max_len=7)
    jcfg = JaxModelConfig(**MODEL, vocab_size=len(jvocab))
    params, state = jax_init_spacap(jax.random.PRNGKey(2), jcfg, jdc.mean_size_arr)
    bias = np.asarray(params["proposal"]["conv2"]["bias"]).copy()
    bias[1] += 2.0
    params["proposal"]["conv2"]["bias"] = jnp.asarray(bias)
    jax_side = dict(
        ds=JaxDataset(eval_list, JaxSceneStore(scene_dir, scene_ids), jvocab, jdc,
                      JaxDataConfig(**data), split="val"),
        vocab=jvocab, dc=jdc, cfg=jcfg, params=params, state=state)

    dc, vocab = ScannetDatasetConfig(), Vocabulary.build(anns, max_len=7)
    cfg = ModelConfig(**MODEL, vocab_size=len(vocab))
    model = SpaCapNet(cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                          jax.tree_util.tree_map(np.asarray, state)))
    port = dict(ds=ScanReferDataset(eval_list, SceneStore(scene_dir, scene_ids), vocab, dc,
                                    DataConfig(**data), split="val"),
                vocab=vocab, dc=dc, cfg=cfg, model=model.eval())
    return anns, jax_side, port


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return build_both(str(tmp_path_factory.mktemp("torch_grid")))


def port_grid(both, point_table="auto", seeds=SEEDS, **kw):
    anns, _, p = both
    timing = {}
    rows = mul_eval_grid(
        make_eval_step(p["cfg"], device="cpu", compact=True), p["model"], p["ds"], p["vocab"],
        p["dc"], prepare_corpus(anns), organize_annotations(anns), seeds, batch_size=4,
        min_iou=MIN_IOU, num_workers=2, score_workers=2, timing_out=timing,
        point_table=point_table, device="cpu", **kw)
    return rows, timing


@pytest.fixture(scope="module")
def grid_rows(both):
    return port_grid(both)


def test_grid_rows_equal_jax(both, grid_rows):
    anns, j, _ = both
    want = jax_mul_eval_grid(
        jax_make_eval_step(j["cfg"], compact=True), j["params"], j["state"], j["ds"],
        j["vocab"], j["dc"], jax_corpus(anns), jax_organize(anns), SEEDS, batch_size=4,
        min_iou=MIN_IOU, also_detection=True, num_workers=1, score_workers=1)
    rows, timing = grid_rows
    assert rows == want
    assert rows[0] != rows[1]                       # the seeds' subsamples differ
    assert {"mAP@0.5", "AR@0.5", "cider", "meteor"} <= set(rows[0])
    assert timing["point_table"] is True and timing["forwards"] == 2


@pytest.mark.parametrize("variant", ["off", "budget", "serial"])
def test_grid_rows_equal_table_off_and_serial(both, grid_rows, variant, monkeypatch):
    """The per-row upload (forced, or by a table over the byte budget) and
    the serial protocol with the full step give the grid's rows."""
    anns, _, p = both
    want, _ = grid_rows
    if variant == "serial":
        step = make_eval_step(p["cfg"], device="cpu")
        got = []
        for seed in SEEDS:
            metrics, _ = eval_cap(
                step, p["model"], p["ds"],
                DataLoader(p["ds"], batch_size=3, shuffle=False, seed=seed, num_workers=1),
                p["vocab"], p["dc"], anns, min_iou=MIN_IOU, also_detection=True, device="cpu")
            got.append({"seed": seed, **{k: v for k, v in metrics.items() if k != "detection"}})
    else:
        if variant == "budget":
            monkeypatch.setenv("SPACAP_POINT_TABLE_BYTES", "1")
        got, timing = port_grid(both, "off" if variant == "off" else "auto")
        assert timing["point_table"] is False
        assert timing["fetch_s"] + timing["post_s"] + timing["lock_s"] == \
            pytest.approx(timing["consume_s"], rel=1e-6)
    assert got == want


def test_grid_spans_are_its_timing(both, grid_rows):
    """The grid's spans are the clock reads of ``timing_out``: the sums of
    ``grid.fetch``, ``grid.post``, ``grid.lock`` and ``grid.consume`` are
    its ``fetch_s``, ``post_s``, ``lock_s`` and ``consume_s``, those of
    ``grid.launch`` its ``launch_s``. A forward's consume spans are its
    parts' parents, on a consume thread, and share its index with its
    launch, whose upload is its child; the rows do not change."""
    trace.enable()
    try:
        rows, timing = port_grid(both)
    finally:
        records = trace.disable()
    assert rows == grid_rows[0]
    sums = trace.summary(records)
    for name, key in (("grid.fetch", "fetch_s"), ("grid.post", "post_s"),
                      ("grid.lock", "lock_s"), ("grid.consume", "consume_s"),
                      ("grid.launch", "launch_s")):
        assert sums[name]["wall_s"] == pytest.approx(timing[key], rel=1e-9, abs=1e-12), name
        assert sums[name]["count"] == timing["forwards"] == 2
    by_id = {r["id"]: r for r in records}
    launches = {r["request"]: r for r in records if r["name"] == "grid.launch"}
    consumes = {r["request"]: r for r in records if r["name"] == "grid.consume"}
    assert sorted(launches) == sorted(consumes) == [0, 1]
    for r in records:
        if r["name"] in ("grid.fetch", "grid.post", "grid.lock"):
            assert by_id[r["parent"]]["name"] == "grid.consume"
            assert r["request"] == by_id[r["parent"]]["request"]
        if r["name"] == "upload" and r["parent"]:
            assert by_id[r["parent"]]["name"] == "grid.launch"
    main = threading.get_ident()
    assert all(c["thread"] != main for c in consumes.values())
    assert all(launch["thread"] == main for launch in launches.values())


def test_grid_rows_hold_under_thread_switching(both, grid_rows):
    """Consume threads share the candidates, the AP state and the seed
    counts under one lock. One row a batch (12 batches for 4 consume
    threads), 8 loader threads and a 1 us switch interval: a lost update
    of a seed's candidates or AP state would change its row."""
    want, _ = grid_rows
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        anns, _, p = both
        timing = {}
        rows = mul_eval_grid(
            make_eval_step(p["cfg"], device="cpu", compact=True), p["model"], p["ds"],
            p["vocab"], p["dc"], prepare_corpus(anns), organize_annotations(anns),
            [0, 1, 2, 3], batch_size=1, min_iou=MIN_IOU, num_workers=8, score_workers=4,
            timing_out=timing, device="cpu")
    finally:
        sys.setswitchinterval(interval)
    assert rows[:2] == want
    assert rows[2] != rows[3] and timing["forwards"] == 12


def test_ap_depends_on_the_order_of_tied_scans():
    """Why the grid steps a seed's scans in dataset order: two scans whose
    detections tie in confidence, a true one in the first and a false one
    in the second, score AP 1 in that order and 0.5 the other way round."""
    from spacap3d_tpu_torch.eval.detection import APCalculator

    box = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float64)
    scans = {"hit": ([(0, box, 0.5)], [(0, box)]), "miss": ([(0, box + 5.0, 0.5)], [])}
    maps = []
    for order in (("hit", "miss"), ("miss", "hit")):
        calc = APCalculator(0.5)
        for name in order:
            calc.step([scans[name][0]], [scans[name][1]])
        maps.append(calc.compute_metrics(num_workers=1)["mAP"])
    assert maps == [pytest.approx(1.0, abs=1e-6), pytest.approx(0.5, abs=1e-6)]


def test_grid_rows_hold_when_batches_finish_out_of_order(both, grid_rows, monkeypatch):
    """A captured forward returns before its outputs exist, so the consume
    threads finish batches out of their grid order; a seed's AP, which
    depends on the order of its scans where confidences tie, takes them in
    dataset order all the same. One row a batch; the first batch's fetch
    waits until the second batch's has finished."""
    want, _ = grid_rows
    real, calls, order = mul_eval.fetch_outputs, itertools.count(), []
    second_done = threading.Event()

    def late(out):
        n = next(calls)
        if n == 0 and not second_done.wait(timeout=120):
            raise TimeoutError("the second batch never finished")
        fetched = real(out)
        order.append(n)
        if n == 1:
            second_done.set()
        return fetched

    monkeypatch.setattr(mul_eval, "fetch_outputs", late)
    anns, _, p = both
    rows = mul_eval_grid(
        make_eval_step(p["cfg"], device="cpu", compact=True), p["model"], p["ds"],
        p["vocab"], p["dc"], prepare_corpus(anns), organize_annotations(anns), SEEDS,
        batch_size=1, min_iou=MIN_IOU, num_workers=2, score_workers=2, device="cpu")
    assert order[0] == 1 and sorted(order) == list(range(6))
    assert rows == want


def test_grid_spawns_one_meteor_process(both, monkeypatch):
    """With a (fake) METEOR jar, one process serves every seed's scoring
    and is closed when the grid returns."""
    monkeypatch.setenv("SPACAP_METEOR_COMMAND", f"{sys.executable} {FAKE_JAR}")
    spawned = []
    real_popen = capeval.subprocess.Popen

    def counting_popen(*args, **kwargs):
        spawned.append(real_popen(*args, **kwargs))
        return spawned[-1]

    monkeypatch.setattr(capeval.subprocess, "Popen", counting_popen)
    rows, _ = port_grid(both, seeds=[0, 1, 2], also_detection=False)
    assert len(spawned) == 1 and spawned[0].poll() is not None
    assert len(rows) == 3 and all(np.isfinite(r["meteor"]) for r in rows)


ENTRY_POINTS = {
    "mul_eval_grid": lambda step, p, loader, anns: mul_eval.mul_eval_grid(
        step, p["model"], p["ds"], p["vocab"], p["dc"], prepare_corpus(anns),
        organize_annotations(anns), SEEDS, 4),
    "eval_cap": lambda step, p, loader, anns: eval_helper.eval_cap(
        step, p["model"], p["ds"], loader, p["vocab"], p["dc"], anns),
    "feed_scene_cap": lambda step, p, loader, anns: eval_helper.feed_scene_cap(
        step, p["model"], p["ds"], loader, p["vocab"], organize_annotations(anns), p["dc"]),
    "eval_detection": lambda step, p, loader, anns: eval_helper.eval_detection(
        step, p["model"], loader, p["dc"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(both, entry):
    """``device`` defaults to "cuda": without CUDA every entry point raises
    before it runs a forward, unless the caller passes device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    anns, _, p = both
    calls = []

    def step(model, batch):
        calls.append(batch)
        raise AssertionError("a forward ran")

    loader = DataLoader(p["ds"], batch_size=3, shuffle=False, num_workers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[entry](step, p, loader, anns)
    assert not calls
    with pytest.raises(ValueError, match="lies on"):     # the model is on the CPU
        eval_helper.eval_device(p["model"], "meta")

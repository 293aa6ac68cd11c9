"""The port's serial eval entry points against the JAX package's on the
CPU: ``eval_cap`` (caption and detection metrics, candidates, the proposal
dump) and ``eval_detection``, on the split and converted weights of
tests/test_torch_mul_eval.py; and, within the port, the padded-final-batch
protocol of tests/test_padded_eval.py: batch sizes 2, 3 and 5 over 3
scenes give equal metrics, because rows the loader wraps around are
skipped. Equal tokens and decisions give equal host arithmetic, so
metrics are compared with ``==``."""
import os
import pickle

import numpy as np
import pytest

from spacap3d_tpu.data.loader import DataLoader as JaxDataLoader
from spacap3d_tpu.eval.eval_helper import eval_cap as jax_eval_cap
from spacap3d_tpu.eval.eval_helper import eval_detection as jax_eval_detection
from spacap3d_tpu.train.step import make_eval_step as jax_make_eval_step
from spacap3d_tpu_torch.data.loader import DataLoader
from spacap3d_tpu_torch.eval.eval_helper import eval_cap, eval_detection
from spacap3d_tpu_torch.train.step import make_eval_step
from test_torch_mul_eval import MIN_IOU, build_both

DETECTION_IOUS = (0.05, 0.5)    # 0.05: random weights reach a nonzero AP


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return build_both(str(tmp_path_factory.mktemp("torch_eval_cap")))


def port_run(both, batch_size, tmp_path=None):
    anns, _, p = both
    step = make_eval_step(p["cfg"], device="cpu")

    def loader():
        return DataLoader(p["ds"], batch_size=batch_size, shuffle=False, seed=3, num_workers=1)

    files = {} if tmp_path is None else dict(
        corpus_cache=str(tmp_path / "corpus.json"), pred_path=str(tmp_path / "pred.json"),
        save_proposal=True, dump_dir=str(tmp_path / "dumps"))
    metrics, candidates = eval_cap(step, p["model"], p["ds"], loader(), p["vocab"], p["dc"],
                                   anns, min_iou=MIN_IOU, also_detection=True, device="cpu",
                                   **files)
    det = {iou: eval_detection(step, p["model"], loader(), p["dc"], ap_iou=iou, device="cpu")
           for iou in DETECTION_IOUS}
    return metrics, candidates, det


@pytest.fixture(scope="module")
def batch3(both, tmp_path_factory):
    path = tmp_path_factory.mktemp("files")
    return port_run(both, 3, path), path


def test_eval_cap_and_detection_equal_jax(both, batch3, tmp_path):
    anns, j, _ = both
    (metrics, candidates, det), path = batch3
    step = jax_make_eval_step(j["cfg"])

    def loader():
        return JaxDataLoader(j["ds"], batch_size=3, shuffle=False, seed=3, num_workers=1)

    want, want_candidates = jax_eval_cap(
        step, j["params"], j["state"], j["ds"], loader(), j["vocab"], j["dc"], anns,
        min_iou=MIN_IOU, also_detection=True, save_proposal=True,
        dump_dir=str(tmp_path / "dumps"))
    assert metrics == want
    assert candidates == want_candidates
    assert any(c != ["sos eos"] for c in candidates.values())
    for iou in DETECTION_IOUS:
        assert det[iou] == jax_eval_detection(step, j["params"], j["state"], loader(), j["dc"],
                                              ap_iou=iou)
    assert det[0.05]["mAP"] > 0

    # --save_proposal: the same scenes and decisions (floats: the trunk's
    # tolerance, as in tests/test_torch_eval_step.py)
    with open(path / "dumps" / "proposal_related.pkl", "rb") as f:
        dump = pickle.load(f)
    with open(tmp_path / "dumps" / "proposal_related.pkl", "rb") as f:
        want_dump = pickle.load(f)
    assert sorted(dump) == sorted(want_dump) and dump
    for scene, entry in want_dump.items():
        assert sorted(dump[scene]) == sorted(entry)
        for k, w in entry.items():
            if k in ("obj_id", "obj_mask", "nms_mask", "class"):
                np.testing.assert_array_equal(dump[scene][k], w, err_msg=k)
            else:
                np.testing.assert_allclose(dump[scene][k], w, atol=5e-4, rtol=0, err_msg=k)
    assert os.path.exists(path / "corpus.json") and os.path.exists(path / "pred.json")


@pytest.mark.parametrize("batch_size", [2, 5])
def test_padded_batches_give_equal_metrics(both, batch3, batch_size):
    """3 scenes at batch 2 (one wrapped row) and 5 (two) against batch 3
    (none): wrapped rows must count neither as candidates nor in AP."""
    (want_metrics, want_candidates, want_det), _ = batch3
    metrics, candidates, det = port_run(both, batch_size)
    assert metrics == want_metrics
    assert candidates == want_candidates
    assert det == want_det

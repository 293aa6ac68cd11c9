"""The port's detection evaluation against the JAX package's: NMS keep
lists (the port's numpy greedy NMS against the JAX package's, which takes
its host library where built), prediction and groundtruth parsing, and
VOC AP/AR through ``eval_det`` and ``APCalculator``, on the inputs of
tests/test_detection_eval.py and on random scenes. Both sides do the same
float64 host arithmetic, so results are compared with ``==``."""
import numpy as np
import pytest

from spacap3d_tpu.eval import detection as jax_detection
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu_torch.eval import detection

SIGNS = np.array([[1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
                  [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]], np.float32)
POST = dict(remove_empty_box=True, use_3d_nms=True, nms_iou=0.25, use_old_type_nms=False,
            cls_nms=True, per_class_proposal=True, conf_thresh=0.05,
            dataset_config=ScannetDatasetConfig())


def random_boxes(seed, n, dims=3, cls=False):
    """(n, 2 dims + 1 [+ 1]) lo, hi, score [, class]: clustered boxes, so
    that NMS suppresses, with one exact score tie."""
    rng = np.random.RandomState(seed)
    lo = rng.rand(n, dims) * 2.0
    hi = lo + rng.rand(n, dims) * 1.5 + 0.05
    score = rng.rand(n)
    score[-1] = score[0]
    cols = [lo, hi, score[:, None]]
    if cls:
        cols.append(rng.randint(0, 3, (n, 1)).astype(np.float64))
    return np.concatenate(cols, 1)


NMS_CASES = {
    # tests/test_detection_eval.py's cases
    "3d_overlap": ("nms_3d_faster", np.array([[0, 0, 0, 1, 1, 1, 0.9],
                                              [0.05, 0, 0, 1.05, 1, 1, 0.8],
                                              [5, 5, 5, 6, 6, 6, 0.7]]), {}),
    "samecls": ("nms_3d_faster_samecls", np.array([[0, 0, 0, 1, 1, 1, 0.9, 1],
                                                  [0.05, 0, 0, 1.05, 1, 1, 0.8, 2],
                                                  [0.05, 0, 0, 1.05, 1, 1, 0.7, 1]]), {}),
    "3d_random": ("nms_3d_faster", random_boxes(0, 64), {}),
    "3d_random_old": ("nms_3d_faster", random_boxes(1, 64), {"old_type": True}),
    "samecls_random": ("nms_3d_faster_samecls", random_boxes(2, 96, cls=True), {}),
    "2d_random": ("nms_2d_faster", random_boxes(3, 64, dims=2), {}),
    "single": ("nms_3d_faster", random_boxes(4, 1), {}),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_picks_equal_jax(case):
    fn, boxes, kw = NMS_CASES[case]
    got = getattr(detection, fn)(boxes, 0.25, **kw)
    assert [int(i) for i in got] == [int(i) for i in getattr(jax_detection, fn)(boxes, 0.25, **kw)]
    assert len(got) >= 1 and (len(boxes) < 8 or len(got) < len(boxes))


def corners_from_minmax(lo, hi):
    c, s = 0.5 * (np.asarray(lo) + np.asarray(hi)), np.asarray(hi) - np.asarray(lo)
    return c + 0.5 * s * SIGNS.astype(np.float64)


def random_outputs(seed, b=3, k=24, n=600):
    """Eval-step outputs over ``b`` scenes of ``k`` proposals: full
    (corners) and compact (extents, uint16 / bool narrowing) forms."""
    rng = np.random.RandomState(seed)
    centers = (rng.rand(b, k, 3) * 4).astype(np.float32)
    sizes = np.where(rng.rand(b, k, 1) > 0.3, rng.rand(b, k, 3) * 1.5 + 0.5,
                     rng.rand(b, k, 3) * 0.05 + 0.01).astype(np.float32)
    corners = centers[:, :, None] + 0.5 * sizes[:, :, None] * SIGNS
    pc = (rng.rand(b, n, 4) * 4).astype(np.float32)
    sem = rng.randn(b, k, 18).astype(np.float32) * 2
    full = {"bbox_corner": corners, "sem_cls": sem.argmax(-1), "sem_cls_scores": sem,
            "objectness_scores": rng.randn(b, k, 2).astype(np.float32) + [0, 1],
            "point_clouds": pc}
    compact = {"bbox_lo": corners.min(2), "bbox_hi": corners.max(2), "sem_cls_scores": sem,
               "objectness_scores": full["objectness_scores"],
               "nonempty_box": ((pc[:, None, :, :3] >= corners.min(2)[:, :, None])
                                & (pc[:, None, :, :3] <= corners.max(2)[:, :, None])
                                ).all(-1).sum(-1) >= 5}
    m = 10
    gt_centers = centers[:, :m] + rng.randn(b, m, 3).astype(np.float32) * 0.1
    gts = {"box_label_mask": (rng.rand(b, m) > 0.2).astype(np.float32),
           "sem_cls_label": sem[:, :m].argmax(-1),
           "gt_box_corner_label": (gt_centers[:, :, None] + 0.5 * sizes[:, :m, None] * SIGNS
                                   ).astype(np.float64)}
    return full, compact, gts


@pytest.mark.parametrize("form", ["full", "compact"])
@pytest.mark.parametrize("per_class", [True, False])
def test_parse_and_ap_equal_jax(form, per_class):
    full, compact, gt_ep = random_outputs(5)
    post = dict(POST, per_class_proposal=per_class)
    ep = full if form == "full" else compact
    got_ep, want_ep = dict(ep), dict(ep)
    preds = detection.parse_predictions_arrays(got_ep, post)
    want = jax_detection.parse_predictions_arrays(want_ep, post)
    np.testing.assert_array_equal(got_ep["pred_mask"], want_ep["pred_mask"])
    assert 0 < got_ep["pred_mask"].sum() < got_ep["pred_mask"].size
    for g, w in zip(preds, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    gts = detection.parse_groundtruths_arrays(gt_ep, post)
    for iou in (0.25, 0.5):
        calc = detection.APCalculator(iou, post["dataset_config"].class2type)
        ref = jax_detection.APCalculator(iou, post["dataset_config"].class2type)
        calc.step(preds, gts)
        ref.step(want, jax_detection.parse_groundtruths_arrays(gt_ep, post))
        got_m, want_m = calc.compute_metrics(), ref.compute_metrics()
        assert got_m == want_m
        assert got_m["mAP"] > 0


def test_tuple_parsing_and_eval_det_equal_jax():
    """tests/test_detection_eval.py's end-to-end scene, through the
    reference's tuple layout, plus eval_det_cls on its two-box cases."""
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.rand(100, 3) * 0.8 + 0.1, rng.rand(100, 3) * 0.8 + 4.1]
                         ).astype(np.float32)
    centers = np.array([[0.5, 0.5, 0.5], [0.55, 0.5, 0.5], [4.5, 4.5, 4.5], [8.0, 8.0, 8.0]])
    corners = np.stack([corners_from_minmax(c - 0.5, c + 0.5) for c in centers])[None]
    sem = np.zeros((1, 4, 3))
    sem[0, :, 0] = 5.0
    ep = {"bbox_corner": corners, "sem_cls": sem.argmax(-1), "sem_cls_scores": sem,
          "objectness_scores": np.array([[[0.0, 4.0], [0.0, 3.0], [0.0, 4.0], [0.0, 4.0]]]),
          "point_clouds": pts[None]}

    class DC:
        num_class = 3

    post = dict(POST, dataset_config=DC())
    got_ep, want_ep = dict(ep), dict(ep)
    preds = detection.parse_predictions(got_ep, post)
    want = jax_detection.parse_predictions(want_ep, post)
    np.testing.assert_array_equal(got_ep["pred_mask"], [[1, 0, 1, 0]])
    np.testing.assert_array_equal(got_ep["pred_mask"], want_ep["pred_mask"])
    assert [(c, s) for c, _, s in preds[0]] == [(c, s) for c, _, s in want[0]]
    gt_ep = {"box_label_mask": np.array([[1, 1, 0]]), "sem_cls_label": np.array([[0, 0, 0]]),
             "gt_box_corner_label": corners[:, [0, 2, 3]]}
    gts = detection.parse_groundtruths(gt_ep, post)
    calc = detection.APCalculator(0.25, {0: "a", 1: "b", 2: "c"})
    ref = jax_detection.APCalculator(0.25, {0: "a", 1: "b", 2: "c"})
    calc.step(preds, gts)
    ref.step(want, jax_detection.parse_groundtruths(gt_ep, post))
    assert calc.compute_metrics() == ref.compute_metrics()
    assert calc.compute_metrics()["mAP"] == pytest.approx(1.0 / 3.0)

    gt_box = corners_from_minmax([0, 0, 0], [1, 1, 1])
    far = corners_from_minmax([5, 5, 5], [6, 6, 6])
    for pred in ({"img0": [(gt_box, 0.9), (far, 0.8)]}, {"img0": [(gt_box, 0.9), (gt_box, 0.8)]}):
        got = detection.eval_det_cls(pred, {"img0": [gt_box]}, 0.25)
        want = jax_detection.eval_det_cls(pred, {"img0": [gt_box]}, 0.25)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for rec, prec in (([0.5, 1.0], [1.0, 1.0]), ([0.2, 0.4, 0.4], [1.0, 0.5, 0.66])):
        for use_07 in (False, True):
            assert detection.voc_ap(np.array(rec), np.array(prec), use_07) == \
                jax_detection.voc_ap(np.array(rec), np.array(prec), use_07)


def test_box_helpers_equal_jax():
    a, b = corners_from_minmax([0, 0, 0], [2, 2, 2]), corners_from_minmax([1, 0, 0], [3, 2, 2])
    assert detection.box3d_iou_np(a, b) == jax_detection.box3d_iou_np(a, b)
    assert detection.calc_iou([0, 0, 0, 2, 2, 2], [1, 0, 0, 2, 2, 2]) == \
        jax_detection.calc_iou([0, 0, 0, 2, 2, 2], [1, 0, 0, 2, 2, 2])
    boxes = np.stack([corners_from_minmax([0, 0, 0], [1, 1, 1]).reshape(-1),
                      corners_from_minmax([0.01, 0, 0], [1.01, 1, 1]).reshape(-1),
                      corners_from_minmax([5, 5, 5], [6, 6, 6]).reshape(-1)])
    conf = np.array([0.9, 0.8, 0.7])
    assert detection.nms_crnr_dist(boxes, conf, 0.9) == jax_detection.nms_crnr_dist(boxes, conf, 0.9)

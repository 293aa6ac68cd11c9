"""ScanNet reference dataset: the host-side input pipeline, as
``spacap3d_tpu/data/dataset.py`` (reference lib/dataset.py:247-531,
ScannetReferenceDataset). One item = one (scene, object, annotation):
feature assembly, the random 40k-point subsample, augmentation, labels
padded to MAX_NUM_OBJ and the post-augmentation votes, with the JAX
package's changes to the reference:

  * an explicit per-item numpy RNG (derived from (seed, epoch, index))
    instead of the global np.random state;
  * the YZ/XZ flip swaps relation classes 0<->2 on a per-item copy of the
    labels (the reference mutated its scene cache in place);
  * vote labels from vectorized per-instance segment min/max.

The subsample, the row gathers, the floor percentile and the votes run
in the port's host library (``data/native.py``), as the JAX package runs
them in its own: items are equal to the JAX package's bit for bit.
``__getitem__`` draws the subsample first and builds each channel at the
sampled rows alone, in float32 (xyz in float64 through augmentation),
into rows it may be given (the loader's batch): it assembles no
full-scene cloud, which the eval paths' per-index cache still does.

Expected on-disk scene format is the reference preprocessing output
(``<scene>_aligned_vert.npy``, ``_ins_label``, ``_sem_label``,
``_aligned_bbox``, and ``_x/_y/_z.npy`` relation labels).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from spacap3d_tpu_torch.config import GT_VOTE_FACTOR, MAX_NUM_OBJ, MEAN_COLOR_RGB, DataConfig
from spacap3d_tpu_torch.data import native
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu_torch.data.vocabulary import Vocabulary


def random_sampling(n_points: int, num_sample: int, rng: np.random.RandomState):
    """Index choice matching utils/pc_utils.py:32-40 (replace only when
    fewer points than samples). The no-replace path (scenes have at least
    ``num_points``) runs numpy's MT19937 shuffle in the host library,
    advancing ``rng`` as ``rng.choice`` would."""
    if n_points < num_sample:
        return rng.choice(n_points, num_sample, replace=True)
    return native.choice_noreplace_native(n_points, num_sample, rng)


def rot_matrix(axis: int, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(3)
    if axis == 0:      # rotx (utils/pc_utils.py:282-294)
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    elif axis == 1:    # roty
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    else:              # rotz
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def rotate_aligned_boxes_along_axis(boxes: np.ndarray, rot: np.ndarray, axis: int):
    """Axis-aligned box re-fit after small rotation
    (data/scannet/model_util_scannet.py:47-79)."""
    centers = boxes[:, 0:3] @ rot.T
    lengths = boxes[:, 3:6]
    d_axes = [a for a in range(3) if a != axis]
    d1 = lengths[:, d_axes[0]] / 2.0
    d2 = lengths[:, d_axes[1]] / 2.0
    new1 = np.zeros((len(boxes), 4))
    new2 = np.zeros((len(boxes), 4))
    for i, (s1, s2) in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        crn = np.zeros((len(boxes), 3))
        crn[:, 0] = s1 * d1
        crn[:, 1] = s2 * d2
        crn = crn @ rot.T
        new1[:, i] = crn[:, 0]
        new2[:, i] = crn[:, 1]
    new_lengths = lengths.copy()
    new_lengths[:, d_axes[0]] = 2.0 * new1.max(1)
    new_lengths[:, d_axes[1]] = 2.0 * new2.max(1)
    return np.concatenate([centers, new_lengths], axis=1)


# The reference corner ordering, as a host numpy constant (the data loader
# never touches a device tensor).
_CORNER_SIGNS_NP = np.array([
    [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
], np.float32)


def corners_from_center_size(center: np.ndarray, size: np.ndarray) -> np.ndarray:
    """(..., 3) x2 -> (..., 8, 3); reference corner order, heading 0."""
    return center[..., None, :] + 0.5 * size[..., None, :] * _CORNER_SIGNS_NP


@dataclass
class Scene:
    mesh_vertices: np.ndarray      # (N, 3/6/9) xyz [+rgb] [+normal]
    instance_labels: np.ndarray    # (N,)
    semantic_labels: np.ndarray    # (N,)
    instance_bboxes: np.ndarray    # (M, 8): cx cy cz dx dy dz nyu40id objid
    relations: Optional[Dict[str, np.ndarray]] = None  # x/y/z (M, M)
    multiview: Optional[np.ndarray] = None             # (N, 128)


class SceneStore:
    """Loads every referenced scene's arrays into RAM once
    (reference lib/dataset.py:183-227)."""

    def __init__(self, scene_dir: str, scene_ids: Sequence[str],
                 load_relations: bool = False, multiview_hdf5: Optional[str] = None):
        self.scenes: Dict[str, Scene] = {}
        mv_file = None
        if multiview_hdf5 is not None:
            import h5py
            mv_file = h5py.File(multiview_hdf5, "r")
        for sid in scene_ids:
            base = os.path.join(scene_dir, sid)
            relations = None
            if load_relations:
                relations = {
                    ax: np.load(f"{base}_{ax}.npy") for ax in ("x", "y", "z")
                }
            self.scenes[sid] = Scene(
                mesh_vertices=np.load(base + "_aligned_vert.npy"),
                instance_labels=np.load(base + "_ins_label.npy"),
                semantic_labels=np.load(base + "_sem_label.npy"),
                instance_bboxes=np.load(base + "_aligned_bbox.npy"),
                relations=relations,
                multiview=np.array(mv_file[sid]) if mv_file is not None else None,
            )
        if mv_file is not None:
            mv_file.close()

    def __getitem__(self, sid: str) -> Scene:
        return self.scenes[sid]


class ScanReferDataset:
    """Annotation-indexed dataset with fixed-shape numpy outputs."""

    def __init__(
        self,
        annotations: Sequence[dict],
        scenes: SceneStore,
        vocab: Vocabulary,
        dataset_config: ScannetDatasetConfig,
        cfg: DataConfig,
        split: str = "train",
        glove: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.annotations = list(annotations)
        self.scenes = scenes
        self.vocab = vocab
        self.dc = dataset_config
        self.cfg = cfg
        self.split = split
        self.scene_list = sorted({a["scene_id"] for a in self.annotations})
        # Optional GloVe table: when present, items carry ``lang_feat``
        # (300-d embeddings per caption token). Kept for API parity with
        # the reference (lib/dataset.py:101-116) — its model never consumes
        # them (SURVEY.md §2.2); ours doesn't either.
        self.glove = glove
        # Per-index eval cache (see getitem_cached): idx -> (full float64
        # cloud, item template). Guarded by _cache_lock for the threaded
        # grid loader.
        import threading
        self._eval_cache: Dict[int, tuple] = {}
        self._eval_cache_bytes = 0
        self._eval_cache_limit = int(
            os.environ.get("SPACAP_EVAL_CACHE_BYTES", 8 << 30)
        )
        self._cache_lock = threading.Lock()
        self._floors: Dict[str, float] = {}   # scene id -> floor height (_floor)

    def __len__(self):
        return len(self.annotations)

    # ------------------------------------------------------------------
    def _assemble_full_cloud(self, scene: Scene) -> np.ndarray:
        """Full-resolution feature assembly (pre-subsample): xyz [+color]
        [+normal] [+multiview] [+height], returned in the exact contiguous
        float64 form the row gather consumes — so a cached copy yields
        bit-identical subsampled items."""
        cfg = self.cfg
        mesh = scene.mesh_vertices
        feats = [mesh[:, 0:3]]
        if cfg.use_color:
            feats.append((mesh[:, 3:6] - np.asarray(MEAN_COLOR_RGB)) / 256.0)
        if cfg.use_normal:
            feats.append(mesh[:, 6:9])
        if cfg.use_multiview:
            feats.append(scene.multiview)
        point_cloud = np.concatenate(feats, axis=1)
        if cfg.use_height:
            # NOTE: 0.99 is the 0.99th PERCENTILE (not 99th) — a reference
            # quirk (lib/dataset.py:330-333) reproduced deliberately; it
            # effectively picks (near) the lowest z as the floor height.
            floor = native.percentile_z(point_cloud[:, 2], 0.99)
            point_cloud = np.concatenate(
                [point_cloud, (point_cloud[:, 2] - floor)[:, None]], axis=1
            )
        return np.ascontiguousarray(point_cloud, np.float64)

    def getitem_cached(self, idx: int, rng: np.random.RandomState,
                       with_points: bool = True):
        """Fast eval-path item build: everything except the random point
        subsample is deterministic per index on non-augmented val items
        (the RNG's only consumer is ``random_sampling``), so the assembled
        full cloud + all label/language tensors are cached on first touch
        and each later (seed, idx) row costs only choice + row-gather.
        This is what makes the 100-seed mul_eval grid cheap: the reference
        rebuilds the whole item per seed (scripts/eval.py:456-460 reseeds,
        lib/dataset.py:291-531 recomputes). Bit-identical to
        ``__getitem__``.

        ``with_points=False`` skips the host row-gather and returns the
        subsample indices as ``pc_choices`` (uint16 for a scene of at most
        65,535 points, else int32) instead of
        ``point_clouds`` — the device-resident point-table mul_eval path
        gathers the same rows on-device from the f32 scene table
        (see ``full_cloud_f32``; cast and row-select commute elementwise,
        so the gathered rows are bit-identical to the host path)."""
        if self.cfg.augment or self.split == "train":
            raise ValueError("getitem_cached requires a deterministic (no-augment, "
                             "non-train) item; use __getitem__")
        cache = self._eval_cache.get(idx)
        if cache is None:
            with self._cache_lock:
                cache = self._eval_cache.get(idx)
                if cache is None:
                    full_pc = self._assemble_full_cloud(
                        self.scenes[self.annotations[idx]["scene_id"]]
                    )
                    # template: a full item build; its point_clouds (the
                    # only RNG-dependent leaf) is discarded
                    template = self.__getitem__(idx, rng=np.random.RandomState(0))
                    template.pop("point_clouds")
                    nbytes = full_pc.nbytes + sum(
                        v.nbytes for v in template.values()
                        if isinstance(v, np.ndarray)
                    )
                    if self._eval_cache_bytes + nbytes <= self._eval_cache_limit:
                        self._eval_cache[idx] = (full_pc, template)
                        self._eval_cache_bytes += nbytes
                    cache = (full_pc, template)
        full_pc, template = cache
        choices = random_sampling(full_pc.shape[0], self.cfg.num_points, rng)
        item = dict(template)
        if with_points:
            item["point_clouds"] = native.gather_rows(full_pc, choices).astype(np.float32)
        else:
            dt = (np.uint16 if full_pc.shape[0] <= np.iinfo(np.uint16).max
                  else np.int32)
            item["pc_choices"] = np.ascontiguousarray(choices, dt)
        return item

    def full_cloud_f32(self, idx: int) -> np.ndarray:
        """The assembled full-resolution cloud for item ``idx`` as float32
        (the dtype shipped to the device). Populates / reuses the same
        per-index cache as ``getitem_cached``."""
        if idx not in self._eval_cache:
            self.getitem_cached(idx, np.random.RandomState(0),
                                with_points=False)
        cache = self._eval_cache.get(idx)
        if cache is None:  # per-index cache over budget: assemble directly
            full_pc = self._assemble_full_cloud(
                self.scenes[self.annotations[idx]["scene_id"]]
            )
        else:
            full_pc = cache[0]
        return full_pc.astype(np.float32)

    def in_place_leaves(self) -> Dict[str, Tuple[int, ...]]:
        """The shapes of the float32 leaves that ``__getitem__`` writes into
        rows it is given (``out``)."""
        n = self.cfg.num_points
        return {"point_clouds": (n, 3 + self.cfg.input_feature_dim),
                "vote_label": (n, 3 * GT_VOTE_FACTOR)}

    def _floor(self, sid: str, scene: Scene) -> float:
        """The scene's floor height: the 0.99th percentile of its z (the
        height channel of ``_assemble_full_cloud``), kept a scene."""
        floor = self._floors.get(sid)
        if floor is None:
            floor = self._floors[sid] = native.percentile_z(scene.mesh_vertices[:, 2], 0.99)
        return floor

    def _sampled_cloud(self, sid: str, scene: Scene, choices: np.ndarray,
                       out: np.ndarray) -> np.ndarray:
        """``_assemble_full_cloud(scene)[choices]`` cast to float32, built
        at the chosen rows alone: writes every channel but xyz into ``out``
        and returns xyz (float64), which augmentation moves before it goes
        into columns 0-2. Each channel takes the dtype the full cloud gives
        it (colour is computed in float64, the height in the concatenated
        dtype) and is cast once, so ``out`` is bit-equal to the full
        cloud's rows cast to float32."""
        cfg = self.cfg
        mesh = scene.mesh_vertices
        xyz = np.asarray(mesh[choices, 0:3], np.float64)
        dtypes, col = [mesh.dtype], 3
        if cfg.use_color:
            rgb = (mesh[choices, 3:6] - np.asarray(MEAN_COLOR_RGB)) / 256.0
            out[:, col:col + 3] = rgb
            dtypes.append(rgb.dtype)
            col += 3
        if cfg.use_normal:
            native.gather_rows_into(mesh[:, 6:9], choices, out[:, col:col + 3])
            col += 3
        if cfg.use_multiview:
            mv = scene.multiview
            native.gather_rows_into(mv, choices, out[:, col:col + mv.shape[1]])
            dtypes.append(mv.dtype)
            col += mv.shape[1]
        if cfg.use_height:
            z = np.asarray(mesh[choices, 2], np.result_type(*dtypes))
            out[:, col] = z - self._floor(sid, scene)
            col += 1
        if col != out.shape[1]:
            raise ValueError(f"a point of scene {sid} has {col} channels, not {out.shape[1]}")
        return xyz

    def __getitem__(self, idx: int, rng: Optional[np.random.RandomState] = None,
                    out: Optional[Dict[str, np.ndarray]] = None):
        """One item. ``out`` maps leaves of ``in_place_leaves`` to float32
        rows of their shape (a batch's, in the loader): the item writes
        those leaves there and returns the rows as its leaves. The point
        block is gathered once, at the sampled rows, straight into its
        float32 row."""
        if rng is None:
            rng = np.random.RandomState()
        ann = self.annotations[idx]
        sid = ann["scene_id"]
        scene = self.scenes[sid]
        object_id = int(ann["object_id"])
        cfg, dc = self.cfg, self.dc
        rows = {k: _row(out, k, shape) for k, shape in self.in_place_leaves().items()}

        choices = random_sampling(len(scene.mesh_vertices), cfg.num_points, rng)
        point_cloud = rows["point_clouds"]
        xyz = self._sampled_cloud(sid, scene, choices, point_cloud)
        if self.split == "train":
            # only the (train-only) vote computation consumes these
            instance_labels = native.gather_rows(
                np.asarray(scene.instance_labels, np.int64), choices)
            semantic_labels = native.gather_rows(
                np.asarray(scene.semantic_labels, np.int64), choices)

        bboxes = scene.instance_bboxes
        num_bbox = min(bboxes.shape[0], MAX_NUM_OBJ)
        target_bboxes = np.zeros((MAX_NUM_OBJ, 6))
        target_bboxes_mask = np.zeros(MAX_NUM_OBJ)
        target_bboxes[:num_bbox] = bboxes[:MAX_NUM_OBJ, 0:6]
        target_bboxes_mask[:num_bbox] = 1

        relations = None
        if cfg.use_relation and self.split == "train" and scene.relations is not None:
            relations = {ax: scene.relations[ax].copy() for ax in ("x", "y", "z")}

        # ----- augmentation (train only; reference :364-401) -------------
        if cfg.augment:
            if rng.random_sample() > 0.5:   # YZ-plane flip (x -> -x)
                xyz[:, 0] *= -1
                target_bboxes[:, 0] *= -1
                if relations is not None:
                    relations["x"] = _swap02(relations["x"])
            if rng.random_sample() > 0.5:   # XZ-plane flip (y -> -y)
                xyz[:, 1] *= -1
                target_bboxes[:, 1] *= -1
                if relations is not None:
                    relations["y"] = _swap02(relations["y"])
            for axis in (0, 1, 2):          # +-5 degrees about each axis
                angle = (rng.random_sample() * np.pi / 18) - np.pi / 36
                rot = rot_matrix(axis, angle)
                xyz = xyz @ rot.T
                target_bboxes = rotate_aligned_boxes_along_axis(
                    target_bboxes, rot, axis
                )
            # +-0.5 m translation (reference :229-244)
            factor = rng.choice(np.arange(-0.5, 0.501, 0.001), size=3)
            xyz += factor
            target_bboxes[:, 0:3] += factor

        point_cloud[:, 0:3] = xyz

        # ----- relation GT padded to MAX_NUM_OBJ --------------------------
        out_rel = {}
        if relations is not None:
            for ax in ("x", "y", "z"):
                mat = np.zeros((MAX_NUM_OBJ, MAX_NUM_OBJ), np.int64)
                mat[:num_bbox, :num_bbox] = relations[ax][:num_bbox, :num_bbox]
                out_rel[f"{ax}_label"] = mat

        # ----- votes AFTER augmentation ------------------------------------
        # Vote targets only feed the vote loss, which never runs on val
        # items (the eval forward consumes point_clouds + center_label
        # only) — skip the dominant per-item cost there. Deterministic
        # transform: skipping consumes no RNG, so the point subsample
        # stays bit-identical to a votes-on build.
        if self.split == "train":
            point_votes, point_votes_mask = native.compute_votes_native(
                xyz, instance_labels, semantic_labels, dc.nyu40ids)
        else:
            point_votes = np.zeros((len(point_cloud), 9))
            point_votes_mask = np.zeros(len(point_cloud))
        rows["vote_label"][...] = point_votes

        # ----- class / size labels ----------------------------------------
        size_classes = np.zeros(MAX_NUM_OBJ)
        size_residuals = np.zeros((MAX_NUM_OBJ, 3))
        target_sems = np.zeros(MAX_NUM_OBJ)
        class_ind = np.array(
            [dc.nyu40id2class[int(x)] for x in bboxes[:num_bbox, -2]], np.int64
        )
        size_classes[:num_bbox] = class_ind
        size_residuals[:num_bbox] = (
            target_bboxes[:num_bbox, 3:6] - dc.mean_size_arr[class_ind]
        )
        target_sems[:num_bbox] = class_ind

        angle_classes = np.zeros(MAX_NUM_OBJ)
        angle_residuals = np.zeros(MAX_NUM_OBJ)

        # ----- reference object -------------------------------------------
        ref_center = np.zeros(3)
        ref_size_class = 0
        ref_size_residual = np.zeros(3)
        ref_box_label = np.zeros(MAX_NUM_OBJ)
        ref_corners = np.zeros((8, 3))
        obj_ids = bboxes[:num_bbox, -1].astype(np.int64)
        match = np.where(obj_ids == object_id)[0]
        if len(match):
            i = int(match[0])
            ref_box_label[i] = 1
            ref_center = target_bboxes[i, 0:3]
            ref_size_class = size_classes[i]
            ref_size_residual = size_residuals[i]
            ref_corners = corners_from_center_size(
                ref_center, dc.mean_size_arr[int(ref_size_class)] + ref_size_residual
            )

        # ----- all GT corners ---------------------------------------------
        gt_corners = np.zeros((MAX_NUM_OBJ, 8, 3))
        sizes = dc.mean_size_arr[class_ind] + size_residuals[:num_bbox]
        gt_corners[:num_bbox] = corners_from_center_size(
            target_bboxes[:num_bbox, 0:3], sizes
        )
        gt_box_masks = np.zeros(MAX_NUM_OBJ)
        gt_box_masks[:num_bbox] = 1
        gt_object_ids = np.zeros(MAX_NUM_OBJ, np.int64)
        gt_object_ids[:num_bbox] = obj_ids

        # ----- language ----------------------------------------------------
        max_des = cfg.max_des_len
        lang_ids = self.vocab.encode(ann["token"], max_len=max_des)
        lang_label = np.concatenate([[1], lang_ids]).astype(np.int64)
        lang_len = min(len(ann["token"]) + 2, max_des + 2)
        object_name = " ".join(ann["object_name"].split("_"))
        object_cat = dc.raw2label.get(object_name, 17)

        item = {
            "point_clouds": point_cloud,
            "lang_ids": lang_ids.astype(np.int64),
            "lang_label": lang_label,
            "lang_len": np.int64(lang_len),
            "center_label": target_bboxes[:, 0:3].astype(np.float32),
            "heading_class_label": angle_classes.astype(np.int64),
            "heading_residual_label": angle_residuals.astype(np.float32),
            "size_class_label": size_classes.astype(np.int64),
            "size_residual_label": size_residuals.astype(np.float32),
            "num_bbox": np.int64(num_bbox),
            "sem_cls_label": target_sems.astype(np.int64),
            "scene_object_ids": gt_object_ids,
            "box_label_mask": target_bboxes_mask.astype(np.float32),
            "box_label_mask_int": target_bboxes_mask.astype(np.int64),
            "vote_label": rows["vote_label"],
            "vote_label_mask": point_votes_mask.astype(np.int64),
            "dataset_idx": np.int64(idx),
            "ref_box_label": ref_box_label.astype(np.int64),
            "ref_center_label": ref_center.astype(np.float32),
            "ref_size_class_label": np.int64(ref_size_class),
            "ref_size_residual_label": ref_size_residual.astype(np.float32),
            "ref_box_corner_label": ref_corners.astype(np.float64),
            "gt_box_corner_label": gt_corners.astype(np.float64),
            "gt_box_masks": gt_box_masks.astype(np.int64),
            "gt_box_object_ids": gt_object_ids,
            "object_id": np.int64(object_id),
            "ann_id": np.int64(int(ann.get("ann_id", 0))),
            "object_cat": np.int64(object_cat),
        }
        if self.glove is not None:
            emb = np.zeros((max_des + 2, 300), np.float32)
            toks = ["sos"] + list(ann["token"][:max_des]) + ["eos"]
            unk = self.glove.get("unk")
            for i, tok in enumerate(toks):
                vec = self.glove.get(tok, unk)
                if vec is not None:
                    emb[i] = vec
            item["lang_feat"] = emb

        item.update(out_rel)
        return item


def _row(out: Optional[Dict[str, np.ndarray]], key: str, shape) -> np.ndarray:
    """``out[key]``, a float32 array of ``shape``; a new one without it."""
    if out is None or key not in out:
        return np.empty(shape, np.float32)
    row = out[key]
    if row.dtype != np.float32 or row.shape != tuple(shape):
        raise ValueError(f"out[{key!r}] must be float32 of shape {tuple(shape)}, not "
                         f"{row.dtype} {row.shape}")
    return row


def _swap02(mat: np.ndarray) -> np.ndarray:
    out = mat.copy()
    out[mat == 0] = 2
    out[mat == 2] = 0
    return out

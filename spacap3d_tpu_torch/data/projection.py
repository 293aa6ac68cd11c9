"""2D -> 3D multiview feature projection, a copy of
``spacap3d_tpu/data/projection.py`` (equal outputs under ``==``).

Reference lib/projection.py:5-283 (ProjectionHelper) +
scripts/project_multiview_features.py:99-227 semantics, vectorized numpy
(the reference looped in torch on GPU; these run offline on host):

  * camera intrinsics scaled to the feature-map resolution;
  * frustum culling of scene points per frame (corner/normal test);
  * world -> camera (pose inverse) -> pixel projection with a depth
    consistency check against the depth map (+-0.05 m);
  * per-frame feature lookup for visible points; per-scene aggregation
    over frames by max-pool on overlap (--maxpool) into an
    (N, 128) array, stored per scene in an HDF5 file.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

DEPTH_EPS = 0.05


class ProjectionHelper:
    def __init__(self, intrinsic: np.ndarray, depth_min: float, depth_max: float,
                 image_dims: Tuple[int, int]):
        """intrinsic: (4, 4); image_dims: (W, H) of the feature map."""
        self.intrinsic = np.asarray(intrinsic, np.float64)
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.image_dims = image_dims

    @staticmethod
    def scale_intrinsic(intrinsic: np.ndarray, from_dims: Tuple[int, int],
                        to_dims: Tuple[int, int]) -> np.ndarray:
        """Adjust fx/fy/cx/cy when resizing images to the feature map
        resolution (reference compute frustum setup)."""
        out = np.asarray(intrinsic, np.float64).copy()
        sx = to_dims[0] / from_dims[0]
        sy = to_dims[1] / from_dims[1]
        out[0, 0] *= sx
        out[1, 1] *= sy
        out[0, 2] *= (to_dims[0] - 1) / (from_dims[0] - 1)
        out[1, 2] *= (to_dims[1] - 1) / (from_dims[1] - 1)
        return out

    # ------------------------------------------------------------------
    def depth_to_camera(self, px: np.ndarray, py: np.ndarray, depth: np.ndarray):
        x = (px - self.intrinsic[0, 2]) / self.intrinsic[0, 0] * depth
        y = (py - self.intrinsic[1, 2]) / self.intrinsic[1, 1] * depth
        return np.stack([x, y, depth], axis=-1)

    def frustum_corners(self, camera_to_world: np.ndarray) -> np.ndarray:
        """8 world-space frustum corners (reference projection.py:48-90)."""
        w, h = self.image_dims
        corners = []
        for depth in (self.depth_min, self.depth_max):
            for px, py in ((0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)):
                corners.append(self.depth_to_camera(
                    np.float64(px), np.float64(py), np.float64(depth)))
        corners = np.stack(corners)                        # (8, 3) camera
        homog = np.concatenate([corners, np.ones((8, 1))], 1)
        return (homog @ camera_to_world.T)[:, :3]

    def points_in_frustum(self, points: np.ndarray, camera_to_world: np.ndarray):
        """Conservative frustum test via the 6 planes of the corner hull
        (reference projection.py:92-187)."""
        c = self.frustum_corners(camera_to_world)
        # plane sets: near(0-3), far(4-7), and 4 side planes
        quads = [
            (0, 1, 2), (4, 7, 6),           # near (out = -z side), far
            (0, 4, 5), (1, 5, 6),           # top?, right? (orientation fixed below)
            (2, 6, 7), (3, 7, 4),
        ]
        centroid = c.mean(0)
        inside = np.ones(len(points), bool)
        for a, b, d in quads:
            n = np.cross(c[b] - c[a], c[d] - c[a])
            # orient normal toward the frustum centroid
            if np.dot(n, centroid - c[a]) < 0:
                n = -n
            inside &= (points - c[a]) @ n >= 0
        return inside

    # ------------------------------------------------------------------
    def project_points(
        self, points: np.ndarray, depth_map: np.ndarray,
        camera_to_world: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (valid mask (N,), pixel indices (N, 2) [px, py]) for
        points visible in this frame with depth agreement within +-0.05 m
        (reference projection.py:189-260)."""
        w, h = self.image_dims
        world_to_camera = np.linalg.inv(camera_to_world)
        homog = np.concatenate([points, np.ones((len(points), 1))], 1)
        cam = (homog @ world_to_camera.T)[:, :3]
        z = cam[:, 2]
        px = np.round(cam[:, 0] / z * self.intrinsic[0, 0] + self.intrinsic[0, 2])
        py = np.round(cam[:, 1] / z * self.intrinsic[1, 1] + self.intrinsic[1, 2])
        valid = (
            (z >= self.depth_min) & (z <= self.depth_max)
            & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        )
        pxc = np.clip(px, 0, w - 1).astype(np.int64)
        pyc = np.clip(py, 0, h - 1).astype(np.int64)
        depth_at = depth_map[pyc, pxc]
        valid &= (
            (depth_at != 0)
            & (np.abs(depth_at - z) <= DEPTH_EPS)
        )
        return valid, np.stack([pxc, pyc], axis=1)

    def project_features(
        self, points: np.ndarray, features_2d: np.ndarray,
        depth_map: np.ndarray, camera_to_world: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """features_2d: (H, W, C) -> per-point features (N, C) with a
        validity mask; invalid points get zeros (reference :262-283)."""
        valid, pix = self.project_points(points, depth_map, camera_to_world)
        out = np.zeros((len(points), features_2d.shape[-1]), features_2d.dtype)
        out[valid] = features_2d[pix[valid, 1], pix[valid, 0]]
        return out, valid


def aggregate_frames_maxpool(
    points: np.ndarray,
    frames: List[Dict[str, np.ndarray]],
    helper: ProjectionHelper,
) -> np.ndarray:
    """Per-scene multiview feature aggregation: max over frames on
    overlapping points (reference project_multiview_features.py:199-216).
    frames: list of {'features': (H,W,C), 'depth': (H,W), 'pose': (4,4)}.
    """
    c = frames[0]["features"].shape[-1] if frames else 0
    agg = np.zeros((len(points), c), np.float32)
    seen = np.zeros(len(points), bool)
    for fr in frames:
        feats, valid = helper.project_features(
            points, fr["features"], fr["depth"], fr["pose"]
        )
        first = valid & ~seen
        agg[first] = feats[first]
        both = valid & seen
        agg[both] = np.maximum(agg[both], feats[both])
        seen |= valid
    return agg


def project_labels_majority(
    points: np.ndarray,
    frames: List[Dict[str, np.ndarray]],
    helper: ProjectionHelper,
    num_classes: int,
    ignore_zero: bool = False,
) -> np.ndarray:
    """Per-point semantic label by majority vote over frames — the visual
    sanity check of reference scripts/project_multiview_labels.py (labels
    replace features; overlaps resolved by vote instead of max-pool).
    frames carry 'labels' (H, W) int instead of 'features'.

    ``ignore_zero`` drops label-0 votes before the argmax, matching the
    reference's Counter aggregation (:349-355, ``c[0] != 0``): a point
    seen as unlabeled in some frames takes the majority of its NON-zero
    observations, and stays 0 only when it has none."""
    votes = np.zeros((len(points), num_classes), np.int32)
    for fr in frames:
        valid, pix = helper.project_points(points, fr["depth"], fr["pose"])
        lab = fr["labels"][pix[valid, 1], pix[valid, 0]]
        np.add.at(votes, (np.where(valid)[0], lab), 1)
    if ignore_zero:
        votes[:, 0] = 0
    out = votes.argmax(1)
    out[votes.sum(1) == 0] = 0
    return out


def project_labels_fill(
    points: np.ndarray,
    frames: List[Dict[str, np.ndarray]],
    helper: ProjectionHelper,
) -> np.ndarray:
    """First-projection-wins label aggregation — the reference's
    NON-maxpool mode (scripts/project_multiview_labels.py:340-344):
    frame 0's projected labels seed the result; later frames only fill
    points still labeled 0."""
    out = np.zeros(len(points), np.int64)
    for fr in frames:
        valid, pix = helper.project_points(points, fr["depth"], fr["pose"])
        lab = np.zeros(len(points), np.int64)
        lab[valid] = fr["labels"][pix[valid, 1], pix[valid, 0]]
        fill = out == 0
        out[fill] = lab[fill]
    return out


def resample_depth_to_map(depth: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbor resample of a full-resolution depth image onto an
    (h, w) feature/label-map grid (shared by the multiview CLIs)."""
    yi = np.linspace(0, depth.shape[0] - 1, h).astype(int)
    xi = np.linspace(0, depth.shape[1] - 1, w).astype(int)
    return depth[np.ix_(yi, xi)]


def make_map_projection_helper(
    intrinsic: np.ndarray,
    depth_shape: Tuple[int, int],
    fm_dims: Tuple[int, int],
    depth_min: float,
    depth_max: float,
) -> ProjectionHelper:
    """ProjectionHelper whose intrinsic is scaled from the depth image's
    resolution to the (W, H) feature/label-map grid (shared by the
    multiview CLIs)."""
    return ProjectionHelper(
        ProjectionHelper.scale_intrinsic(
            intrinsic, (depth_shape[1], depth_shape[0]), fm_dims),
        depth_min, depth_max, fm_dims,
    )


def write_multiview_hdf5(path: str, scene_features: Dict[str, np.ndarray]):
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        for sid, feats in scene_features.items():
            f.create_dataset(sid, data=feats, compression="gzip")

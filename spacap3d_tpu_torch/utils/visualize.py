"""PLY and OBJ writers for point clouds and coloured box meshes, as
``spacap3d_tpu/utils/visualize.py`` (reference lib/visualize_helper.py:3-153:
write_ply, write_bbox with cylinder-edge box meshes; utils/colors.py's
palette), for ``--eval_visualize``, the axis-aligned mesh export
(``scripts/align_axis.py``) and the scene check (``scripts/visualize_scene.py``).
Each writes the same bytes as the JAX module's.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np

# box palette (one RGB per semantic class), reference utils/colors.py
COLORS = np.array([
    [31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
    [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
    [188, 189, 34], [23, 190, 207], [174, 199, 232], [255, 187, 120],
    [152, 223, 138], [255, 152, 150], [197, 176, 213], [196, 156, 148],
    [247, 182, 210], [199, 199, 199],
], dtype=np.uint8)


def write_ply(points: np.ndarray, path: str, colors: Optional[np.ndarray] = None):
    """points (N, 3); colors (N, 3) uint8 optional."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(len(points)):
            row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


def _cylinder_mesh(p0, p1, radius=0.02, sections=8):
    """Triangulated open cylinder between two points."""
    v = p1 - p0
    length = np.linalg.norm(v)
    if length < 1e-8:
        return np.zeros((0, 3)), np.zeros((0, 3), int)
    v = v / length
    a = np.array([1.0, 0, 0]) if abs(v[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(v, a)
    u /= np.linalg.norm(u)
    w = np.cross(v, u)
    ring = [u * np.cos(2 * np.pi * i / sections) + w * np.sin(2 * np.pi * i / sections)
            for i in range(sections)]
    verts = [c + radius * r for c in (p0, p1) for r in ring]
    faces = []
    for i in range(sections):
        j = (i + 1) % sections
        faces.append([i, j, sections + i])
        faces.append([j, sections + j, sections + i])
    return np.array(verts), np.array(faces, int)


BOX_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7))


def write_bbox(corners: np.ndarray, path: str, color=(0, 255, 0), radius=0.02):
    """corners (8, 3) in the reference ordering -> edge-cylinder mesh ply."""
    all_v, all_f = [], []
    offset = 0
    for a, b in BOX_EDGES:
        v, f = _cylinder_mesh(corners[a], corners[b], radius)
        all_v.append(v)
        all_f.append(f + offset)
        offset += len(v)
    verts = np.concatenate(all_v)
    faces = np.concatenate(all_f)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]} {color[0]} {color[1]} {color[2]}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def write_scene_dump(
    points: np.ndarray,
    pred_corners: Iterable[np.ndarray],
    pred_classes: Iterable[int],
    out_dir: str,
    scene_id: str,
    colors: Optional[np.ndarray] = None,
):
    """Scene ply + one colored bbox ply per prediction (the
    eval --eval_visualize output layout)."""
    os.makedirs(out_dir, exist_ok=True)
    write_ply(points, os.path.join(out_dir, f"{scene_id}.ply"), colors)
    for i, (c, cls) in enumerate(zip(pred_corners, pred_classes)):
        col = COLORS[int(cls) % len(COLORS)]
        write_bbox(np.asarray(c),
                   os.path.join(out_dir, f"{scene_id}_bbox_{i}_cls{int(cls)}.ply"),
                   color=tuple(int(x) for x in col))


def export_axis_aligned_mesh(scan_dir: str, scene_id: str, out_path: str):
    """<scene>_vh_clean_2.ply + axisAlignment -> aligned ascii ply
    (reference data/scannet/align_axis.py + utils/align_scene.py)."""
    from spacap3d_tpu_torch.data.preprocess import read_axis_align_matrix, read_ply_mesh

    base = os.path.join(scan_dir, scene_id, scene_id)
    verts, _ = read_ply_mesh(base + "_vh_clean_2.ply")
    xyz = np.stack([verts["x"], verts["y"], verts["z"]], 1).astype(np.float64)
    align = read_axis_align_matrix(base + ".txt")
    if align is not None:
        homog = np.concatenate([xyz, np.ones((len(xyz), 1))], 1)
        xyz = (homog @ align.T)[:, 0:3]
    colors = None
    if "red" in verts.dtype.names:
        colors = np.stack([verts["red"], verts["green"], verts["blue"]], 1)
    write_ply(xyz, out_path, colors)


def write_obj(points: np.ndarray, path: str, colors: Optional[np.ndarray] = None):
    """Vertex-only .obj writer (reference utils/pc_utils.py export style;
    used by the scene data-integrity check, data/scannet/visualize.py)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(len(points)):
            row = f"v {points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if colors is not None:
                c = colors[i] / 255.0
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")

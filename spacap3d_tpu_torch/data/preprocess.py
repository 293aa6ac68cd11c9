"""Offline ScanNet preprocessing: raw scans -> per-scene npy arrays, a copy of
``spacap3d_tpu/data/preprocess.py`` that writes the same files byte for byte.

Reference data/scannet/{load_scannet_data.py:49-165,
batch_load_scannet_data.py:33-99, scannet_utils.py} semantics with a
dependency-free PLY reader:

  per scene emits  <scene>_vert.npy            (N, 9) xyz rgb normal
                   <scene>_aligned_vert.npy    axis-aligned variant
                   <scene>_sem_label.npy       (N,) nyu40 ids
                   <scene>_ins_label.npy       (N,) instance ids (1-based)
                   <scene>_bbox.npy / _aligned_bbox.npy
                       (M, 8) cx cy cz dx dy dz nyu40id objid
  plus the spatial-relation labels <scene>_{x,y,z}.npy (spatiality.py).

Contracts preserved: the axis-align matrix from the .txt metadata is
applied to vertices before the aligned outputs (load_scannet_data.py:
59-76); instance ids are the segGroup objectId+1 with 0 = unannotated;
boxes are filtered to the 37 detection nyu40 ids (batch_load:29,51-53);
point count capped at 50k by random sampling (batch_load:30,59-64);
vertex normals are area-weighted face-normal averages
(scannet_utils.py:28-48).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from spacap3d_tpu_torch.data.scannet_config import NYU40_OBJ_IDS
from spacap3d_tpu_torch.data.spatiality import generate_relation_labels

MAX_NUM_POINT = 50000


# -----------------------------------------------------------------------------
# PLY reading (self-contained; binary_little_endian + ascii)
# -----------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (vertices structured array, faces (F, 3) int array)."""
    with open(path, "rb") as f:
        line = f.readline().decode("ascii").strip()
        assert line == "ply", f"not a ply file: {path}"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) or ('list', ...)])
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", _PLY_TYPES[parts[2]],
                                   _PLY_TYPES[parts[3]], parts[4]))
                else:
                    cur[2].append((parts[2], _PLY_TYPES[parts[1]]))
            elif line == "end_header":
                break

        verts, faces = None, None
        if fmt == "binary_little_endian":
            for name, cnt, props in elements:
                if name == "vertex":
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    verts = np.frombuffer(f.read(dt.itemsize * cnt), dtype=dt)
                elif name == "face":
                    # assume uniform triangle lists
                    ctype = np.dtype("<" + props[0][1])
                    itype = np.dtype("<" + props[0][2])
                    raw = f.read((ctype.itemsize + 3 * itype.itemsize) * cnt)
                    rec = np.dtype([("n", ctype), ("v", itype, (3,))])
                    faces = np.frombuffer(raw, dtype=rec)["v"]
                else:
                    # skip unknown fixed-size elements
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    f.read(dt.itemsize * cnt)
        elif fmt == "ascii":
            for name, cnt, props in elements:
                rows = [f.readline().decode("ascii").split() for _ in range(cnt)]
                if name == "vertex":
                    dt = np.dtype([(p[0], p[1]) for p in props])
                    verts = np.zeros(cnt, dtype=dt)
                    for i, row in enumerate(rows):
                        for j, p in enumerate(props):
                            verts[i][p[0]] = float(row[j])
                elif name == "face":
                    faces = np.array([[int(x) for x in row[1:4]] for row in rows])
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return verts, faces


def compute_vertex_normals(xyz: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted average of incident face normals, normalized
    (reference scannet_utils.py:28-48)."""
    v0, v1, v2 = xyz[faces[:, 0]], xyz[faces[:, 1]], xyz[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # magnitude = 2*area (weighting)
    normals = np.zeros_like(xyz)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    norm[norm == 0] = 1
    return normals / norm


# -----------------------------------------------------------------------------
# scene export
# -----------------------------------------------------------------------------

def read_axis_align_matrix(meta_path: str) -> Optional[np.ndarray]:
    with open(meta_path) as f:
        for line in f:
            if line.startswith("axisAlignment"):
                vals = [float(x) for x in line.split("=")[1].split()]
                return np.array(vals).reshape(4, 4)
    return None


def read_label_map(tsv_path: str, label_from="raw_category", label_to="nyu40id"):
    with open(tsv_path) as f:
        lines = [line.rstrip("\n") for line in f]
    header = lines[0].split("\t")
    fi, ti = header.index(label_from), header.index(label_to)
    mapping = {}
    for line in lines[1:]:
        parts = line.split("\t")
        mapping[parts[fi]] = int(parts[ti]) if parts[ti] else 0
    return mapping


def export_scene(
    scan_dir: str, scene_id: str, label_map: Dict[str, int],
    output_dir: str, with_relations: bool = True,
    rng: Optional[np.random.RandomState] = None,
):
    """Reads <scan_dir>/<scene>/<scene>_vh_clean_2.ply + .aggregation.json +
    segs.json + .txt and writes the npy bundle into output_dir."""
    rng = rng or np.random.RandomState(0)
    base = os.path.join(scan_dir, scene_id, scene_id)
    verts, faces = read_ply_mesh(base + "_vh_clean_2.ply")
    xyz = np.stack([verts["x"], verts["y"], verts["z"]], 1).astype(np.float64)
    rgb = np.stack([verts["red"], verts["green"], verts["blue"]], 1).astype(np.float64)
    normals = compute_vertex_normals(xyz, faces)
    mesh_vertices = np.concatenate([xyz, rgb, normals], 1)

    with open(base + ".aggregation.json") as f:
        agg = json.load(f)["segGroups"]
    with open(base + "_vh_clean_2.0.010000.segs.json") as f:
        seg_to_verts: Dict[int, list] = {}
        seg_indices = json.load(f)["segIndices"]
        for vi, seg in enumerate(seg_indices):
            seg_to_verts.setdefault(seg, []).append(vi)

    num_verts = len(xyz)
    sem_label = np.zeros(num_verts, np.int64)
    ins_label = np.zeros(num_verts, np.int64)
    object_ids = []
    for group in agg:
        obj_id = group["objectId"]
        nyu = label_map.get(group["label"], 0)
        pts = [vi for seg in group["segments"] for vi in seg_to_verts.get(seg, [])]
        sem_label[pts] = nyu
        ins_label[pts] = obj_id + 1
        object_ids.append((obj_id, nyu))

    align = read_axis_align_matrix(base + ".txt")
    aligned = mesh_vertices.copy()
    if align is not None:
        homog = np.concatenate([xyz, np.ones((num_verts, 1))], 1)
        aligned[:, 0:3] = (homog @ align.T)[:, 0:3]

    def boxes_from(pc):
        rows = []
        for obj_id, nyu in sorted(object_ids):
            if nyu not in NYU40_OBJ_IDS:
                continue
            pts = pc[ins_label == obj_id + 1, 0:3]
            if len(pts) == 0:
                continue
            mn, mx = pts.min(0), pts.max(0)
            rows.append(np.concatenate(
                [(mn + mx) / 2.0, mx - mn, [nyu, obj_id]]
            ))
        return np.array(rows) if rows else np.zeros((0, 8))

    bboxes = boxes_from(mesh_vertices)
    aligned_bboxes = boxes_from(aligned)

    if num_verts > MAX_NUM_POINT:
        choice = rng.choice(num_verts, MAX_NUM_POINT, replace=False)
        mesh_vertices = mesh_vertices[choice]
        aligned = aligned[choice]
        sem_label = sem_label[choice]
        ins_label = ins_label[choice]

    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, scene_id)
    np.save(out + "_vert.npy", mesh_vertices)
    np.save(out + "_aligned_vert.npy", aligned)
    np.save(out + "_sem_label.npy", sem_label)
    np.save(out + "_ins_label.npy", ins_label)
    np.save(out + "_bbox.npy", bboxes)
    np.save(out + "_aligned_bbox.npy", aligned_bboxes)
    if with_relations and len(aligned_bboxes):
        for ax, mat in generate_relation_labels(aligned_bboxes).items():
            np.save(out + f"_{ax}.npy", mat)
    return out


def batch_export(scan_dir, scene_ids, tsv_path, output_dir,
                 with_relations=True, verbose=True):
    label_map = read_label_map(tsv_path)
    done, failed = [], []
    for sid in scene_ids:
        try:
            export_scene(scan_dir, sid, label_map, output_dir, with_relations)
            done.append(sid)
            if verbose:
                print(f"exported {sid}")
        except Exception as e:  # noqa: BLE001 — batch tools report and continue
            failed.append((sid, str(e)))
            if verbose:
                print(f"FAILED {sid}: {e}")
    return done, failed

"""Spatial-relation ground truth, as ``spacap3d_tpu/data/spatiality.py``
(reference data/scannet/generate_spatiality_label.py:49-141), vectorised
numpy. For every ordered object pair (a, b) and each axis the class is
one of {0, 1, 2}:

z-axis: a is above b iff zmin_a - zmin_b >= 0.3 * h_b; the pair (a, b) of
  such an a takes class 0, its transpose class 2, and every other pair 1.
x/y-axis: with a's extent [amin, amax] and b's 30% / 70% landmarks,
    same (1):  |amax - bmax| <= 0.1 len_b and |amin - bmin| <= 0.1 len_b
               (applied symmetrically, overrides the rest)
    forward:   (amax > bmax and amin >= bmin)
               or (amax <= bmax and amax > b_70 and amin > b_30)
    backward:  amax < b_70 and amin > bmin and amin < b_30 (marks the
               partner as forward)
  a forward pair takes class 0, its transpose class 2.

Boxes: (M, >= 6) rows [cx, cy, cz, dx, dy, dz, ...]; the matrices are
(M, M) uint32 in row order. ``plot_relation_heatmap`` draws one as the JAX
module's does (matplotlib, imported when called).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

Z_UPPER_THRESH = 0.3
XY_LOW_FRAC = 0.3
XY_HIGH_FRAC = 0.7
XY_SAME_EPS_FRAC = 0.1


def _classes(signed: np.ndarray) -> np.ndarray:
    """+1 -> 0, 0 -> 1, -1 -> 2."""
    out = np.zeros(signed.shape, np.uint32)
    out[signed == 0] = 1
    out[signed == -1] = 2
    out[signed == 1] = 0
    return out


def z_relation(bboxes: np.ndarray) -> np.ndarray:
    """(M, >= 6) boxes -> (M, M) uint32."""
    zmin = bboxes[:, 2] - bboxes[:, 5] * 0.5
    h = bboxes[:, 5]
    diff = zmin[:, None] - zmin[None, :]            # a minus b
    up = (diff >= Z_UPPER_THRESH * h[None, :]).astype(int)
    mark = np.argwhere(up == 1)
    signed = up.copy()
    signed[mark[:, 1], mark[:, 0]] = -1
    return _classes(signed)


def xy_relation(bboxes: np.ndarray, dim: int) -> np.ndarray:
    """dim 0 for x, 1 for y -> (M, M) uint32."""
    length = bboxes[:, dim + 3]
    amin = (bboxes[:, dim] - length * 0.5)[:, None]
    amax = (bboxes[:, dim] + length * 0.5)[:, None]
    bmin = (bboxes[:, dim] - length * 0.5)[None, :]
    bmax = (bboxes[:, dim] + length * 0.5)[None, :]
    b_low = bmin + (length * XY_LOW_FRAC)[None, :]
    b_high = bmin + (length * XY_HIGH_FRAC)[None, :]
    eps = (length * XY_SAME_EPS_FRAC)[None, :]

    same = (np.abs(amax - bmax) <= eps) & (np.abs(amin - bmin) <= eps)
    forward = (((amax > bmax) & (amin >= bmin))
               | ((amax <= bmax) & (amax > b_high) & (amin > b_low))).astype(int)
    back = (amax < b_high) & (amin > bmin) & (amin < b_low)

    mb = np.argwhere(back)
    forward[mb[:, 1], mb[:, 0]] = 1
    mf = np.argwhere(forward == 1)
    signed = forward.copy()
    signed[mf[:, 1], mf[:, 0]] = -1
    mz = np.argwhere(same)
    signed[mz[:, 1], mz[:, 0]] = 0
    signed[mz[:, 0], mz[:, 1]] = 0
    return _classes(signed)


def generate_relation_labels(bboxes: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-scene ground truth: {'x', 'y', 'z'} -> (M, M) uint32."""
    return {"x": xy_relation(bboxes, 0), "y": xy_relation(bboxes, 1), "z": z_relation(bboxes)}


def plot_relation_heatmap(
    matrix: np.ndarray,
    labels,
    axis: str,
    scene_id: str,
    save_path: str | None = None,
    show: bool = False,
    dryrun: bool = False,
    verbose: bool = False,
):
    """Annotated relation-matrix heatmap: the reference's data-integrity
    view (generate_spatiality_label.py:77-100,143-170, a seaborn heatmap with
    '<objid>-<name>' tick labels), drawn with matplotlib alone, each cell
    annotated with its class. Returns the figure."""
    try:
        import matplotlib
        matplotlib.use("Agg" if not show else matplotlib.get_backend())
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError("matplotlib is required for --visualize/--savefig") from e

    m = matrix.shape[0]
    fig, ax = plt.subplots(
        figsize=(max(6, m * 0.6), max(6, m * 0.6)), dpi=80,
        facecolor="w", edgecolor="k",
    )
    im = ax.imshow(matrix, cmap="cubehelix_r", vmin=matrix.min(),
                   vmax=max(matrix.max(), 1))
    ax.set_xticks(range(m))
    ax.set_yticks(range(m))
    ax.set_xticklabels(labels, rotation=90)
    ax.set_yticklabels(labels)
    for i in range(m):
        for j in range(m):
            ax.text(j, i, f"{matrix[i, j]:.2f}", ha="center", va="center",
                    fontsize=7)
    ax.set_title(
        f"Relation along {axis.upper()}-axis for {scene_id}"
    )
    fig.colorbar(im, shrink=0.82)
    fig.tight_layout()
    if verbose:
        print(f"Relation along {axis.upper()}-axis for {scene_id}")
    if save_path and not dryrun:
        fig.savefig(save_path)
        if verbose:
            print("saving", save_path)
    if show:  # pragma: no cover - interactive
        plt.show()
    return fig

"""Scene data-integrity view: an exported npy bundle -> .obj / .ply, as the
JAX package's ``scripts/visualize_scene.py`` (reference
data/scannet/visualize.py):

    python -m spacap3d_tpu_torch.scripts.visualize_scene --scene_dir D --scene_id S --out_dir O

Writes the scene's points (coloured, or by instance with
``--color_by_instance``) and each GT box as a cylinder-edge mesh.
"""
import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene_dir", required=True)
    p.add_argument("--scene_id", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--color_by_instance", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from spacap3d_tpu_torch.data.dataset import corners_from_center_size
    from spacap3d_tpu_torch.utils.visualize import COLORS, write_bbox, write_obj, write_ply

    base = os.path.join(args.scene_dir, args.scene_id)
    verts = np.load(base + "_aligned_vert.npy")
    xyz = verts[:, :3]
    rgb = verts[:, 3:6].astype(np.uint8) if verts.shape[1] >= 6 else None
    if args.color_by_instance:
        ins = np.load(base + "_ins_label.npy")
        rgb = COLORS[ins.astype(int) % len(COLORS)]
    os.makedirs(args.out_dir, exist_ok=True)
    write_obj(xyz, os.path.join(args.out_dir, f"{args.scene_id}.obj"), rgb)
    write_ply(xyz, os.path.join(args.out_dir, f"{args.scene_id}.ply"), rgb)

    boxes = np.load(base + "_aligned_bbox.npy")
    for i, row in enumerate(boxes):
        corners = corners_from_center_size(row[0:3], row[3:6])
        col = COLORS[int(row[6]) % len(COLORS)]
        write_bbox(corners, os.path.join(
            args.out_dir, f"{args.scene_id}_gtbox_{i}.ply"),
            color=tuple(int(x) for x in col))
    print(f"wrote {args.out_dir}/{args.scene_id}.obj + {len(boxes)} gt boxes")


if __name__ == "__main__":
    main()

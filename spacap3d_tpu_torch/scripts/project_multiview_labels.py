"""Per-frame ENet semantic labels onto a scene -> coloured PLY, as the JAX
package's ``scripts/project_multiview_labels.py``:

    python -m spacap3d_tpu_torch.scripts.project_multiview_labels \\
        --scene_dir D --frames_root F --out_root O [--maxpool] [--device cuda]

Runs the ENet classifier on each colour frame (per-pixel NYU40 argmax of the
41-class logits at the 1/8 map), projects every frame's labels onto the
exported scene points (frustum culling and depth consistency), aggregates
them (``--maxpool``: majority vote over frames with label 0 excluded, the
reference's Counter loop, :345-355; without it the first projection wins
and later frames fill points still unlabelled, :340-344) and writes
``<out_root>/<scene_id>.ply`` coloured by the ScanNet NYU40 palette
(reference create_color_palette, :78-101). ``--device`` (default ``cuda``,
which raises without CUDA; ``cpu`` when asked) is the port's own.

Expected per-scene frame data under ``<frames_root>/<scene>/``:
    color/<f>.jpg  depth/<f>.png (16-bit, mm)  pose/<f>.txt  intrinsic.txt
"""
import argparse
import os

# standard ScanNet NYU40 visualization palette (index = nyu40 id)
NYU40_PALETTE = [
    (0, 0, 0), (174, 199, 232), (152, 223, 138), (31, 119, 180),
    (255, 187, 120), (188, 189, 34), (140, 86, 75), (255, 152, 150),
    (214, 39, 40), (197, 176, 213), (148, 103, 189), (196, 156, 148),
    (23, 190, 207), (178, 76, 76), (247, 182, 210), (66, 188, 102),
    (219, 219, 141), (140, 57, 197), (202, 185, 52), (51, 176, 203),
    (200, 54, 131), (92, 193, 61), (78, 71, 183), (172, 114, 82),
    (255, 127, 14), (91, 163, 138), (153, 98, 156), (140, 153, 101),
    (158, 218, 229), (100, 125, 154), (178, 127, 135), (120, 185, 128),
    (146, 111, 194), (44, 160, 44), (112, 128, 144), (96, 207, 209),
    (227, 119, 194), (213, 92, 176), (94, 106, 211), (82, 84, 163),
    (100, 85, 144),
]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene_id", type=str, default="-1",
                   help="one scene, or -1 for every scene under frames_root")
    p.add_argument("--scene_dir", required=True,
                   help="exported scene npys (scannet_data)")
    p.add_argument("--frames_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--enet_ckpt", type=str, default="",
                   help=".pth (reference keys) or pickled numpy params")
    p.add_argument("--maxpool", action="store_true",
                   help="majority vote over frames, label 0 excluded "
                        "(reference :345-355); default: first projection "
                        "wins, later frames fill zeros (:340-344)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--depth_min", type=float, default=0.1)
    p.add_argument("--depth_max", type=float, default=4.0)
    p.add_argument("--image_h", type=int, default=256)
    p.add_argument("--image_w", type=int, default=328)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs ENet on the CPU")
    return p.parse_args(argv)


def label_frames(model, imgs):
    """Per-pixel argmax of ENet's logits: ``imgs`` (B, H, W, 3) float32 ->
    (B, H/8, W/8) int32 numpy."""
    import torch

    dev = next(model.parameters()).device
    with torch.no_grad():
        _, logits = model(torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2))
    return logits.argmax(1).to(torch.int32).cpu().numpy()


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from spacap3d_tpu_torch.data.projection import (
        make_map_projection_helper,
        project_labels_fill,
        project_labels_majority,
        resample_depth_to_map,
    )
    from spacap3d_tpu_torch.scripts.compute_multiview_features import load_image
    from spacap3d_tpu_torch.scripts.project_multiview_features import read_depth, read_pose
    from spacap3d_tpu_torch.utils.convert_enet import load_enet
    from spacap3d_tpu_torch.utils.visualize import write_ply

    model = load_enet(args.enet_ckpt, device=args.device)
    scenes = ([args.scene_id] if args.scene_id != "-1"
              else sorted(os.listdir(args.frames_root)))
    os.makedirs(args.out_root, exist_ok=True)
    palette = np.asarray(NYU40_PALETTE, np.uint8)
    for scene in scenes:
        frame_dir = os.path.join(args.frames_root, scene)
        color_dir = os.path.join(frame_dir, "color")
        vert_path = os.path.join(args.scene_dir, scene + "_aligned_vert.npy")
        if not os.path.isdir(color_dir) or not os.path.exists(vert_path):
            continue
        frame_files = sorted(os.listdir(color_dir))
        if not frame_files:
            print(f"{scene}: no frames, skipping")
            continue
        points = np.load(vert_path)[:, :3]
        intr = np.loadtxt(os.path.join(frame_dir, "intrinsic.txt")).reshape(4, 4)

        imgs = np.stack([
            load_image(os.path.join(color_dir, f), args.image_h, args.image_w)
            for f in frame_files
        ])
        label_maps = np.concatenate([
            label_frames(model, imgs[i:i + args.batch_size])
            for i in range(0, len(imgs), args.batch_size)
        ])

        frames = []
        depth_shape = None
        for f, labels in zip(frame_files, label_maps):
            fid = os.path.splitext(f)[0]
            depth = read_depth(os.path.join(frame_dir, "depth", fid + ".png"))
            depth_shape = depth.shape
            frames.append({
                "labels": labels,
                "depth": resample_depth_to_map(depth, *labels.shape[:2]),
                "pose": read_pose(os.path.join(frame_dir, "pose", fid + ".txt")),
            })
        fm_dims = (label_maps.shape[2], label_maps.shape[1])       # (W, H)
        helper = make_map_projection_helper(
            intr, depth_shape, fm_dims, args.depth_min, args.depth_max)
        if args.maxpool:
            labels = project_labels_majority(points, frames, helper,
                                             num_classes=41, ignore_zero=True)
        else:
            labels = project_labels_fill(points, frames, helper)
        out = os.path.join(args.out_root, scene + ".ply")
        write_ply(points, out, colors=palette[np.clip(labels, 0, 40)])
        print(f"{scene}: {len(frames)} frames -> {out}")


if __name__ == "__main__":
    main()

"""Per-frame ENet features onto scene points -> HDF5, as the JAX package's
``scripts/project_multiview_features.py`` (reference
scripts/project_multiview_features.py:99-227, ``--maxpool`` mode):

    python -m spacap3d_tpu_torch.scripts.project_multiview_features \\
        --scene_dir D --frames_root F --features_root E --out enet_feats_maxpool.hdf5

For every scene, projects each frame's (H/8, W/8, 128) feature map onto the
exported scene points (frustum culling and depth consistency,
``data/projection.py``), max-pools overlaps across frames and stores the
(N, 128) result under the scene key. Host code (numpy and h5py): it runs no
device.

Expected per-scene frame data under ``<frames_root>/<scene>/``:
    color/<f>.jpg  depth/<f>.png (16-bit, mm)  pose/<f>.txt  intrinsic.txt
"""
import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene_dir", required=True,
                   help="exported scene npys (scannet_data)")
    p.add_argument("--frames_root", required=True)
    p.add_argument("--features_root", required=True,
                   help="per-frame ENet feature npys")
    p.add_argument("--out", required=True, help="output hdf5 path")
    p.add_argument("--depth_min", type=float, default=0.1)
    p.add_argument("--depth_max", type=float, default=4.0)
    p.add_argument("--maxpool", action="store_true", default=True)
    return p.parse_args(argv)


def read_pose(path):
    import numpy as np
    return np.loadtxt(path).reshape(4, 4)


def read_depth(path):
    import numpy as np
    try:
        from PIL import Image
        d = np.asarray(Image.open(path))
    except ImportError:
        import imageio.v2 as imageio  # pragma: no cover
        d = imageio.imread(path)
    return d.astype("float64") / 1000.0


def project_scene(points, frame_dir, feat_dir, depth_min, depth_max):
    """One scene's per-frame feature maps under ``feat_dir`` onto ``points``
    (N, 3), with the depth, pose and intrinsic of ``frame_dir`` -> ((N, 128)
    max-pooled over the frames, the frame count), or None where ``feat_dir``
    is empty."""
    import numpy as np

    from spacap3d_tpu_torch.data.projection import (
        aggregate_frames_maxpool,
        make_map_projection_helper,
        resample_depth_to_map,
    )

    intr = np.loadtxt(os.path.join(frame_dir, "intrinsic.txt")).reshape(4, 4)
    frame_files = sorted(os.listdir(feat_dir))
    if not frame_files:
        return None
    frames = []
    fm_dims = None
    depth_shape = None
    for f in frame_files:
        fid = os.path.splitext(f)[0]
        feats = np.load(os.path.join(feat_dir, f))
        depth = read_depth(os.path.join(frame_dir, "depth", fid + ".png"))
        pose = read_pose(os.path.join(frame_dir, "pose", fid + ".txt"))
        fm_dims = (feats.shape[1], feats.shape[0])  # (W, H)
        depth_shape = depth.shape
        frames.append({
            "features": feats,
            "depth": resample_depth_to_map(depth, *feats.shape[:2]),
            "pose": pose,
        })
    helper = make_map_projection_helper(intr, depth_shape, fm_dims, depth_min, depth_max)
    return aggregate_frames_maxpool(points, frames, helper), len(frames)


def main(argv=None):
    args = parse_args(argv)
    import h5py
    import numpy as np

    with h5py.File(args.out, "a") as out_f:
        for scene in sorted(os.listdir(args.features_root)):
            if scene in out_f:
                continue
            vert_path = os.path.join(args.scene_dir, scene + "_aligned_vert.npy")
            if not os.path.exists(vert_path):
                continue
            got = project_scene(np.load(vert_path)[:, :3],
                                os.path.join(args.frames_root, scene),
                                os.path.join(args.features_root, scene),
                                args.depth_min, args.depth_max)
            if got is None:
                print(f"{scene}: no frames, skipping")
                continue
            agg, n_frames = got
            out_f.create_dataset(scene, data=agg.astype("float32"),
                                 compression="gzip")
            print(f"{scene}: {n_frames} frames -> {agg.shape}")


if __name__ == "__main__":
    main()

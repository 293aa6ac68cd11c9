"""Spatial-relation heatmaps, as the JAX package's
``scripts/visualize_spatiality.py`` (the reference's
``generate_spatiality_label.py --visualize/--savefig`` mode, :77-100,
143-170, argparse surface :198-216):

    python -m spacap3d_tpu_torch.scripts.visualize_spatiality --scannet_data D \\
        --scene_id S --axis x --savefig

Draws the (M, M) relation matrix of one scene and axis as an annotated
heatmap with '<objid>-<nyu40id>' tick labels, from the precomputed
``<scene>_<axis>.npy`` or, with ``--regenerate`` or without one, from
``<scene>_aligned_bbox.npy``. Needs matplotlib.
"""
import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scannet_data", type=str, required=True,
                   help="directory with <scene>_aligned_bbox.npy / _<axis>.npy")
    p.add_argument("--scene_id", type=str, default="scene0011_00")
    p.add_argument("--axis", type=str, default="x", choices=["x", "y", "z"])
    p.add_argument("--visualize", action="store_true", help="plt.show()")
    p.add_argument("--savefig", action="store_true",
                   help="save <scene>_<axis>.png next to the npy files")
    p.add_argument("--regenerate", action="store_true",
                   help="recompute from the bbox file instead of loading the npy")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--dryrun", action="store_true",
                   help="do not actually write anything")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from spacap3d_tpu_torch.data.spatiality import (
        generate_relation_labels,
        plot_relation_heatmap,
    )

    bbox_path = os.path.join(args.scannet_data,
                             f"{args.scene_id}_aligned_bbox.npy")
    bboxes = np.load(bbox_path)
    rel_path = os.path.join(args.scannet_data,
                            f"{args.scene_id}_{args.axis}.npy")
    if not args.regenerate and os.path.exists(rel_path):
        matrix = np.load(rel_path)
    else:
        matrix = generate_relation_labels(bboxes)[args.axis]

    # '<objid>-<label>' ticks like the reference (it reads a per-scene
    # obj.json; the nyu40 id from the bbox rows is always available)
    labels = [f"{int(r[7])}-{int(r[6])}" for r in bboxes]
    save_path = os.path.join(args.scannet_data,
                             f"{args.scene_id}_{args.axis}.png") \
        if args.savefig else None
    plot_relation_heatmap(
        matrix, labels, args.axis, args.scene_id,
        save_path=save_path, show=args.visualize,
        dryrun=args.dryrun, verbose=args.verbose,
    )
    if args.verbose and not (args.savefig or args.visualize):
        print(matrix)


if __name__ == "__main__":
    main()

"""Spatial-relation labels, as the JAX package's
``scripts/generate_spatiality_label.py`` (reference
data/scannet/generate_spatiality_label.py, argparse surface :198-216):

    python -m spacap3d_tpu_torch.scripts.generate_spatiality_label \\
        --data_root data [--dataset scanrefer] [--split train]

Writes ``<scene>_{x,y,z}.npy`` relation matrices from each scene's
``<scene>_aligned_bbox.npy`` for every scene of the chosen dataset and split
(``data/spatiality.py``). ``batch_load_scannet_data`` already writes them in
its export pass; this CLI serves the reference's two-step flow and
regeneration. ``--visualize`` / ``--savefig`` draw the heatmap of one scene
and axis through ``visualize_spatiality``.
"""
import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default="scanrefer",
                   choices=["scanrefer", "nr3d"])
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--data_root", type=str,
                   default=os.environ.get("SPACAP_DATA_ROOT", "data"),
                   help="root holding ScanRefer_filtered_<split>.json / "
                        "nr3d_<split>.json and scannet/scannet_data")
    p.add_argument("--scannet_data", type=str, default="",
                   help="override the npy dir (default "
                        "<data_root>/scannet/scannet_data)")
    p.add_argument("--verbose", action="store_true")
    # visualization mode (reference :77-100)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--scene_id", type=str, default="scene0011_00")
    p.add_argument("--axis", type=str, default="x", choices=["x", "y", "z"])
    p.add_argument("--savefig", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    scannet_data = args.scannet_data or os.path.join(
        args.data_root, "scannet", "scannet_data")

    if args.visualize or args.savefig:
        from spacap3d_tpu_torch.scripts import visualize_spatiality

        viz_argv = ["--scannet_data", scannet_data,
                    "--scene_id", args.scene_id, "--axis", args.axis]
        if args.visualize:
            viz_argv.append("--visualize")
        if args.savefig:
            viz_argv.append("--savefig")
        if args.verbose:
            viz_argv.append("--verbose")
        return visualize_spatiality.main(viz_argv)

    import numpy as np

    from spacap3d_tpu_torch.data.spatiality import generate_relation_labels

    ann_file = (f"ScanRefer_filtered_{args.split}.json"
                if args.dataset == "scanrefer" else f"nr3d_{args.split}.json")
    with open(os.path.join(args.data_root, ann_file)) as f:
        anns = json.load(f)
    scene_ids = sorted({a["scene_id"] for a in anns})
    n_ok, n_skip = 0, 0
    for sid in scene_ids:
        bbox_path = os.path.join(scannet_data, f"{sid}_aligned_bbox.npy")
        if not os.path.exists(bbox_path):
            n_skip += 1
            if args.verbose:
                print(f"skip {sid}: no {bbox_path}")
            continue
        bboxes = np.load(bbox_path)
        if not len(bboxes):
            n_skip += 1
            continue
        for ax, mat in generate_relation_labels(bboxes).items():
            np.save(os.path.join(scannet_data, f"{sid}_{ax}.npy"), mat)
        n_ok += 1
        if args.verbose:
            print(f"labeled {sid} ({len(bboxes)} objects)")
    print(f"spatiality labels: {n_ok} scenes written, {n_skip} skipped "
          f"-> {scannet_data}")


if __name__ == "__main__":
    main()

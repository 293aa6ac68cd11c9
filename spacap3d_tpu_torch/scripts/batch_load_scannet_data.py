"""ScanNet scene export, as the JAX package's
``scripts/batch_load_scannet_data.py`` (reference
data/scannet/batch_load_scannet_data.py):

    python -m spacap3d_tpu_torch.scripts.batch_load_scannet_data \\
        --scans_dir data/scannet/scans --output_dir data/scannet/scannet_data

Reads each scene's ``_vh_clean_2.ply``, ``.aggregation.json``,
``segs.json`` and ``.txt`` and writes the
``<scene>_{vert,aligned_vert,sem_label,ins_label,bbox,aligned_bbox}.npy``
bundle (50k-point cap, 37-class id filter; ``data/preprocess.py``), with
the spatial-relation labels ``<scene>_{x,y,z}.npy`` in the same pass
unless ``--no_relations`` (the reference writes them in a second step,
``generate_spatiality_label``). The files equal the JAX CLI's byte for
byte.
"""
import argparse
import os

from spacap3d_tpu_torch.data.scannet_config import META_DIR


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scans_dir", type=str, default="data/scannet/scans",
                   help="ScanNet release: <scans_dir>/<scene_id>/...")
    p.add_argument("--output_dir", type=str,
                   default="data/scannet/scannet_data")
    p.add_argument("--label_tsv", type=str,
                   default=os.path.join(META_DIR,
                                        "scannetv2-labels.combined.tsv"),
                   help="raw-label -> nyu40 id map (the port's copy by "
                        "default)")
    p.add_argument("--scene_list", type=str, default="",
                   help="optional txt file of scene ids (one per line); "
                        "default: the train+val split lists, "
                        "filtered to scenes present under --scans_dir "
                        "(the reference uses its trainval list)")
    p.add_argument("--no_relations", action="store_true",
                   help="skip the x/y/z spatial-relation labels "
                        "(reference parity: it generates them in a "
                        "separate script)")
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from spacap3d_tpu_torch.data.preprocess import batch_export

    if args.scene_list:
        with open(args.scene_list) as f:
            scene_ids = [ln.strip() for ln in f if ln.strip()]
    else:
        splits = []
        for split in ("scannetv2_train.txt", "scannetv2_val.txt"):
            with open(os.path.join(META_DIR, split)) as f:
                splits += [ln.strip() for ln in f if ln.strip()]
        present = set(os.listdir(args.scans_dir)) \
            if os.path.isdir(args.scans_dir) else set()
        scene_ids = [s for s in splits if s in present]
    if not scene_ids:
        raise SystemExit(f"no scenes to export under {args.scans_dir}")

    done, failed = batch_export(
        args.scans_dir, scene_ids, args.label_tsv, args.output_dir,
        with_relations=not args.no_relations, verbose=not args.quiet,
    )
    print(f"exported {len(done)} scenes to {args.output_dir}"
          + (f"; {len(failed)} FAILED" if failed else ""))
    if failed:
        for sid, err in failed:
            print(f"  {sid}: {err}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()

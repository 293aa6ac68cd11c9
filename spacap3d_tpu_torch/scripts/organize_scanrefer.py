"""``ScanRefer_filtered_organized.json``, as the JAX package's
``scripts/organize_scanrefer.py`` (reference scripts/organize_scanrefer.py):

    python -m spacap3d_tpu_torch.scripts.organize_scanrefer --data_root data

Reshapes the flat annotation list into {scene_id: {object_id: {ann_id:
entry}}}. Reads ``ScanRefer_filtered.json`` when present (the reference's
input), otherwise the train and val split files.
"""
import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, default="data")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from spacap3d_tpu_torch.data.organize import organize

    combined = os.path.join(args.data_root, "ScanRefer_filtered.json")
    if os.path.exists(combined):
        with open(combined) as f:
            anns = json.load(f)
    else:
        anns = []
        for split in ("train", "val"):
            path = os.path.join(args.data_root,
                                f"ScanRefer_filtered_{split}.json")
            if os.path.exists(path):
                with open(path) as f:
                    anns += json.load(f)
    if not anns:
        sys.exit(f"no ScanRefer annotation files under {args.data_root} "
                 "(expected ScanRefer_filtered.json or the "
                 "_train/_val split files)")
    out = os.path.join(args.data_root, "ScanRefer_filtered_organized.json")
    with open(out, "w") as f:
        json.dump(organize(anns), f, indent=4)
    print("Saving", out)


if __name__ == "__main__":
    main()

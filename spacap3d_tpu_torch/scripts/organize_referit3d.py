"""``nr3d_organized.json``, as the JAX package's
``scripts/organize_referit3d.py`` (reference scripts/organize_referit3d.py):

    python -m spacap3d_tpu_torch.scripts.organize_referit3d --csv data/nr3d.csv --data_root data

Reshapes the Nr3D annotations into {scene_id: {object_id: {ann_id: entry}}}.
Reads the ``nr3d_{train,val}.json`` split files when present (written by
``split_referit3d``, which also writes the organized file), otherwise parses
the csv.
"""
import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--csv", type=str, default="data/nr3d.csv")
    p.add_argument("--data_root", type=str, default="data")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from spacap3d_tpu_torch.data.organize import organize, split_referit3d

    paths = [os.path.join(args.data_root, f"nr3d_{s}.json")
             for s in ("train", "val")]
    out = os.path.join(args.data_root, "nr3d_organized.json")
    if all(os.path.exists(p) for p in paths):
        anns = []
        for p in paths:
            with open(p) as f:
                anns += json.load(f)
        with open(out, "w") as f:
            json.dump(organize(anns), f, indent=4)
    elif os.path.exists(args.csv):
        # the split writes the (train + val) organized file itself: the
        # same content as the json path above
        split_referit3d(args.csv, args.data_root)
    else:
        sys.exit(f"need nr3d_train.json + nr3d_val.json under "
                 f"{args.data_root} or the csv at {args.csv}")
    print("Saving", out)


if __name__ == "__main__":
    main()

"""The ReferIt3D / Nr3D csv -> ``nr3d_train.json`` and ``nr3d_val.json``, as
the JAX package's ``scripts/split_referit3d.py`` (reference
scripts/split_referit3d.py):

    python -m spacap3d_tpu_torch.scripts.split_referit3d --csv data/nr3d.csv --data_root data

The csv rows take the ScanRefer annotation schema and split by the ScanNet
train / val scene lists; ``nr3d_organized.json`` is written too (the
reference writes it in the separate ``organize_referit3d`` step).
"""
import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--csv", type=str, default="data/nr3d.csv")
    p.add_argument("--data_root", type=str, default="data")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from spacap3d_tpu_torch.data.organize import split_referit3d

    train, val = split_referit3d(args.csv, args.data_root)
    print(f"nr3d_train.json: {len(train)}  nr3d_val.json: {len(val)}")


if __name__ == "__main__":
    main()

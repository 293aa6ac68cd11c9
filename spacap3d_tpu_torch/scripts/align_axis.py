"""Axis-aligned scene meshes, as the JAX package's ``scripts/align_axis.py``
(reference data/scannet/align_axis.py):

    python -m spacap3d_tpu_torch.scripts.align_axis --scans_dir data/scannet/scans

For every scene under ``--scans_dir`` (or ``--scene_id``), applies the
``.txt`` axisAlignment matrix to ``<scene>_vh_clean_2.ply`` and writes
``<scene>_axis_aligned.ply`` beside it (read by ``eval --eval_visualize``).
"""
import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scans_dir", type=str, default="data/scannet/scans")
    p.add_argument("--scene_id", type=str, default="",
                   help="a single scene (default: every scene dir)")
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from spacap3d_tpu_torch.utils.visualize import export_axis_aligned_mesh

    scene_ids = ([args.scene_id] if args.scene_id
                 else sorted(d for d in os.listdir(args.scans_dir)
                             if os.path.isdir(os.path.join(args.scans_dir, d))))
    n_ok = 0
    for sid in scene_ids:
        out = os.path.join(args.scans_dir, sid, f"{sid}_axis_aligned.ply")
        try:
            export_axis_aligned_mesh(args.scans_dir, sid, out)
            n_ok += 1
            if not args.quiet:
                print(f"wrote {out}")
        except Exception as e:  # noqa: BLE001 — batch tool: report, continue
            print(f"FAILED {sid}: {e}")
    print(f"aligned {n_ok}/{len(scene_ids)} scenes")


if __name__ == "__main__":
    main()

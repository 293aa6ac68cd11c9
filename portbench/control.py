"""Readings for the limits of ``correct``: for each seed, one run of a
cell (set-up, a window of ``--seconds``) whose check is read for the
program and for each variant asked: the control ("control": the reference
in the precision below the configuration's, in the program's place) and
planted faults ("half", "stale", "token"), each with its numbers and its
own ``correct`` against the cell's limits. One JSON line a seed, also
appended to ``--out``. Not part of a benchmark run.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 1 \\
        --variants control,half --out readings.jsonl
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

FAULTS = {"half", "stale", "token"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="1")
    ap.add_argument("--variants", default="")
    ap.add_argument("--variant-seeds", type=int, default=None,
                    help="read the variants on the first N seeds only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from portbench import run

    variants = {}
    for v in filter(None, args.variants.split(",")):
        variants[v] = {"fault": v} if v in FAULTS else {"precision": v}
    for i, seed in enumerate(args.seeds.split(",")):
        some = args.variant_seeds is None or i < args.variant_seeds
        result = run.execute(["--workload", args.workload, "--seed", seed, "--seconds",
                              args.seconds, "--trace", "0"], variants=variants if some else {})
        line = json.dumps({"workload": args.workload, "seed": int(seed),
                           "correct": result["correct"], "device": result["device"],
                           "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                           "readings": result.get("readings", {}),
                           "checks": result["checks"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del result
        gc.collect()
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

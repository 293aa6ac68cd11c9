"""The overfit gate's spread on one device: ``scripts/overfit_gate.py`` at
the JAX package's CI settings (4 scenes, 250 epochs, threshold 0.5), run
``--runs`` times with ``--deterministic`` and ``--runs`` times without,
each in a fresh process.

    python3 -m spacap3d_tpu_torch.tools.overfit_spread [--runs 3] [--device cuda]

Prints one JSON line a run (its leg, the gate's result, the process's
seconds) and last a ``summary`` line: for each leg the CIDEr@0.25 of every
run, their least and largest, and whether every run passed.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

GATE_ARGS = ["--scenes", "4", "--epochs", "250", "--threshold", "0.5"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--gate_args", type=str, default=" ".join(GATE_ARGS),
                   help="the gate's own arguments, as one string")
    return p.parse_args(argv)


def gate(leg: str, device: str, gate_args) -> dict:
    """One run of the gate in a fresh process; its JSON result."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="overfit_spread_") as work:
        out = os.path.join(work, "result.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "spacap3d_tpu_torch.scripts.overfit_gate",
             "--workdir", os.path.join(work, "gate"), "--device", device, "--out", out,
             *gate_args, *(["--deterministic"] if leg == "deterministic" else [])],
            capture_output=True, text=True, cwd=root)
        if proc.returncode not in (0, 1) or not os.path.exists(out):
            raise RuntimeError(f"the gate exited {proc.returncode}: {proc.stderr[-4000:]}")
        with open(out) as f:
            return {**json.load(f), "process_s": time.perf_counter() - t0}


def main(argv=None) -> dict:
    args = parse_args(argv)
    gate_args = args.gate_args.split()
    legs = {"deterministic": [], "default": []}
    for _ in range(args.runs):
        for leg, runs in legs.items():
            runs.append(gate(leg, args.device, gate_args))
            print(json.dumps({"leg": leg, **runs[-1]}), flush=True)
    summary = {leg: {"cider": [r["cider"] for r in runs],
                     "min": min(r["cider"] for r in runs),
                     "max": max(r["cider"] for r in runs),
                     "all_passed": all(r["passed"] for r in runs)}
               for leg, runs in legs.items()}
    print(json.dumps({"summary": summary, "gate_args": gate_args, "device": args.device}),
          flush=True)
    return summary


if __name__ == "__main__":
    main()

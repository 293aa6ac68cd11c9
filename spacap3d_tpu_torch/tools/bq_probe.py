"""The ball-query kernel's builds and block sizes, on one CUDA GPU.

    python3 -m spacap3d_tpu_torch.tools.bq_probe [--parent OLD/ball_query.cu]

Prints JSON lines:

* ``sweep``: the kernel's device time per call (CUDA events around
  back-to-back calls, queued behind a device sleep) at the five shapes of
  the eval forward (SA1-SA4, vote aggregation; B = 8 scene-like clouds),
  at each build (4 or 1 centres a warp), each launch index-equal to the
  plain version; with ptxas's registers and spills per build, the centres
  a warp the wrapper picks and the pairs the data needs scanned (every
  point up to a centre's ns-th hit).
* ``sass``: each build's scan step as ``cuobjdump -sass`` prints it: the
  instructions of the loop that a step without a hit runs (from the loop
  head to the vote and its branch, and the loop's latch), and so a pair.
* ``clock``: the SM clock and power that ``nvidia-smi`` samples while the
  wrapper runs SA1 back to back for about two seconds, and the lane
  instructions a second the card then issues (its SMs x 4 schedulers x 32
  lanes at the median clock).
* ``floor``: each shape's instruction-issue floor: its pairs scanned at
  the instructions a pair of the wrapper's build, over that rate.
* ``parent`` (with ``--parent``): a ball-query source with the earlier C
  interface ``spacap_ball_query(xyz, centers, b, n, m, r2, ns, out,
  stream)`` built alone into a second library, timed against the wrapper in
  turns (old, new, new, old, three times) at the five shapes, both
  index-equal to the plain version.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.ops.ball_query import launch_ball_query, radius_sq
from spacap3d_tpu_torch.tools.ffn_probe import device_us

B = 8
# (N, m, r, ns): SA1-SA4 and vote aggregation
SHAPES = [(40000, 2048, 0.2, 64), (2048, 1024, 0.4, 32), (1024, 512, 0.8, 16),
          (512, 256, 1.2, 16), (1024, 256, 0.3, 16)]


def cloud(rng, n, m):
    """Scene-like clouds as bench.py makes them (6 x 6 x 3 m); the centres
    are the first m points."""
    pts = rng.rand(B, n, 3).astype(np.float32) * 6.0
    pts[..., 2] *= 0.5
    xyz = torch.from_numpy(pts).cuda()
    return xyz, xyz[:, :m].contiguous()


def reps_for(n):
    return 5 if n > 4096 else 20


def sweep(rng):
    """Times each build at each shape; returns (centres a warp the wrapper
    takes, pairs scanned) by shape."""
    _build.library()
    ptxas = _build.ptxas_info()
    regs = {c: next(({k: v.get(k) for k in ("registers", "spill_stores", "spill_loads")}
                     for name, v in ptxas.items() if f"ball_query_kernelILi{c}E" in name), None)
            for c in ops.BQ_WARP_CENTRES}
    print(json.dumps({"probe": "build", "ptxas": regs}), flush=True)
    dev = torch.cuda.current_device()
    picked = {}
    for n, m, r, ns in SHAPES:
        xyz, cen = cloud(rng, n, m)
        want = ops.ball_query_plain(xyz, cen, r, ns)
        ms = {}
        for c in ops.BQ_WARP_CENTRES:
            if not torch.equal(launch_ball_query(xyz, cen, r, ns, c), want):
                raise AssertionError(f"ball_query N={n} m={m} C={c}: != plain")
            ms[f"C{c}"] = device_us(lambda: launch_ball_query(xyz, cen, r, ns, c),
                                    reps=reps_for(n)) / 1e3
        full = want[..., -1] > want[..., 0]
        scanned = int(torch.where(full, want[..., -1].long() + 1, n).sum().item())
        c = ops.ball_query_default_warp_centres(dev, B, m)
        picked[n, m] = c, scanned
        print(json.dumps({"probe": "sweep", "b": B, "n": n, "m": m, "radius": r, "nsample": ns,
                          "wrapper_warp_centres": c, "best": min(ms, key=ms.get), "ms": ms,
                          "pairs_scanned": scanned, "equal": True}), flush=True)
    return picked


def parent_fn(src):
    """The kernel of an earlier source with the one-warp-a-centre interface
    spacap_ball_query(xyz, centers, b, n, m, r2, ns, out, stream), built
    alone with the wrapper's flags."""
    out = _build.BUILD_DIR / "other"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libparent_ball_query.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-shared", src,
                    "-o", str(lib_path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.spacap_ball_query.argtypes = [vp, vp, i32, i32, i32, ctypes.c_float, i32, vp, vp]
    lib.spacap_ball_query.restype = i32

    def run(xyz, cen, r, ns):
        b, n, _ = xyz.shape
        out = torch.empty((b, cen.shape[1], ns), dtype=torch.int32, device=xyz.device)
        _build.check(lib.spacap_ball_query(xyz.data_ptr(), cen.data_ptr(), b, n, cen.shape[1],
                                           radius_sq(r), ns, out.data_ptr(),
                                           torch.cuda.current_stream().cuda_stream),
                     "parent ball_query")
        return out
    return run


def in_turns(rng, parent):
    """``parent`` and the wrapper in turns (parent, change, change, parent,
    three times) at the five shapes, both index-equal to the plain version."""
    fns = {"parent": parent, "change": ops.ball_query}
    for n, m, r, ns in SHAPES:
        xyz, cen = cloud(rng, n, m)
        want = ops.ball_query_plain(xyz, cen, r, ns)
        for key, fn in fns.items():
            if not torch.equal(fn(xyz, cen, r, ns), want):
                raise AssertionError(f"{key} ball_query N={n} m={m}: != plain")
        ms = {key: [] for key in fns}
        for key in ["parent", "change", "change", "parent"] * 3:
            ms[key].append(device_us(lambda: fns[key](xyz, cen, r, ns), reps=reps_for(n)) / 1e3)
        print(json.dumps({"probe": "parent", "b": B, "n": n, "m": m, "radius": r, "nsample": ns,
                          "ms": ms, "median_ms": {k: float(np.median(v)) for k, v in ms.items()},
                          "equal": True}), flush=True)


def step_instructions(func):
    """Instructions a step without a hit runs, in one function's SASS lines:
    the loop around the vote, less the hit path that its branch skips."""
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
           (re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", ln) for ln in func) if m]
    at = {addr: i for i, (addr, _) in enumerate(ins)}

    def target(i):
        m = re.search(r"BRA (0x[0-9a-f]+)", ins[i][1])
        return int(m.group(1), 16) if m else None

    v = next(i for i, (_, op) in enumerate(ins) if op.startswith("VOTE.ANY P"))
    back = next(i for i in range(v, len(ins))
                if target(i) is not None and target(i) <= ins[v][0])
    n = back + 1 - at[target(back)]
    skip = target(v + 1)
    if skip is not None and ins[v][0] < skip <= ins[back][0]:
        n -= at[skip] - (v + 2)
    return n


def sass():
    """Returns the instructions a pair by build."""
    lib = Path(_build.library()._name)
    text = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    per_pair = {}
    for c in ops.BQ_WARP_CENTRES:
        func = next(f for f in funcs if f.startswith("_Z") and f"ball_query_kernelILi{c}E" in
                    f.split("\n", 1)[0])
        n = step_instructions(func.splitlines())
        per_pair[c] = n / (2 * c)
        print(json.dumps({"probe": "sass", "warp_centres": c, "step_instructions": n,
                          "pairs_a_step": 2 * c, "instructions_a_pair": per_pair[c]}),
              flush=True)
    return per_pair


def clock(rng):
    """Returns the lane instructions a second at the median SM clock."""
    n, m, r, ns = SHAPES[0]
    xyz, cen = cloud(rng, n, m)
    ops.ball_query(xyz, cen, r, ns)
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    time.sleep(0.5)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        for _ in range(50):
            ops.ball_query(xyz, cen, r, ns)
        calls += 50
        torch.cuda.synchronize()
    e.record()
    torch.cuda.synchronize()
    smi.terminate()
    samples = [[float(v) for v in ln.split(",")] for ln in smi.communicate()[0].splitlines()
               if ln.strip()]
    mhz = [a for a, _ in samples[5:-1]] or [a for a, _ in samples]
    watts = [b for _, b in samples[5:-1]] or [b for _, b in samples]
    ms = s.elapsed_time(e) / calls
    sms = torch.cuda.get_device_properties(xyz.device).multi_processor_count
    rate = sms * 4 * 32 * float(np.median(mhz)) * 1e6
    print(json.dumps({"probe": "clock", "n": n, "m": m, "calls": calls, "ms": ms,
                      "sm_clock_mhz": [min(mhz), float(np.median(mhz)), max(mhz)],
                      "power_w": [min(watts), float(np.median(watts)), max(watts)], "sms": sms,
                      "lane_instructions_a_second_at_the_median_clock": rate}), flush=True)
    return rate


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier csrc/ball_query.cu (one warp a centre) to "
                    "time in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bq_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"probe": "device", "nvidia_smi": smi, "torch": torch.__version__}),
          flush=True)
    rng = np.random.RandomState(0)
    picked = sweep(rng)
    per_pair = sass()
    rate = clock(rng)
    for (n, m), (c, scanned) in picked.items():
        print(json.dumps({"probe": "floor", "n": n, "m": m, "warp_centres": c,
                          "pairs_scanned": scanned, "instructions_a_pair": per_pair[c],
                          "issue_floor_ms": scanned * per_pair[c] / rate * 1e3}), flush=True)
    if args.parent:
        in_turns(rng, parent_fn(args.parent))
    return 0


if __name__ == "__main__":
    sys.exit(main())

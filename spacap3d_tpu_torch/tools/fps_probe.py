"""Where the FPS kernel's step goes, on one CUDA GPU.

    python3 -m spacap3d_tpu_torch.tools.fps_probe

Prints JSON lines:

* ``caps``: the kernel's device time (ms) and µs a step at the two
  main-path shapes (8 x 40000 -> 2048, 8 x 1024 -> 256), at the default
  cluster size and at caps of 128, 256 and 512 threads a block, timed in
  turns (128, 256, 512, 512, 256, 128, twice); every cap must give the
  plain version's indices.
* ``share``: µs a step against the points each block holds (N / C), at
  C = 1, 4 and 16 over 8 rows and 512 steps: the step's fixed cost
  (barrier, reductions, exchange) and the cost of a block's points.
"""
import json
import subprocess
import sys

import numpy as np
import torch

from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.tools.ffn_probe import device_us

B = 8
CAPS = (128, 256, 512)


def fps_capped(xyz, npoint, cluster, threads):
    """The cluster kernel over ``cluster`` blocks of at most ``threads``
    threads, through the C entry point (the wrapper takes no block size)."""
    b, n, _ = xyz.shape
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    _build.check(_build.library().spacap_fps(
        xyz.data_ptr(), b, n, npoint, cluster, threads, None, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream), f"fps (cluster {cluster}, threads {threads})")
    return out


def cloud(rng, b, n):
    return torch.from_numpy((rng.rand(b, n, 3) * 6.0).astype(np.float32)).cuda()


def caps(rng):
    dev = torch.cuda.current_device()
    for n, npoint in ((40000, 2048), (1024, 256)):
        xyz = cloud(rng, B, n)
        want = ops.furthest_point_sample_plain(xyz, npoint)
        c = ops.fps_default_cluster(dev, B, n)
        for t in CAPS:
            if not torch.equal(fps_capped(xyz, npoint, c, t), want):
                raise AssertionError(f"fps N={n} C={c} threads {t}: != plain")
        times = {t: [] for t in CAPS}
        for t in (CAPS + CAPS[::-1]) * 2:
            times[t].append(device_us(lambda: fps_capped(xyz, npoint, c, t),
                                      reps=3 if n > 4096 else 20) / 1e3)
        for t in CAPS:
            info = ops.fps_launch_info(dev, n, c, t)
            print(json.dumps({"probe": "caps", "b": B, "n": n, "npoint": npoint, "cluster": c,
                              "threads_cap": t, **info, "ms": times[t],
                              "us_per_step": float(np.mean(times[t])) * 1e3 / (npoint - 1),
                              "equal": True}), flush=True)


def share(rng):
    dev, npoint = torch.cuda.current_device(), 512
    for c in (1, 4, 16):
        for per_block in (128, 512, 2048, 4096, 8192):
            n = c * per_block
            xyz = cloud(rng, B, n)
            info = ops.fps_launch_info(dev, n, c)
            us = device_us(lambda: ops.furthest_point_sample(xyz, npoint, cluster=c), reps=5)
            print(json.dumps({"probe": "share", "b": B, "n": n, "npoint": npoint, "cluster": c,
                              "points_per_block": per_block, **info,
                              "us_per_step": us / (npoint - 1)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("fps_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"probe": "device", "nvidia_smi": smi, "torch": torch.__version__}), flush=True)
    rng = np.random.RandomState(0)
    caps(rng)
    share(rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())

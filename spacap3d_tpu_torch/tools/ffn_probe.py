"""Where the fused FFN kernel's time goes, on one CUDA GPU.

    python3 -m spacap3d_tpu_torch.tools.ffn_probe

Prints JSON lines:

* ``sweep``: the kernel's device time per call (CUDA events around 20
  back-to-back calls, queued behind a device sleep) over R, d_ff and the
  cluster size S at d 128. A time that does not grow with R at fixed S
  means the blocks do not contend for L2; the step per chunk of 64 d_ff
  columns is the latency of one chunk.
* ``timeline``: a build of ``csrc/decode.cu`` with ``SPACAP_FFN_TIMELINE``
  records %globaltimer (ns; it advances in steps of a few hundred ns) at eight
  phase boundaries in thread 0 of every block; the medians over blocks,
  from each block's start: mbarriers ready, x tile loaded, first chunk
  landed, chunks done, partials stored, cluster barrier passed, rows stored.
"""
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.ops import _build

D = 128
MARKS = ["mbarriers_ready", "x_tile_loaded", "first_chunk_landed", "chunks_done",
         "partials_stored", "cluster_barrier_passed", "rows_stored"]


def device_us(fn, reps=20, runs=5):
    """Median over ``runs`` of the per-call device time (us) of ``reps`` calls
    queued behind a ~5 ms device sleep."""
    fn()
    times = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / reps * 1e3)
    return float(np.median(times))


def weights(rng, d, f):
    lim = np.sqrt(6 / (d + f))
    return [torch.from_numpy(rng.uniform(-a, a, shape).astype(np.float32)).cuda().bfloat16()
            for shape, a in (((f, d), lim), ((f,), 1 / np.sqrt(d)), ((d, f), lim),
                             ((d,), 1 / np.sqrt(f)))]


def sweep(rng):
    for f in (64, 256, 2048):
        packed = ops.pack_ffn(*weights(rng, D, f))
        for r in (64, 2048):
            x = torch.randn(r, D, device="cuda").bfloat16()
            for s in range(1, min(4, packed.chunks) + 1):
                us = device_us(lambda: ops.ffn(x, packed, cluster=s))
                print(json.dumps({"probe": "sweep", "r": r, "d": D, "d_ff": f, "cluster": s,
                                  "us": us}), flush=True)


def timeline_library():
    """decode.cu built with the phase marks, beside the kernel library."""
    out = _build.BUILD_DIR / "libspacap_ffn_timeline.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                    "-fPIC", "-shared", "-DSPACAP_FFN_TIMELINE", str(_build.CSRC / "decode.cu"),
                    "-o", str(out)], check=True)
    lib = ctypes.CDLL(str(out))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.spacap_ffn.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp, vp]
    lib.spacap_ffn.restype = i32
    lib.spacap_ffn_timeline.argtypes = [vp, i32]
    lib.spacap_ffn_timeline.restype = i32
    return lib


def timeline(rng):
    lib = timeline_library()
    for r, f, s in [(2048, 64, 1), (2048, 2048, 1), (2048, 2048, 2), (2048, 2048, 3)]:
        packed = ops.pack_ffn(*weights(rng, D, f))
        x = torch.randn(r, D, device="cuda").bfloat16()
        out = torch.empty(r, D, device="cuda", dtype=torch.bfloat16)

        def call():
            _build.check(lib.spacap_ffn(
                x.data_ptr(), packed.image.data_ptr(), packed.b2_pad.data_ptr(), r, D,
                packed.chunks, s, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                "ffn (timeline build)")
        per_call = device_us(call)
        call()
        torch.cuda.synchronize()
        if not torch.equal(out, ops.ffn(x, packed, cluster=s)):
            raise AssertionError("the timeline build disagrees with the kernel library")
        blocks = s * -(-r // 64)
        host = (ctypes.c_ulonglong * (blocks * 8))()
        _build.check(lib.spacap_ffn_timeline(host, blocks * 8), "ffn timeline copy")
        t = np.array(host, dtype=np.float64).reshape(blocks, 8) / 1e3   # us
        rel = t[:, 1:] - t[:, :1]
        print(json.dumps({"probe": "timeline", "r": r, "d": D, "d_ff": f, "cluster": s,
                          "per_call_us": per_call,
                          "span_us": float(t[:, 7].max() - t[:, 0].min()),
                          "start_spread_us": float(t[:, 0].max() - t[:, 0].min()),
                          "median_us_from_block_start": dict(zip(MARKS, np.median(rel, 0).tolist())),
                          "max_us_from_block_start": dict(zip(MARKS, rel.max(0).tolist()))}),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ffn_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"probe": "device", "nvidia_smi": smi, "torch": torch.__version__}), flush=True)
    rng = np.random.RandomState(0)
    sweep(rng)
    timeline(rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())

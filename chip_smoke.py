#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``spacap3d_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version at every shape the eval forward gives it,
drives the eval forward at full width (default ModelConfig, B=8, 40,000
points) through ``make_eval_step``, checks that the forward launched the
kernels, and compares the port on the CPU with the port on the card at a
reduced size. Exits non-zero if any phase fails or if CUDA is missing.
Prints a line per phase, a ``kernels`` JSON line and, last,
``{"ok": true, "device": ...}``.
"""
import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.config import ModelConfig
from spacap3d_tpu_torch.models import init_spacap
from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.train.step import eval_tail, make_eval_step, to_device_batch

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

B = 8
DEV = "cuda"
FPS_SHAPES = [(40000, 2048), (1024, 256)]                 # (N, npoint): SA1, aggregation
BQ_SHAPES = [(40000, 2048, 0.2, 64), (2048, 1024, 0.4, 32), (1024, 512, 0.8, 16),
             (512, 256, 1.2, 16), (1024, 256, 0.3, 16)]   # (N, m, r, ns): SA1-4, aggregation


def log(phase, **kw):
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps, runs=5, warmup=2):
    """Median over ``runs`` of the per-call time of ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times))


def bench_points(rng, b, n):
    """Scene-like cloud as bench.py makes it: 6 x 6 x 3 m, plus height."""
    pts = rng.rand(b, n, 3).astype(np.float32) * 6.0
    pts[..., 2] *= 0.5
    height = pts[..., 2:3] - np.percentile(pts[..., 2], 0.99)
    return pts, np.concatenate([pts, height], -1).astype(np.float32)


def fps_input(rng, n):
    pts, _ = bench_points(rng, B, n)
    if n <= 4096:   # half the cloud on a 0.25 m lattice: exact distance ties
        pts[:, : n // 2] = np.round(pts[:, : n // 2] * 4.0) / 4.0
    q = n // 8
    pts[:, q // 2:q // 2 + q // 4] = 0.0        # ||p||^2 <= 1e-3: never picked
    pts[:, n - 2 * q:n - q] = pts[:, q:2 * q]   # duplicates: exact ties
    return pts


def bq_input(rng, n, m, r):
    pts, _ = bench_points(rng, B, n)
    centers = pts[:, :m].copy()
    # points on the radius boundary around the first centres
    k = min(128, m, n - m)
    d = rng.randn(B, k, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts[:, n - k:] = (centers[:, :k].astype(np.float64) + r * d).astype(np.float32)
    centers[:, -4:] = 100.0                     # centres with no hit
    return pts, centers


def phase_kernels():
    results = {"fps": [], "ball_query": []}
    rng = np.random.RandomState(0)
    for n, npoint in FPS_SHAPES:
        xyz = torch.from_numpy(fps_input(rng, n)).to(DEV)
        got = ops.furthest_point_sample(xyz, npoint)
        want = ops.furthest_point_sample_plain(xyz, npoint)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"fps N={n} npoint={npoint}: kernel != plain")
        k_ms = cuda_ms(lambda: ops.furthest_point_sample(xyz, npoint),
                       reps=3 if n > 4096 else 20)
        p_ms = cuda_ms(lambda: ops.furthest_point_sample_plain(xyz, npoint),
                       reps=1, runs=3, warmup=1)
        flops = 9.0 * (npoint - 1) * B * n        # 3 sub, 1 mul, 2 fma, 1 min a point-step
        b_ms, b_by = bound(flops, B * n * 12 + B * npoint * 4)
        row = dict(shape=[B, n, 3], npoint=npoint, max_abs_err=err, ms=k_ms,
                   plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        log("kernels", kernel="fps", **row)
        results["fps"].append(row)
    # off the main path: a row too long for shared memory (global scratch)
    xyz = torch.from_numpy(fps_input(rng, 60000)[:2]).to(DEV)
    if not torch.equal(ops.furthest_point_sample(xyz, 64),
                       ops.furthest_point_sample_plain(xyz, 64)):
        raise AssertionError("fps N=60000 (global scratch row): kernel != plain")
    for n, m, r, ns in BQ_SHAPES:
        pts, centers = bq_input(rng, n, m, r)
        xyz, cen = torch.from_numpy(pts).to(DEV), torch.from_numpy(centers).to(DEV)
        got = ops.ball_query(xyz, cen, r, ns)
        want = ops.ball_query_plain(xyz, cen, r, ns)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err:
            raise AssertionError(f"ball_query N={n} m={m} r={r}: kernel != plain")
        k_ms = cuda_ms(lambda: ops.ball_query(xyz, cen, r, ns), reps=10)
        p_ms = cuda_ms(lambda: ops.ball_query_plain(xyz, cen, r, ns),
                       reps=1, runs=3, warmup=1)
        # points this data needs scanned: up to the ns-th hit, or all of them
        full = got[..., -1] > got[..., 0]
        scanned = torch.where(full, got[..., -1].long() + 1, n).sum().item()
        flops = 8.0 * scanned                     # 3 sub, 3 mul, 2 add a pair
        b_ms, b_by = bound(flops, B * n * 12 + B * m * 12 + B * m * ns * 4)
        hits = float((got[..., 0] != 0).float().mean())
        row = dict(shape=[B, n, m], radius=r, nsample=ns, max_abs_err=err, ms=k_ms,
                   plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                   pairs_scanned=int(scanned), centres_with_hits=hits)
        log("kernels", kernel="ball_query", **row)
        results["ball_query"].append(row)
    return results


def phase_eval_forward():
    cfg = ModelConfig()
    rng = np.random.RandomState(0)
    _, point_clouds = bench_points(rng, B, cfg.num_points)
    center_label = rng.rand(B, 128, 3).astype(np.float32) * 6.0
    batch = {"point_clouds": point_clouds, "center_label": center_label}
    model = init_spacap(cfg, seed=0, device=DEV)
    step = make_eval_step(cfg, device=DEV)
    kernels = (ops.furthest_point_sample, ops.ball_query)

    def forward_counted():
        before = [k.launches for k in kernels]
        out = step(model, batch)
        torch.cuda.synchronize()
        got = [k.launches - b0 for k, b0 in zip(kernels, before)]
        if got != [2, 5]:
            raise AssertionError(f"launches per forward {got}, want [2, 5]")
        return out

    for k in kernels:
        k.launches = 0
    out = step(model, batch)
    torch.cuda.synchronize()
    launches = {"fps": ops.furthest_point_sample.launches,
                "ball_query": ops.ball_query.launches}
    if [launches["fps"], launches["ball_query"]] != [2, 5]:
        raise AssertionError(f"main path launches {launches}, want fps 2, ball_query 5")

    lc = out["lang_cap"]
    if tuple(lc.shape) != (B, cfg.num_proposals, cfg.max_des_len + 1):
        raise AssertionError(f"lang_cap shape {tuple(lc.shape)}")
    if int(lc.min()) < 0 or int(lc.max()) >= cfg.vocab_size:
        raise AssertionError("token id out of range")
    for k, v in out.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {k}")
    shapes = {k: list(v.shape) for k, v in out.items()}

    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(6):
        t0 = time.perf_counter()
        forward_counted()
        if i:                                   # the first is warm-up
            times.append(time.perf_counter() - t0)
    med = float(np.median(times))

    # coarse split, CUDA events around each part of the same forward
    dev_batch = to_device_batch(batch, DEV)
    splits = {"trunk": [], "encode": [], "decode": [], "tail": []}
    with torch.no_grad():
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            ep = model.detect(dev_batch["point_clouds"])
            ev[1].record()
            obj = model.caption.object_tokens(ep)
            ev[2].record()
            toks = model.caption.greedy_decode(obj)
            ev[3].record()
            ep["lang_cap"] = toks.reshape(B, cfg.num_proposals, -1)
            eval_tail(cfg, ep, dev_batch, compact=False)
            ev[4].record()
            torch.cuda.synchronize()
            for j, name in enumerate(splits):
                splits[name].append(ev[j].elapsed_time(ev[j + 1]))
    split_ms = {k: float(np.median(v)) for k, v in splits.items()}
    prof = device_profile(forward_counted)
    if "device_busy_ms" in prof:
        prof["device_busy_share"] = prof["device_busy_ms"] / (med * 1e3)
    log("eval_forward", batch=B, num_points=cfg.num_points, proposals=cfg.num_proposals,
        decode_dtype=cfg.eval_decode_dtype, decode_stages=cfg.eval_decode_stages,
        launches=launches, outputs=shapes, forward_s=med, forward_s_all=times,
        scenes_per_s=B / med, split_ms=split_ms,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("profile", **prof)
    return launches


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: the device's busy time (the
    union of its kernel and copy spans), their count, and the kernels with
    the most device time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in p.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"device_busy": "not measured: the profiler recorded no device events"}
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_spans": len(spans),
            "top_device_ms": [[name[:90], t / 1e3] for name, t in top]}


def phase_cpu_vs_gpu():
    cfg = dataclasses.replace(ModelConfig(), num_points=8192, num_proposals=64,
                              eval_decode_dtype="float32")
    rng = np.random.RandomState(1)
    _, pc = bench_points(rng, 2, cfg.num_points)
    model_cpu = init_spacap(cfg, seed=1, device="cpu")
    model_gpu = copy.deepcopy(model_cpu).to(DEV)
    with torch.no_grad():
        ep_c = model_cpu(torch.from_numpy(pc))
        ep_g = model_gpu(torch.from_numpy(pc).to(DEV))
        xyz = torch.from_numpy(pc[..., :3].copy())
        bq_c = ops.ball_query(xyz, ep_c["sa1_xyz"].contiguous(), 0.2, 64)
        bq_g = ops.ball_query(xyz.to(DEV), ep_g["sa1_xyz"].contiguous(), 0.2, 64).cpu()
    res = {
        "sa1_inds_equal": bool(torch.equal(ep_c["sa1_inds"], ep_g["sa1_inds"].cpu())),
        "sa1_ball_query_equal": bool(torch.equal(bq_c, bq_g)),
        "fp2_features_max_abs": float((ep_c["fp2_features"] - ep_g["fp2_features"].cpu()).abs().max()),
        "vote_xyz_max_abs": float((ep_c["vote_xyz"] - ep_g["vote_xyz"].cpu()).abs().max()),
    }
    log("cpu_vs_gpu", batch=2, num_points=cfg.num_points, **res)
    if not (res["sa1_inds_equal"] and res["sa1_ball_query_equal"]):
        raise AssertionError("CPU and GPU index outputs differ")
    if res["fp2_features_max_abs"] > 5e-4 or res["vote_xyz_max_abs"] > 5e-4:
        raise AssertionError("CPU and GPU trunk floats differ by more than 5e-4")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _build.library()
    log("build", seconds=time.perf_counter() - t0)
    print(_build.ptxas_report(), flush=True)

    per_shape = phase_kernels()
    launches = phase_eval_forward()
    phase_cpu_vs_gpu()

    meta = {
        "fps": ("spacap3d_tpu_torch/csrc/fps.cu", "spacap3d_tpu/ops/fps_pallas.py:35"),
        "ball_query": ("spacap3d_tpu_torch/csrc/ball_query.cu",
                       "spacap3d_tpu/ops/ball_query_pallas.py:50"),
    }
    kernels = []
    for name, rows in per_shape.items():
        # one forward's worth: the sum over the shapes the main path gives it
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None,
            "per_shape": rows,
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``spacap3d_tpu_torch/csrc`` and the host
library from ``csrc/spacap_host.cpp`` (each binding of ``data/native.py``
held to its plain numpy version under ``==`` and timed against it, in
turns, at the grid's and the train CLI's shapes; ``[host]`` lines), holds
each kernel against its plain PyTorch version at every shape the eval forward gives it
(FPS also at every cluster size the device holds, on lattice ties, a ragged
row, a row with fewer valid points than picks, a 60,000-point row and a row
above the cluster kernel's limit; ball query twice and at each of its
builds, also on clouds whose centres fill in the first tile or after
several, rows at the tile size and one point either side, rows 10 m apart
with centres no multiple of a block, and ns 1; the decode kernels also at
cluster sizes 1-4, twice, and on exact-arithmetic inputs: ties, padding,
empty cluster ranks; the FFN's partial-sum mode at tensor-parallel slices
of d_ff), drives the eval forward at full width
(default ModelConfig, B=8, 40,000 points) through ``make_eval_step``,
unfused and with ``eval_decode_fused`` (the fused decode kernels), each
through the default captured step (CUDA graphs) and the eager one, checks
that each forward launched its kernels (an eager forward by the wrappers'
counts; a replay, which runs no Python, by its profile's kernel spans, which
the ``kernels`` line gives as ``launches``, beside ``wrapper_launches``:
the main run's counts, its eager warm-up's and its capture's),
compares the two forwards' tokens and times the four in alternation,
holds the captured step to the eager one (``captured_eval``: every output
equal under ``torch.equal`` unfused, fused, compact, in point-table mode
and with the decode's early exit, kept outputs, in-place weight updates,
a replaced parameter; ``[captured_eval]`` lines), drives
the train step at full width (``make_train_step``: TrainConfig(), B=8,
40,000 points, dropout from a seeded CUDA generator), captured, for 13
steps on one batch, with its launch counts (a replay's from its profile),
finite losses and gradients, a falling loss and its time, holds the
captured train step to the eager one (``captured_train``: in a process of
its own under deterministic algorithms, replays equal to eager steps bit
for bit at dropout 0 and 0.1, masks included, and under detection
pretraining's momenta and rate decay; then the two timed in turns, and a
loaded optimizer state and a replaced parameter capturing anew;
``[captured_train]`` lines), compares the port on the CPU with the port on the card at
a reduced size, for the eval forward and for a train step, and drives the
eval harness at full width (``mul_eval_grid``, ``eval_cap``) on a
synthetic 141-scene val split: equal per-seed rows from the grid, its
per-row upload, its eager step and the serial protocol, the launches of
every grid forward, and ``mul_eval_e2e_rows_per_sec`` with its phases,
with the host library, with its plain versions and with the eager step in
turns (``[mul_eval]`` lines), and
drives the command lines at full width (``scripts.train``:
2 epochs with a validation in each, then a resume to a third;
``scripts.eval``: one seed, the grid against the serial protocol,
detection only, the attention and proposal dumps, ``--eval_visualize``;
then the overfit gate), with the resume position, checkpoints equal to
their snapshots and the launches of every step and forward, and the
train CLI's step with the host library and with its plain versions
(``[cli]`` lines), drives the multiview path at full width (ENet over 64 frames of
256 x 328 against the CPU, its features projected onto 8 synthetic scenes
of 40,000 points, the multiview + normal configuration's eval forward and
train step, the multiview CLIs whose packages import; ``[multiview]``
lines), then the parallel runtimes on ranks that share the card
(``[parallel]`` lines; tensor parallelism also with the fused decode, the
FFN kernel's partial-sum mode on each rank's d_ff slice, which the
``kernels`` line lists as ``ffn_partial``; over NCCL on a world of one the
data- and tensor-parallel steps captured with their collectives inside
the graphs, bit-equal to eager ones in turns, their replays' launches from
profile spans). Exits non-zero if any phase
fails or if CUDA is missing. Prints a line per phase, a ``kernels`` JSON line and, last,
``{"ok": true, "device": ...}``.
"""
import collections
import contextlib
import copy
import ctypes
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.config import (
    EOS_ID,
    EVAL_MIN_IOU,
    SOS_ID,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from spacap3d_tpu_torch.data import native
from spacap3d_tpu_torch.data.dataset import ScanReferDataset, SceneStore
from spacap3d_tpu_torch.data.loader import DataLoader
from spacap3d_tpu_torch.data.projection import aggregate_frames_maxpool, make_map_projection_helper
from spacap3d_tpu_torch.data.scannet_config import ScannetDatasetConfig
from spacap3d_tpu_torch.data.synthetic import train_batch, write_synthetic_dataset
from spacap3d_tpu_torch.data.vocabulary import Vocabulary
from spacap3d_tpu_torch.eval.capeval import Meteor
from spacap3d_tpu_torch.eval.eval_helper import eval_cap, organize_annotations, prepare_corpus
from spacap3d_tpu_torch.eval.mul_eval import _build_point_tables as mul_eval_tables
from spacap3d_tpu_torch.eval.mul_eval import mul_eval_grid
from spacap3d_tpu_torch.models import SpaCapNet, init_spacap
from spacap3d_tpu_torch.models.core import BatchNorm
from spacap3d_tpu_torch.models.enet import init_enet
from spacap3d_tpu_torch.ops import _build
from spacap3d_tpu_torch.ops.ball_query import launch_ball_query
from spacap3d_tpu_torch.parallel.mp_dryrun import (
    GRID_MIN_IOU,
    adam_state,
    grid_dataset,
    launch,
    recorded_masks,
)
from spacap3d_tpu_torch.scripts import compute_multiview_features as mv_features_cli
from spacap3d_tpu_torch.scripts import eval as eval_cli
from spacap3d_tpu_torch.scripts import project_multiview_features as mv_project_cli
from spacap3d_tpu_torch.scripts import project_multiview_labels as mv_labels_cli
from spacap3d_tpu_torch.scripts import train as train_cli
from spacap3d_tpu_torch.tools.fps_probe import fps_capped
from spacap3d_tpu_torch.train import solver as solver_module
from spacap3d_tpu_torch.train import step as step_module
from spacap3d_tpu_torch.train.losses import get_scene_cap_loss
from spacap3d_tpu_torch.train.solver import Solver
from spacap3d_tpu_torch.train.step import (
    TRAIN_KEYS,
    eval_tail,
    load_optimizer_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    to_device_batch,
)
from spacap3d_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint_sync
from spacap3d_tpu_torch.utils.visualize import COLORS

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, dense
# bf16 on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

B = 8
DEV = "cuda"
FPS_SHAPES = [(40000, 2048), (1024, 256)]                 # (N, npoint): SA1, aggregation
BQ_SHAPES = [(40000, 2048, 0.2, 64), (2048, 1024, 0.4, 32), (1024, 512, 0.8, 16),
             (512, 256, 1.2, 16), (1024, 256, 0.3, 16)]   # (N, m, r, ns): SA1-4, aggregation
KERNELS = {"fps": ops.furthest_point_sample, "ball_query": ops.ball_query,
           "generator_argmax": ops.generator_argmax, "ffn": ops.ffn,
           "ffn_partial": ops.ffn_partial}
# greedy decode rows B * K = 2048 at d 128: vocab 4528, d_ff 2048
GEN_SHAPES = [(2048, 4528, True), (2000, 4500, False)]   # (R, vocab, on the main path)
# (R, d, d_ff, on the main path): the decode's shape, a ragged R, the widest d
# with a d_ff that is no multiple of the kernel's 64-column chunk, a narrow d
FFN_SHAPES = [(2048, 128, 2048, True), (2000, 128, 2048, False),
              (2000, 256, 1040, False), (2048, 64, 2048, False)]
# the FFN's partial-sum mode on one tensor-parallel rank's d_ff slice: tp 2
# (P3's fused TP forward), tp 4, and a ragged R with a slice of 528 (d_ff
# 1056 at tp 2: a multiple of 16, not of the 64-column chunk); the weights
# at the init range of the whole d_ff, as a rank's slice has them
FFN_PARTIAL_SHAPES = [(2048, 128, 1024, 2048, True), (2048, 128, 512, 2048, False),
                      (2000, 128, 528, 1056, False)]   # (R, d, slice, d_ff, on the main path)
D_MODEL = 128
# a train step's launches: the trunk's FPS and ball query, no decode kernel
TRAIN_WANT = {"fps": 2, "ball_query": 5, "generator_argmax": 0, "ffn": 0, "ffn_partial": 0}
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
# the captured_train phase: the captured train step against the eager one
# over CAPTURED_TRAIN_STEPS steps in a process of its own under
# deterministic algorithms (cuBLAS's workspace set before cuBLAS starts),
# bit for bit; detection pretraining's leg at the solver's momenta of its
# first three decay steps (0.5 halved), its rate decayed at updates 1 and 2
CAPTURED_TRAIN_STEPS = 3
CAPTURED_TRAIN_MOMENTA = (0.5, 0.25, 0.125)
CUBLAS_DETERMINISTIC = ":4096:8"
# CPU against GPU, one train step at dropout 0, from the same weights and
# batch. Each loss within 5e-4 of itself (PARITY.md's tolerance) plus 1e-5
# absolute: a term of the one positive proposal (heading_reg_loss, 0.0065;
# size_reg_loss, 0.029) moves by the f32 rounding of that proposal's head
# outputs (4.2e-6 and 9.0e-6 on an H100 80GB HBM3, 700 W). Gradients: each
# leaf's largest difference as a share of its largest entry, floored at
# 1e-4 of the largest entry of all leaves (leaves that are zero up to
# rounding: attention key biases, biases ahead of a train-mode BN). The
# two sides' forwards differ by rounding, so a neighbour max-pool may pick
# another of two near-equal neighbours (logged as argmax flips), which
# sends a row's gradient to another neighbour and moves every leaf
# upstream of its pool. So the step is taken twice. Free, each side
# pooling its own maximum: the median share within 1e-4 and the largest
# within 2e-2. Pinned, both sides' pools taking the CPU's argmax, against
# an f64 reference on the CPU with the same pools and indices: a leaf of
# an f32 gradient sums terms that cancel (BN biases and scales, the vote
# layers), so even the CPU's f32 leaf lies up to a few 1e-2 of its size
# from the f64 one. Each of the GPU's leaves must lie within twice the
# CPU's distance from f64 plus 1e-3 (the leaf tolerance of the port's CPU
# tests against JAX); a wrong backward moves a leaf by its own size.
TRAIN_LOSS_TOL, TRAIN_LOSS_ATOL = 5e-4, 1e-5
TRAIN_GRAD_MEDIAN, TRAIN_GRAD_SHARE, TRAIN_GRAD_FLOOR = 1e-4, 2e-2, 1e-4
TRAIN_F64_FACTOR, TRAIN_F64_ATOL = 2.0, 1e-3
# the neighbour max-pools of the train path, by the module whose output
# they reduce
POOLS = {**{f"sa{i}": f"backbone_net.sa{i}.mlp_module" for i in range(1, 5)},
         "aggregation": "proposal.vote_aggregation.mlp_module"}
# the mul_eval phase: ScanRefer's val split is 141 scenes; scenes of ~52,000
# points (16 boxes of 2,000 over 20,000 floor points), so that the 40,000
# drawn without replacement include indices past 32,767 in their uint16
# form; 4 seeds and 3 cold repeats as bench.py:187 times the grid; the
# row gates on 16 scenes and seeds 0 and 1 at min_iou 0.05
MUL_EVAL_SCENES, MUL_EVAL_SEEDS, MUL_EVAL_REPEATS = 141, 4, 3
MUL_EVAL_SCENE = dict(num_objects=16, points_per_object=2000, background_points=20000)
MUL_EVAL_GATE_SCENES, MUL_EVAL_GATE_SEEDS, MUL_EVAL_GATE_IOU = 16, [0, 1], 0.05
# the cli phase: 16 train scenes of MUL_EVAL_SCENE (256 annotations, 32 steps
# an epoch at B = 8) and 8 val scenes, 2 of them for --eval_visualize; every
# train step and forward of the CLIs launches FPS 2 and ball query 5 times;
# the overfit gate at the JAX package's CI settings (tests/test_train_e2e.py:
# 4 scenes, 250 epochs, CIDEr threshold 0.5 at its default min_iou 0.25), in
# a process of its own under deterministic algorithms: the JAX test's CPU
# run gives one score, and the CUDA backward's atomics otherwise move the
# score from run to run across the gate's sharp transition
CLI_TRAIN_SCENES, CLI_VAL_SCENES, CLI_VIS_SCENES = 16, 8, 2
CLI_WANT = {"fps": 2, "ball_query": 5, "generator_argmax": 0, "ffn": 0, "ffn_partial": 0}
# the train CLI's host legs draw equal batches, so their first losses agree
# but for the card's own reductions
CLI_LEG_LOSS_RTOL = 1e-5
OVERFIT_ARGS = ["--scenes", "4", "--epochs", "250", "--threshold", "0.5"]
# the multiview phase: ENet over a batch of MV_FRAMES frames at the reference
# frame size (scripts/compute_multiview_features.py's defaults), held to the
# port's ENet on the CPU on the first MV_CPU_FRAMES frames within MV_ENET_REL
# of the output's largest magnitude (the CPU tests' tolerance against JAX;
# TF32 off); MV_FRAMES_PER_SCENE frames a scene from top-down cameras
# MV_CAMERA_Z m up (focal MV_FOCAL px: a 4 x 2 grid covers the 6 x 6 m room),
# at least MV_SEEN_MIN of a scene's points seen (the floor and the boxes'
# tops, 0.34-0.52 of these scenes' points; the inside of a filled box is
# hidden); MV_FORWARDS timed forwards; the CLIs on MV_CLI_SCENES scenes (the
# last one val)
MV_FRAMES_PER_SCENE = 8
MV_FRAMES, MV_H, MV_W = B * MV_FRAMES_PER_SCENE, 256, 328
MV_CPU_FRAMES, MV_ENET_REL, MV_ENET_RUNS = 4, 1e-4, 10
MV_FOCAL, MV_CAMERA_Z, MV_DEPTH_MIN, MV_DEPTH_MAX = 290.0, 3.5, 0.1, 4.0
MV_SEEN_MIN, MV_FORWARDS, MV_CLI_SCENES = 0.25, 10, 4
# the parallel phase: ranks started as processes (parallel/mp_dryrun.py and
# the command lines with --multihost); every world has at most
# PARALLEL_TIMEOUT seconds and each rank's collectives PARALLEL_COLLECTIVE_S.
# P1 (NCCL, a world of one) takes 3 steps at the default dropout; P2 (two
# gloo ranks sharing the card) one step of 4 rows a rank at dropout 0, held
# to the 1-process step on the 8 rows within rel 1e-5 plus TRAIN_LOSS_ATOL
# (1e-5): with every FPS, ball-query and max-pool choice pinned, the ranks'
# BN sums still round apart from the 8-row sums, and heading_reg_loss, a
# mean over the ~30 positive proposals' head outputs, moved 5.0e-6 (rel
# 3.8e-5) on an H100 80GB HBM3, 700 W, as such terms move between CPU
# and card;
# P3 (TP = 2 in the same world) the eval forward and one train step; P4 the
# seed-sharded grid over 16 scenes of the cli split x 4 seeds; P5 the
# command lines with --multihost on two ranks. P1 and P1 TP 1 (NCCL, a
# world of one) also run the captured steps against eager ones in turns
# (``mp_dryrun --captured``: 3 train steps of each, then a profiled one, and
# the TP eval forwards twice unfused, fused, fused, unfused), bit-equal
# under deterministic algorithms; over NCCL on several cards
# P2 and P3 run them too, held to the DP gate (PARALLEL_RTOL,
# PARALLEL_ATOL).
PARALLEL_TIMEOUT, PARALLEL_COLLECTIVE_S = 300, 120
PARALLEL_P1_STEPS, PARALLEL_P1_RTOL = 3, 1e-6
PARALLEL_RTOL, PARALLEL_ATOL = 1e-5, TRAIN_LOSS_ATOL
PARALLEL_OBJ_ATOL = 1e-5
# the partial-sum kernel's check: up to 2 hidden values of a row may round
# to their other bf16 neighbour on the two sides (a value flips only where
# the first product's reassociation, ~2^-23 d of its terms' sum, straddles a
# rounding midpoint of h, a few in 10^5; the check logs the outputs that
# needed this allowance as ``beyond_reassoc``)
FFN_PARTIAL_FLIPS = 2
# P3's fused TP eval forward on each rank: the trunk's FPS and ball query, the
# generator's argmax at each of 31 steps, and each decoder FFN (6 layers x (31
# steps + the early guide's object token)) as its partial sum on the rank's
# d_ff slice, none whole
TP_FUSED_WANT = {"fps": 2, "ball_query": 5, "generator_argmax": 31, "ffn": 0, "ffn_partial": 192}
PARALLEL_GRID_SCENES, PARALLEL_GRID_SEEDS = 16, 4
# the host phase: each binding of the host library against its plain numpy
# version at the grid's and the train CLI's shapes (a 52,000-point scene,
# 40,000 drawn; ~30 instances; 256 proposals), HOST_RUNS timed calls of
# each, in turns
HOST_SCENE_POINTS, HOST_DRAWN, HOST_INSTANCES, HOST_BOXES, HOST_RUNS = 52000, 40000, 30, 256, 9
# each binding of data/native.py -> its plain numpy version: the host legs
# of the mul_eval and cli phases swap them on the module
PLAIN_BINDINGS = {"choice_noreplace_native": "choice_noreplace_plain",
                  "gather_rows": "gather_rows_plain", "percentile_z": "percentile_plain",
                  "compute_votes_native": "compute_votes_plain",
                  "points_in_boxes_native": "points_in_boxes_plain",
                  "greedy_nms_native": "greedy_nms_plain"}
# the marker kernels that open a profile's window (torch.cuda._sleep, each
# spinning about 0.5 us): a profile can drop the device spans at the head of
# its window (up to 25 in the multiview phase's profiles on an H100), so the window
# opens at the last marker's span, after the host has waited for them all
PROFILE_MARKERS, PROFILE_MARKER_CYCLES = 128, 1_000
# the captured_eval phase: replays after the one whose outputs are kept; the
# EOS logit raised so that every row emits EOS in the first stage; the
# point-table path's scenes (of MUL_EVAL_POINTS points)
CAPTURE_LATER, CAPTURE_EOS_BIAS, CAPTURE_TABLE_SCENES = 9, 30.0, 12
MUL_EVAL_POINTS = 52000
# a captured graph's nodes by the driver's CUgraphNodeType: a profile of a
# replay holds one device span for each kernel, copy and memset node
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}
# the kernels whose device time the forward's profile reports, by kernel name
PROFILED = {"fps": "fps_kernel", "ball_query": "ball_query_kernel",
            "generator_argmax": "gen_argmax_kernel", "ffn": "ffn_kernel",
            "ffn_partial": "ffn_partial_kernel"}


def log(phase, **kw):
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def bound(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_ms(fn, reps, runs=5, warmup=2):
    """Median over ``runs`` of the per-call device time of ``reps``
    back-to-back calls. The device first sleeps about 5 ms, so that the host
    has queued the calls before the first one starts and the window holds
    device time, not the wrappers' host time."""
    for _ in range(warmup):
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
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times))


def bench_points(rng, b, n):
    """Scene-like cloud as bench.py makes it: 6 x 6 x 3 m, plus height."""
    pts = rng.rand(b, n, 3).astype(np.float32) * 6.0
    pts[..., 2] *= 0.5
    height = pts[..., 2:3] - np.percentile(pts[..., 2], 0.99)
    return pts, np.concatenate([pts, height], -1).astype(np.float32)


def fps_input(rng, n, b=None, lattice=None):
    """Bench-style clouds with never-picked points and duplicates. Rows of
    up to 4096 points (or ``lattice=True``) put half the cloud (all of it)
    on a 0.25 m lattice: exact distance ties, across the cluster's ranks
    too."""
    pts, _ = bench_points(rng, b or B, n)
    if lattice or (lattice is None and n <= 4096):
        k = n if lattice else n // 2
        pts[:, :k] = np.round(pts[:, :k] * 4.0) / 4.0
    q = n // 8
    pts[:, q // 2:q // 2 + q // 4] = 0.0        # ||p||^2 <= 1e-3: never picked
    pts[:, n - 2 * q:n - q] = pts[:, q:2 * q]   # duplicates: exact ties
    return pts


def fps_sparse_input(rng, n, valid):
    """Rows with fewer valid points than picks: the rest sit at the origin."""
    pts = np.zeros((2, n, 3), np.float32)
    for row in pts:
        row[rng.choice(n, valid, replace=False)] = rng.rand(valid, 3).astype(np.float32) * 6 + 0.1
    return pts


def fps_held(n):
    """The cluster sizes the device can run a row of n points at."""
    dev = torch.cuda.current_device()
    return [c for c in ops.fps.FPS_CLUSTERS if -(-n // c) <= ops.fps.FPS_BLOCK_POINTS
            and ops.fps_launch_info(dev, n, c)["max_active_clusters"] >= 1]


def fps_check(xyz, npoint, what):
    """The kernel at the default C and at every C the device holds, against
    the plain version: equal indices. Returns the default C, the Cs run and
    the plain version's indices."""
    want = ops.furthest_point_sample_plain(xyz, npoint)
    b, n, _ = xyz.shape
    auto = ops.fps_default_cluster(torch.cuda.current_device(), b, n)
    runs = [None] + [c for c in fps_held(n) if c != auto]
    for c in runs:
        got = ops.furthest_point_sample(xyz, npoint, cluster=c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want)[0].tolist()
            raise AssertionError(f"fps {what} N={n} npoint={npoint} cluster={c or auto}: kernel "
                                 f"!= plain, first at (row, step) {bad}")
    return auto, [auto] + runs[1:], want


def fps_launch_row(n, cluster, ptxas):
    """The cluster kernel's launch at C = cluster: threads, points a thread,
    shared memory, co-resident clusters and ptxas's registers and spills."""
    info = ops.fps_launch_info(torch.cuda.current_device(), n, cluster)
    name = f"fps_kernel_clusterILi{info['points_per_thread']}E"
    pt = next(v for k, v in ptxas.items() if name in k)
    return dict(info, registers=pt.get("registers"), spill_stores=pt.get("spill_stores"),
                spill_loads=pt.get("spill_loads"))


def phase_fps():
    """FPS at the main-path shapes, at the default C and every C the device
    holds (timed: the C sweep), and over caps on a block's threads at the
    default C (timed: the block-size sweep); then the tie, ragged, sparse
    and long-row cases. Every launch is index-equal to the plain version."""
    rows = []
    rng = np.random.RandomState(0)
    ptxas = _build.ptxas_info()
    log("kernels", kernel="fps", block_points=_build.library().spacap_fps_block_points())
    for n, npoint in FPS_SHAPES:
        xyz = torch.from_numpy(fps_input(rng, n)).to(DEV)
        auto, ran, want = fps_check(xyz, npoint, "main path")
        reps = 3 if n > 4096 else 20
        k_ms = cuda_ms(lambda: ops.furthest_point_sample(xyz, npoint), reps=reps)
        p_ms = cuda_ms(lambda: ops.furthest_point_sample_plain(xyz, npoint),
                       reps=1, runs=3, warmup=1)
        sweep = {str(c): cuda_ms(lambda: ops.furthest_point_sample(xyz, npoint, cluster=c),
                                 reps=reps) for c in ran[1:]}
        sweep[str(auto)] = k_ms
        threads = {}   # at the default C, over caps on a block's threads
        for t in (32, 64, 128, 256, 512, 1024):
            if -(-n // auto) <= t * 32:
                if not torch.equal(fps_capped(xyz, npoint, auto, t), want):
                    raise AssertionError(f"fps N={n} npoint={npoint} cluster={auto} "
                                         f"threads {t}: kernel != plain")
                info = ops.fps_launch_info(torch.cuda.current_device(), n, auto, t)
                threads[str(t)] = dict(threads=info["threads"],
                                       points_per_thread=info["points_per_thread"],
                                       ms=cuda_ms(lambda: fps_capped(xyz, npoint, auto, t),
                                                  reps=reps))
        flops = 9.0 * (npoint - 1) * B * n        # 3 sub, 1 mul, 2 fma, 1 min a point-step
        b_ms, b_by = bound(flops, B * n * 12 + B * npoint * 4)
        row = dict(shape=[B, n, 3], npoint=npoint, max_abs_err=0, ms=k_ms, plain_ms=p_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None, cluster=auto,
                   us_per_step=k_ms * 1e3 / (npoint - 1), **fps_launch_row(n, auto, ptxas),
                   cluster_sweep_ms=sweep, threads_sweep_ms=threads,
                   clusters_checked=ran)
        log("kernels", kernel="fps", **row)
        rows.append(row)
    limit = 16 * ops.fps.FPS_BLOCK_POINTS + 1
    cases = [("lattice 0.25 m", fps_input(rng, 40000, lattice=True), 2048),
             ("ragged", fps_input(rng, 39999), 2048),
             ("fewer valid points than npoint", fps_sparse_input(rng, 40000, 100), 256),
             ("60000 points", fps_input(rng, 60000, b=2), 64),
             ("above the cluster limit", fps_input(rng, limit, b=2), 16)]
    for what, pts, npoint in cases:
        xyz = torch.from_numpy(pts).to(DEV)
        auto, ran, _ = fps_check(xyz, npoint, what)
        log("kernels", kernel="fps", case=what, shape=list(pts.shape), npoint=npoint,
            cluster=auto, clusters_checked=ran, equal=True)
        if what == "above the cluster limit" and auto != 0:
            raise AssertionError(f"fps N={limit}: cluster {auto}, want the streaming kernel")
    return rows


def bq_input(rng, n, m, r, b=None, scale=6.0):
    """Scene-like clouds (``scale`` m wide; 6 as bench.py makes them), b rows
    (default B), whose first m points are the centres; points on the radius
    boundary around the first centres, and four centres with no hit."""
    b = b or B
    pts, _ = bench_points(rng, b, n)
    pts *= scale / 6.0
    centers = pts[:, :m].copy()
    k = min(128, m, n - m)
    d = rng.randn(b, k, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts[:, n - k:] = (centers[:, :k].astype(np.float64) + r * d).astype(np.float32)
    centers[:, -4:] = 100.0                     # centres with no hit
    return pts, centers


def bq_cases(rng):
    """Check-only inputs: (what, points, centres, r, ns)."""
    tile = ops.BQ_TILE_POINTS
    block = ops.BQ_WARP_CENTRES[0] * ops.BQ_WARPS     # centres of the widest block
    cases = [("saturating dense cloud", *bq_input(rng, 40000, 2048, 0.2, scale=0.6), 0.2, 64),
             ("filling after several tiles", *bq_input(rng, 40000, 2048, 0.2, scale=2.0), 0.2, 64)]
    for n in (tile - 1, tile, tile + 1, 2 * tile + 1):
        pts, centers = bq_input(rng, n, 256, 0.3)
        # hits of the first centres on both sides of every tile edge
        for e in range(tile, n + 1, tile):
            pts[:, e - 6:e + 6] = centers[:, :1] + rng.uniform(-0.1, 0.1, (B, 12, 3)).astype(
                np.float32)[:, :min(12, n - e + 6)]
        cases.append((f"N {n}, tile {tile}", pts, centers, 0.3, 16))
    # B = 3 rows 10 m apart: a block that read another row would find no hit
    pts, centers = bq_input(rng, 4096, 3 * block + 5, 0.4, b=3)
    shift = (10.0 * np.arange(3, dtype=np.float32))[:, None, None]
    cases.append((f"B 3 rows apart, m {3 * block + 5}", pts + shift, centers + shift, 0.4, 32))
    cases.append(("ns 1", *bq_input(rng, 2048, 1000, 0.4), 0.4, 1))
    return cases


def bq_check(xyz, cen, r, ns, what):
    """The kernel twice through the wrapper, and once at each build (centres
    a warp), against the plain version: equal indices."""
    got = ops.ball_query(xyz, cen, r, ns)
    again = ops.ball_query(xyz, cen, r, ns)
    want = ops.ball_query_plain(xyz, cen, r, ns)
    builds = {c: launch_ball_query(xyz, cen, r, ns, c) for c in ops.BQ_WARP_CENTRES}
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"ball_query {what}: two calls differ")
    for c, idx in [("default", got), *builds.items()]:
        if not torch.equal(idx, want):
            bad = torch.nonzero(idx != want)[0].tolist()
            raise AssertionError(f"ball_query {what} ({c} centres a warp): kernel != plain, "
                                 f"first at {bad}")
    return got


def bq_launch_row(b, m, ptxas):
    """The main-path launch: centres a warp and a block, warps, points a
    tile, shared memory, resident blocks and ptxas's registers and spills."""
    dev = torch.cuda.current_device()
    info = ops.ball_query_launch_info(dev, ops.ball_query_default_warp_centres(dev, b, m))
    name = f"ball_query_kernelILi{info['warp_centres']}E"
    pt = next(v for k, v in ptxas.items() if name in k)
    return dict(info, blocks=ops.ball_query_blocks(b, m, info["warp_centres"]),
                registers=pt.get("registers"), spill_stores=pt.get("spill_stores"),
                spill_loads=pt.get("spill_loads"))


def phase_kernels():
    results = {"fps": phase_fps(), "ball_query": []}
    rng = np.random.RandomState(0)
    ptxas = _build.ptxas_info()
    for n, m, r, ns in BQ_SHAPES:
        pts, centers = bq_input(rng, n, m, r)
        xyz, cen = torch.from_numpy(pts).to(DEV), torch.from_numpy(centers).to(DEV)
        got = bq_check(xyz, cen, r, ns, f"N={n} m={m} r={r}")
        k_ms = cuda_ms(lambda: ops.ball_query(xyz, cen, r, ns), reps=10)
        p_ms = cuda_ms(lambda: ops.ball_query_plain(xyz, cen, r, ns),
                       reps=1, runs=3, warmup=1)
        # points this data needs scanned: up to the ns-th hit, or all of them
        full = got[..., -1] > got[..., 0]
        scanned = torch.where(full, got[..., -1].long() + 1, n).sum().item()
        flops = 8.0 * scanned                     # 3 sub, 3 mul, 2 add a pair
        b_ms, b_by = bound(flops, B * n * 12 + B * m * 12 + B * m * ns * 4)
        hits = float((got[..., 0] != 0).float().mean())
        row = dict(shape=[B, n, m], radius=r, nsample=ns, max_abs_err=0, ms=k_ms,
                   plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   pairs_scanned=int(scanned), centres_with_hits=hits,
                   centres_full=float(full.float().mean()), two_calls_equal=True,
                   warp_centres_checked=list(ops.BQ_WARP_CENTRES),
                   **bq_launch_row(B, m, ptxas))
        log("kernels", kernel="ball_query", **row)
        results["ball_query"].append(row)
    for what, pts, centers, r, ns in bq_cases(rng):
        xyz, cen = torch.from_numpy(pts).to(DEV), torch.from_numpy(centers).to(DEV)
        got = bq_check(xyz, cen, r, ns, what)
        full = float((got[..., -1] > got[..., 0]).float().mean())
        log("kernels", kernel="ball_query", case=what, shape=[*pts.shape[:2], cen.shape[1]],
            radius=r, nsample=ns, main_path=False, equal=True, two_calls_equal=True,
            warp_centres_checked=list(ops.BQ_WARP_CENTRES), centres_full=full)
    return results


def bf16_uniform(rng, shape, limit):
    return torch.from_numpy(rng.uniform(-limit, limit, shape).astype(np.float32)).to(
        DEV).bfloat16()


def gen_check(x, packed, cluster=None):
    """The kernel's indices against the plain f32 logits. Two f32 sums of
    the same d exact bf16 products in other orders differ by at most
    d * 2^-23 * S each (S = the row's largest sum of |terms| over the
    columns; 2^-23 allows the tensor cores' truncating accumulation), so a
    row whose top-2 plain logits are further apart than 2 d 2^-23 S must
    give the plain index, and every row must pick a column within that
    bound of the max. ``max_abs_err`` is the largest such shortfall. Two
    calls on the same inputs must give the same indices."""
    got = ops.generator_argmax(x, packed, cluster=cluster)
    again = ops.generator_argmax(x, packed, cluster=cluster)
    w, b, vocab = packed.w, packed.b, packed.vocab
    logits = x.float() @ w.float().t() + b.float()
    want = torch.argmax(logits, dim=-1)
    s = (x.float().abs() @ w.float().abs().t() + b.float().abs()).amax(-1)
    tol = 2 * x.shape[1] * 2.0 ** -23 * s
    top2 = logits.topk(2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]) <= tol
    short = top2[:, 0] - logits.gather(1, got.clamp(0, vocab - 1)[:, None])[:, 0]
    torch.cuda.synchronize()
    what = f"generator_argmax R={x.shape[0]} vocab={vocab} cluster={cluster}"
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two calls differ")
    if int(got.max()) >= vocab or int(got.min()) < 0:
        raise AssertionError(f"{what}: index out of range")
    if bool((short > tol).any()) or bool((got != want)[~near].any()):
        raise AssertionError(f"{what}: kernel picks a column below the max by more than the "
                             f"reassociation bound")
    return {"max_abs_err": float(short.max()), "rows": int(x.shape[0]),
            "rows_in_tie_bound": int(near.sum()),
            "rows_index_differs": int((got != want).sum()),
            "tie_bound_max": float(tol.max()), "two_calls_equal": True}


def gen_launch(packed, cluster):
    return ops.generator_launch_info(torch.cuda.current_device(), packed.d, packed.vocab, cluster)


def gen_held(packed):
    """The cluster sizes 1-4 the device can run the generator kernel at."""
    return [s for s in range(1, 5) if gen_launch(packed, s)["max_active_clusters"] >= 1]


def gen_exact_case(rng, vocab, ties, clusters=None):
    """Exact arithmetic: x on a 2^-6 grid in [-1, 1], w on a 2^-4 grid, so
    every logit is a multiple of 2^-10 below 2^10 and any summation order
    gives the same f32 value. The columns ``ties`` are equal and lead on
    most rows: the lowest must win. All real biases are -16, so a padded
    column (logit 0) would win if it were a candidate. At every cluster
    size in ``clusters`` (by default each of 1-4 the device holds), twice,
    equal to the plain index."""
    r, d = 100, D_MODEL
    x = np.round(rng.uniform(-1, 1, (r, d)) * 64) / 64
    x[:, 0] = 255 / 64
    w = np.round(rng.uniform(-0.125, 0.125, (vocab, d)) * 16) / 16
    w[:, 0] = 0.0
    w[ties[0], 0] = 2.0
    w[ties[1:]] = w[ties[0]]
    b = np.full((vocab,), -16.0)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(DEV).bfloat16()  # noqa: E731
    xt, packed = to(x), ops.pack_generator(to(w), to(b))
    want = ops.generator_argmax_plain(xt, packed.w, packed.b, vocab)
    lead = int((want == ties[0]).sum())
    res = {"rows": r, "vocab": vocab, "chunks": packed.chunks, "ties": ties,
           "rows_led_by_tie": lead, "clusters": {}}
    for s in clusters or gen_held(packed):
        got = ops.generator_argmax(xt, packed, cluster=s)
        again = ops.generator_argmax(xt, packed, cluster=s)
        torch.cuda.synchronize()
        res["clusters"][str(s)] = {
            "equal": bool(torch.equal(got, want)), "two_calls_equal": bool(torch.equal(got, again)),
            "other_tie_won": bool(torch.isin(got, torch.tensor(ties[1:], device=DEV)).any()),
            "max_index": int(got.max())}
    log("kernels", kernel="generator_argmax", case="exact ties and padding", **res)
    bad = [s for s, c in res["clusters"].items()
           if not (c["equal"] and c["two_calls_equal"]) or c["other_tie_won"]]
    if bad or lead < r // 2:
        raise AssertionError(f"generator_argmax exact case: {res}")


def phase_decode_kernels():
    """The fused decode kernels against their plain versions at the main-path
    shapes, a ragged R and vocab, and exact ties; timed beside the plain
    version and cuBLAS's bf16 composite. At the main-path shape the
    generator kernel also runs at the other cluster sizes 1-4; the FFN's
    partial-sum mode at each of its shapes."""
    results = {"generator_argmax": [], "ffn": [], "ffn_partial": []}
    rng = np.random.RandomState(2)
    d = D_MODEL
    dev = torch.cuda.current_device()
    ptxas = _build.ptxas_info()
    for r, vocab, main in GEN_SHAPES:
        # the final-norm hidden, and the xavier / torch-default init ranges
        x = torch.from_numpy(rng.randn(r, d).astype(np.float32)).to(DEV).bfloat16()
        packed = ops.pack_generator(bf16_uniform(rng, (vocab, d), np.sqrt(6 / (d + vocab))),
                                    bf16_uniform(rng, (vocab,), 1 / np.sqrt(d)))
        w, b = packed.w, packed.b
        cluster = ops.generator_default_cluster(dev, r, d, vocab)
        name = f"gen_argmax_kernelILi{-(-d // 64)}E"
        row = gen_check(x, packed)
        row.update(
            shape=[r, d, vocab], main_path=main, cluster=cluster, chunk=ops.decode.GEN_CHUNK,
            **gen_launch(packed, cluster), ptxas=next(v for k, v in ptxas.items() if name in k),
            ms=cuda_ms(lambda: ops.generator_argmax(x, packed), reps=20),
            plain_ms=cuda_ms(lambda: ops.generator_argmax_plain(x, w, b, vocab), reps=20),
            library_ms=cuda_ms(lambda: torch.argmax(torch.addmm(b, x, w.t()), -1), reps=20),
            library="composite: torch.argmax(torch.addmm(b, x, W^T)) in bf16")
        if main:   # the vocab split against the other cluster sizes
            for s in gen_held(packed):
                if s != cluster:
                    row[f"cluster_{s}"] = dict(
                        gen_check(x, packed, cluster=s), **gen_launch(packed, s),
                        ms=cuda_ms(lambda: ops.generator_argmax(x, packed, cluster=s), reps=20))
        row["bound_ms"], row["bound_by"] = bound(
            2.0 * r * d * vocab, 2 * (r * d + vocab * d + vocab) + 8 * r, PEAK_BF16_FLOPS)
        log("kernels", kernel="generator_argmax", **row)
        results["generator_argmax"].append(row)
    # ties across lanes, chunks and ranks; vocab 1000 leaves the last chunk
    # ragged; vocab 200 is 2 chunks, so at 4 ranks ranks 0 and 2 own none
    gen_exact_case(rng, 1000, [37, 39, 53, 130, 677])
    gen_exact_case(rng, 200, [37, 150], clusters=[4])
    results["ffn"] = ffn_rows(rng)
    results["ffn_partial"] = ffn_partial_rows(rng)
    return results


def ffn_weights(rng, d, f):
    """bf16 (w1, b1, w2, b2) at the xavier / torch-default init ranges."""
    lim = np.sqrt(6 / (d + f))
    return (bf16_uniform(rng, (f, d), lim), bf16_uniform(rng, (f,), 1 / np.sqrt(d)),
            bf16_uniform(rng, (d, f), lim), bf16_uniform(rng, (d,), 1 / np.sqrt(f)))


def ffn_launch(packed, cluster):
    return ops.ffn_launch_info(torch.cuda.current_device(), packed.d, packed.chunks, cluster)


def ffn_auto_cluster(r, packed):
    return ops.ffn_default_cluster(torch.cuda.current_device(), r, packed.d, packed.chunks)


def ffn_check(x, packed, cluster=None):
    """The kernel against the plain version within rtol = atol = 2^-7
    (tests/test_decode_pallas.py allows 2e-2): the two sides sum the same
    exact bf16 products in f32 in other orders, so an output may round to
    its neighbouring bf16 value (2^-8 of |y|), and so may a hidden value,
    which moves y by 2^-8 |h| |w2|, below 2^-8 at these init ranges. Two
    calls on the same inputs must give the same bits."""
    got = ops.ffn(x, packed, cluster=cluster)
    again = ops.ffn(x, packed, cluster=cluster)
    want = ops.ffn_plain(x, packed.w1, packed.b1, packed.w2, packed.b2)
    torch.cuda.synchronize()
    shape = [x.shape[0], packed.d, packed.d_ff]
    if not torch.equal(got, again):
        raise AssertionError(f"ffn {shape} cluster {cluster}: two calls differ")
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rtol = atol = 2.0 ** -7
    if not bool(torch.isfinite(got).all()) or bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"ffn {shape} cluster {cluster}: kernel != plain beyond rtol = "
                             f"atol = 2^-7 (max abs err {float(err.max())})")
    big = want.abs() > atol
    return dict(max_abs_err=float(err.max()),
                max_rel_err=float((err[big] / want.abs()[big]).max()),
                share_not_bit_equal=float((got != want).float().mean()),
                max_abs_out=float(want.abs().max()), rtol=rtol, atol=atol,
                two_calls_bit_equal=True)


def ffn_exact_case(rng):
    """Exact arithmetic: x integers in [-2, 2], weights in {-1, 0, 1}, biases
    integers in [-4, 4]. Every f32 sum, in the hidden and in the output, is
    an integer below 2^24 in magnitude, exact in any order, so both bf16
    roundings see the same values on both sides and the kernel must equal
    the plain version bit for bit: a difference is a layout fault, not
    rounding. At the main-path shape on clusters of 1-4 blocks (the default
    among them), and at the widest d with a padded d_ff."""
    rows = []
    for r, d, f, cluster in [(2048, 128, 2048, 1), (2048, 128, 2048, 2), (2048, 128, 2048, None),
                             (2048, 128, 2048, 4), (2000, 256, 1040, None)]:
        def ints(lo, hi, shape):
            return torch.from_numpy(rng.randint(lo, hi + 1, shape).astype(np.float32)).to(
                DEV).bfloat16()
        x = ints(-2, 2, (r, d))
        w1, b1, w2, b2 = ints(-1, 1, (f, d)), ints(-4, 4, (f,)), ints(-1, 1, (d, f)), ints(-4, 4, (d,))
        packed = ops.pack_ffn(w1, b1, w2, b2)
        got = ops.ffn(x, packed, cluster=cluster)
        want = ops.ffn_plain(x, w1, b1, w2, b2)
        hid = torch.relu(x.float() @ w1.float().t() + b1.float())
        torch.cuda.synchronize()
        diff = torch.nonzero(got != want)
        row = {"shape": [r, d, f], "cluster": cluster or ffn_auto_cluster(r, packed),
               "bit_equal": bool(torch.equal(got, want)), "elements_differ": int(diff.shape[0]),
               "hidden_zero_share": float((hid == 0).float().mean()),
               "max_abs_hidden": float(hid.max()), "max_abs_out": float(want.float().abs().max())}
        if diff.shape[0]:
            i, j = (int(v) for v in diff[0])
            row["first_diff"] = {"row": i, "col": j, "got": float(got[i, j]),
                                 "want": float(want[i, j])}
        log("kernels", kernel="ffn", case="exact arithmetic", **row)
        rows.append(row)
    if not all(row["bit_equal"] for row in rows):
        raise AssertionError(f"ffn exact case: kernel != plain: {rows}")


def ffn_rows(rng):
    """The FFN kernel at every FFN_SHAPES shape and the exact case; timed
    beside the plain version and cuBLAS's bf16 composite. At the main-path
    shape also at the other cluster sizes 1-4."""
    ptxas = _build.ptxas_info()
    ffn_exact_case(rng)
    rows = []
    for r, d, f, main in FFN_SHAPES:
        x = torch.from_numpy(rng.randn(r, d).astype(np.float32)).to(DEV).bfloat16()
        w1, b1, w2, b2 = ffn_weights(rng, d, f)
        packed = ops.pack_ffn(w1, b1, w2, b2)
        cluster = ffn_auto_cluster(r, packed)
        nt = -(-d // 64)
        row = ffn_check(x, packed)
        row.update(
            shape=[r, d, f], main_path=main, cluster=cluster, **ffn_launch(packed, cluster),
            ptxas=next(v for k, v in ptxas.items() if f"ffn_kernelILi{nt}E" in k),
            ms=cuda_ms(lambda: ops.ffn(x, packed), reps=20),
            plain_ms=cuda_ms(lambda: ops.ffn_plain(x, w1, b1, w2, b2), reps=20),
            library_ms=cuda_ms(lambda: torch.addmm(
                b2, torch.relu(torch.addmm(b1, x, w1.t())), w2.t()), reps=20),
            library="composite: addmm -> relu -> addmm in bf16")
        if main:   # the d_ff split against the other cluster sizes
            for s in range(1, 5):
                if s != cluster:
                    row[f"cluster_{s}"] = dict(
                        ffn_check(x, packed, cluster=s), **ffn_launch(packed, s),
                        ms=cuda_ms(lambda: ops.ffn(x, packed, cluster=s), reps=20))
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * r * d * f, 2 * (2 * r * d + 2 * f * d + f + d), PEAK_BF16_FLOPS)
        log("kernels", kernel="ffn", **row)
        rows.append(row)
    return rows


def bf16_ints(rng, lo, hi, shape):
    return torch.from_numpy(rng.randint(lo, hi + 1, shape).astype(np.float32)).to(DEV).bfloat16()


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits), 0 at 0."""
    v = v.abs()
    return torch.where(v > 0, torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8), 0.0)


def ffn_partial_exact(rng, r, d, f, cluster):
    """Exact arithmetic, as ``ffn_exact_case``: x integers in [-2, 2], w1 and
    w2 in {-1, 0, 1}, b1 integers in [-4, 4]. Every f32 sum is an integer
    below 2^24, exact in any order, so both sides round the same hidden to
    bf16 and the kernel's f32 partial must equal the plain version bit for
    bit: a difference is a layout or epilogue fault, not rounding."""
    x = bf16_ints(rng, -2, 2, (r, d))
    w1, b1, w2 = bf16_ints(rng, -1, 1, (f, d)), bf16_ints(rng, -4, 4, (f,)), bf16_ints(
        rng, -1, 1, (d, f))
    packed = ops.pack_ffn(w1, b1, w2, bf16_ints(rng, -4, 4, (d,)))   # b2: never read
    got = ops.ffn_partial(x, packed, cluster=cluster)
    want = ops.ffn_partial_plain(x, w1, b1, w2)
    torch.cuda.synchronize()
    return {"bit_equal": bool(torch.equal(got, want)), "elements_differ": int((got != want).sum()),
            "max_abs_out": float(want.abs().max())}


def ffn_partial_check(x, packed, cluster=None):
    """The partial-sum kernel against ``ffn_partial_plain``. Both sides
    multiply the same bf16 operands, whose products are exact in f32, and
    sum them in other orders. Per output (i, c) the tolerance is

        d_ff 2^-23 S_ic + FFN_PARTIAL_FLIPS max_j ulp(h_ij) |w2_cj|,

    with S_ic = sum_j |h_ij w2_cj| over the plain version's bf16 hidden h
    and ulp the spacing of bf16 values: the first term bounds two f32 sums
    of d_ff terms in any order (2^-23 allows the tensor cores' truncating
    accumulation); the second lets FFN_PARTIAL_FLIPS hidden values of the
    row round to their other bf16 neighbour, as the first product's own
    reassociation can move them across a rounding midpoint, each moving
    y_ic by at most ulp(h_ij) |w2_cj|. The largest tolerance must lie
    within half a bf16 ulp of the largest output, since the ranks' sum is
    rounded to bf16 next. Two calls on the same inputs must give the same
    bits."""
    got = ops.ffn_partial(x, packed, cluster=cluster)
    again = ops.ffn_partial(x, packed, cluster=cluster)
    w1, b1, w2 = packed.w1, packed.b1, packed.w2
    hid = torch.relu(x.float() @ w1.float().t() + b1.float()).to(x.dtype).float()
    want = hid @ w2.float().t()
    reassoc = packed.d_ff * 2.0 ** -23 * (hid.abs() @ w2.float().abs().t())
    u, w = bf16_ulp(hid), w2.float().abs()
    flips = FFN_PARTIAL_FLIPS * torch.cat([(u[i:i + 256, None, :] * w).amax(-1)
                                           for i in range(0, u.shape[0], 256)])
    tol = reassoc + flips
    half_ulp = float(bf16_ulp(want.abs().max())) / 2
    torch.cuda.synchronize()
    what = f"ffn_partial {[x.shape[0], packed.d, packed.d_ff]} cluster {cluster}"
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two calls differ")
    if float(tol.max()) > half_ulp:
        raise AssertionError(f"{what}: tolerance {float(tol.max())} above half a bf16 ulp of "
                             f"the largest output ({half_ulp})")
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
        raise AssertionError(f"{what}: kernel != plain beyond the tolerance (max err/tol "
                             f"{float((err / tol).max())})")
    return dict(max_abs_err=float(err.max()), max_err_over_tol=float((err / tol).max()),
                tol_max=float(tol.max()), reassoc_tol_max=float(reassoc.max()),
                beyond_reassoc=int((err > reassoc).sum()), half_ulp_of_max_out=half_ulp,
                max_abs_out=float(want.abs().max()),
                share_not_bit_equal=float((got != want).float().mean()),
                two_calls_bit_equal=True)


def ffn_partial_rows(rng):
    """The partial-sum kernel at every FFN_PARTIAL_SHAPES shape, at clusters
    1-4 and the default, on random and on exact-arithmetic inputs; timed
    beside the plain version and cuBLAS's bf16 composite of the same
    slice."""
    ptxas = _build.ptxas_info()
    dev = torch.cuda.current_device()
    rows, exact = [], []
    for r, d, f, f_full, main in FFN_PARTIAL_SHAPES:
        x = torch.from_numpy(rng.randn(r, d).astype(np.float32)).to(DEV).bfloat16()
        w1, b1, w2, b2 = ffn_weights(rng, d, f_full)
        w1, b1, w2 = w1[:f].contiguous(), b1[:f].contiguous(), w2[:, :f].contiguous()
        packed = ops.pack_ffn(w1, b1, w2, b2)
        cluster = ops.ffn_default_cluster(dev, r, d, packed.chunks, True)
        row = ffn_partial_check(x, packed)
        row.update(
            shape=[r, d, f], d_ff=f_full, main_path=main, cluster=cluster,
            **ops.ffn_launch_info(dev, d, packed.chunks, cluster, True),
            ptxas=next(v for k, v in ptxas.items()
                       if f"ffn_partial_kernelILi{-(-d // 64)}E" in k),
            ms=cuda_ms(lambda: ops.ffn_partial(x, packed), reps=20),
            plain_ms=cuda_ms(lambda: ops.ffn_partial_plain(x, w1, b1, w2), reps=20),
            library_ms=cuda_ms(lambda: torch.mm(torch.relu(torch.addmm(b1, x, w1.t())), w2.t()),
                               reps=20),
            library="composite: addmm -> relu -> mm in bf16")
        for s in range(1, 5):
            case = ffn_partial_exact(rng, r, d, f, s)
            log("kernels", kernel="ffn_partial", case="exact arithmetic", shape=[r, d, f],
                cluster=s, **case)
            exact.append(case)
            row[f"cluster_{s}"] = dict(
                ffn_partial_check(x, packed, cluster=s),
                **ops.ffn_launch_info(dev, d, packed.chunks, s, True),
                ms=cuda_ms(lambda: ops.ffn_partial(x, packed, cluster=s), reps=20))
        row["max_abs_err"] = max(row["max_abs_err"],
                                 *(row[f"cluster_{s}"]["max_abs_err"] for s in range(1, 5)))
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * r * d * f, 2 * (r * d + 2 * f * d + f) + 4 * r * d, PEAK_BF16_FLOPS)
        log("kernels", kernel="ffn_partial", **row)
        rows.append(row)
    if not all(case["bit_equal"] for case in exact):
        raise AssertionError(f"ffn_partial exact case: kernel != plain: {exact}")
    return rows


def check_outputs(cfg, out):
    lc = out["lang_cap"]
    if tuple(lc.shape) != (B, cfg.num_proposals, cfg.max_des_len + 1):
        raise AssertionError(f"lang_cap shape {tuple(lc.shape)}")
    if int(lc.min()) < 0 or int(lc.max()) >= cfg.vocab_size:
        raise AssertionError("token id out of range")
    for k, v in out.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {k}")
    return {k: list(v.shape) for k, v in out.items()}


def split_ms_once(path, dev_batch, splits):
    """Coarse split of one forward, CUDA events around each part."""
    cfg, model = path["cfg"], path["model"]
    with torch.no_grad():
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


def compare_tokens(path, dev_batch, t_unfused, t_fused):
    """Fused against unfused tokens. On a row that differs, the two tokens
    at its first differing step must be within bf16 rounding of each other
    in the unfused decode's f32 logits at that step (as the port-vs-JAX test
    in tests/test_torch_models.py checks)."""
    steps = t_unfused.shape[-1]
    tu, tf = t_unfused.reshape(-1, steps).long(), t_fused.reshape(-1, steps).long()
    neq = tu != tf
    rows = torch.nonzero(neq.any(1))[:, 0]
    res = {"rows": int(tu.shape[0]), "rows_differ": int(rows.numel()),
           "tokens_differ": int(neq.sum())}
    if not rows.numel():
        return res
    first = neq.int().argmax(1)[rows]
    l_u = torch.empty(rows.numel(), device=DEV)
    l_f = torch.empty(rows.numel(), device=DEV)
    cap = path["model"].caption
    with torch.no_grad():
        obj = cap.object_tokens(path["model"].detect(dev_batch["point_clouds"]))
        w, caches, cross_kv, offset = cap.start_decode(obj)
        prev = torch.full((tu.shape[0],), SOS_ID, dtype=torch.long, device=DEV)
        for i in range(int(first.max()) + 1):
            logits = cap.next_logits(w, prev, i, caches, offset, cross_kv)
            sel = first == i
            r = rows[sel]
            l_u[sel] = logits[r, tu[r, i]]
            l_f[sel] = logits[r, tf[r, i]]
            prev = tu[:, i]
    gap = (l_u - l_f).abs()
    rel = gap / l_u.abs().clamp(min=1.0)
    res.update(first_step_min=int(first.min()), max_logit_gap=float(gap.max()),
               max_gap_over_bf16_rounding=float(rel.max() / 2 ** -7))
    if bool((rel > 2 ** -7).any()):
        raise AssertionError(f"fused and unfused tokens differ beyond bf16 rounding: {res}")
    return res


def phase_eval_forward():
    """The full-width eval forward, unfused (the default) and with the fused
    decode kernels, on the same seeded weights and batch, each through the
    default (captured) step and through the eager one (``capture=False``),
    timed and profiled in turns."""
    cfg = ModelConfig()
    rng = np.random.RandomState(0)
    _, point_clouds = bench_points(rng, B, cfg.num_points)
    center_label = rng.rand(B, 128, 3).astype(np.float32) * 6.0
    batch = {"point_clouds": point_clouds, "center_label": center_label}
    dev_batch = to_device_batch(batch, DEV)
    n_steps = cfg.max_des_len + 1
    paths = {
        "unfused": {"cfg": cfg, "want": {"fps": 2, "ball_query": 5,
                                         "generator_argmax": 0, "ffn": 0, "ffn_partial": 0}},
        "fused": {"cfg": dataclasses.replace(cfg, eval_decode_fused=True),
                  "want": {"fps": 2, "ball_query": 5, "generator_argmax": n_steps,
                           "ffn": cfg.num_layers * (n_steps + int(cfg.early_guide)),
                           "ffn_partial": 0}},
    }
    for p in paths.values():     # the flag travels in the model's config
        p["model"] = init_spacap(p["cfg"], seed=0, device=DEV)
        p["step"] = make_eval_step(p["cfg"], device=DEV)
        p["step"].program.keep_graphs = True      # for the profiles' node counts
        p["eager"] = make_eval_step(p["cfg"], device=DEV, capture=False)
    sd_u, sd_f = (paths[n]["model"].state_dict() for n in ("unfused", "fused"))
    if not all(torch.equal(sd_u[k], sd_f[k]) for k in sd_u):
        raise AssertionError("the two seeded models differ")
    legs = [*paths, *(f"{n}_eager" for n in paths)]

    outs = {}

    def forward(leg):
        name = leg.removesuffix("_eager")
        p = paths[name]
        step = p["eager" if leg.endswith("_eager") else "step"]
        before = {k: f.launches for k, f in KERNELS.items()}
        outs[leg] = step(p["model"], batch)
        torch.cuda.synchronize()
        got = {k: f.launches - before[k] for k, f in KERNELS.items()}
        if got != wrapper_want(step, p["want"]):
            raise AssertionError(f"{leg} forward: the wrappers counted {got}, want "
                                 f"{wrapper_want(step, p['want'])}")
        return outs[leg]

    # each path's main run: every count set to 0 just before, read just
    # after. Its first call captures (the wrappers count the warm-up's
    # launches and the capture's), its second replays under the profiler:
    # that replay's kernel spans by name are the launches of a forward
    launches, wrapper_launches, shapes, profs = {}, {}, {}, {}
    for name in paths:
        for k in KERNELS.values():
            k.launches = 0
        forward(name)
        profs[name] = device_profile(lambda: forward(name), paths[name]["want"],
                                     program=paths[name]["step"].program)
        wrapper_launches[name] = {k: f.launches for k, f in KERNELS.items()}
        launches[name] = profs[name]["kernel_spans"]
        shapes[name] = check_outputs(cfg, outs[name])
        if paths[name]["step"].program.last["captured"]:
            raise AssertionError(f"{name}: the main run captured again")
        if launches[name] != paths[name]["want"]:
            raise AssertionError(f"{name}: the replay's kernel spans {launches[name]}, "
                                 f"want {paths[name]['want']}")
        missing = [k for k, n in paths[name]["want"].items() if n and not wrapper_launches[name][k]]
        if missing:
            raise AssertionError(f"{name}: the main run never launched {missing}")
    tokens = compare_tokens(paths["unfused"], dev_batch, outs["unfused"]["lang_cap"],
                            outs["fused"]["lang_cap"])

    torch.cuda.reset_peak_memory_stats()
    times = {leg: [] for leg in legs}
    for leg in (legs + legs[::-1]) * 5:   # in turns, one machine
        t0 = time.perf_counter()
        forward(leg)
        times[leg].append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    splits = {name: {"trunk": [], "encode": [], "decode": [], "tail": []} for name in paths}
    for name in ["unfused", "fused", "fused", "unfused"] * 2:
        split_ms_once(paths[name], dev_batch, splits[name])
    summary = {}
    for leg in legs:
        name = leg.removesuffix("_eager")
        med = float(np.median(times[leg]))
        program = None if leg.endswith("_eager") else paths[name]["step"].program
        prof = (profs[name] if program is not None
                else device_profile(lambda: forward(leg), paths[name]["want"]))
        if "device_busy_ms" in prof:
            prof["device_busy_share"] = prof["device_busy_ms"] / (med * 1e3)
        split_ms = {k: float(np.median(v)) for k, v in splits[name].items()}
        log("eval_forward", path=leg, batch=B, num_points=cfg.num_points,
            proposals=cfg.num_proposals, decode_dtype=cfg.eval_decode_dtype,
            decode_stages=cfg.eval_decode_stages, captured=program is not None,
            launches=paths[name]["want"] if program is None else launches[name],
            wrapper_launches=None if program is None else wrapper_launches[name],
            outputs=shapes[name], forward_s=med,
            forward_s_all=times[leg], scenes_per_s=B / med, eager_split_ms=split_ms,
            peak_mem_gib=peak)
        log("profile", path=leg, **prof)
        summary[leg] = {"scenes_per_s": B / med, "forward_ms": med * 1e3,
                        "decode_ms": split_ms["decode"],
                        "device_busy_ms": prof.get("device_busy_ms"),
                        "device_busy_share": prof.get("device_busy_share"),
                        "device_spans": prof.get("device_spans"),
                        "graph_spans": prof.get("graph_spans"), "check": prof.get("check"),
                        "ffn_kernel_ms": prof.get("kernel_device_ms", {}).get("ffn")}
    busy = [summary[n]["device_busy_ms"] for n in ("unfused", "fused")]
    log("fused_vs_unfused", tokens=tokens, **summary,
        fused_minus_unfused_busy_ms=None if None in busy else busy[1] - busy[0])
    log("captured_vs_eager", **{name: {
        "captured_scenes_per_s": summary[name]["scenes_per_s"],
        "eager_scenes_per_s": summary[f"{name}_eager"]["scenes_per_s"],
        "captured_over_eager": summary[name]["scenes_per_s"]
        / summary[f"{name}_eager"]["scenes_per_s"],
        "captured_busy_ms": summary[name]["device_busy_ms"],
        "eager_busy_ms": summary[f"{name}_eager"]["device_busy_ms"]} for name in paths},
        peak_mem_gib=peak)
    main = {"fps": "unfused", "ball_query": "unfused", "generator_argmax": "fused",
            "ffn": "fused", "ffn_partial": "fused"}
    return ({k: launches[name][k] for k, name in main.items()},
            {k: wrapper_launches[name][k] for k, name in main.items()},
            summary["unfused"]["scenes_per_s"])


def wrapper_want(step, want):
    """What the kernel wrappers count in one call of an eval step whose
    forward launches ``want``: ``want`` where the call ran eagerly; for a
    captured step (``step.program``), twice ``want`` where the call
    captured (the eager warm-up, then the capture, which records each
    launch into its graph) and nothing where it replayed: a replay runs no
    Python, and its kernels are counted from their device spans
    (``device_profile``)."""
    program = getattr(step, "program", None)
    times = 1 if program is None else 2 if program.last["captured"] else 0
    return {k: times * n for k, n in want.items()}


def cuda_graph_nodes(graph):
    """The nodes of a captured graph (its ``raw_cuda_graph``, kept by a
    program with ``keep_graphs``) by type, through the driver API."""
    lib = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: CUresult {err}")
    check(lib.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, counts = ctypes.c_int(), collections.Counter()
    for node in nodes[:n.value]:
        check(lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        counts[GRAPH_NODE_TYPES.get(kind.value, "other")] += 1
    return dict(counts)


def last_key_graphs(program):
    """The graphs of the key ``program`` ran last (the most recently used)."""
    return next(reversed(program.entries.values())).graphs


def replayed_nodes(program):
    """The nodes of the graphs ``program`` replayed in its last call, by
    type (None where that call did not replay)."""
    if program is None or not program.last or program.last["captured"]:
        return None
    graphs, counts = last_key_graphs(program), collections.Counter()
    for k in program.last["replayed"]:
        counts.update(cuda_graph_nodes(graphs[k]))
    return dict(counts)


def differing(a, b):
    """The keys of two output dicts whose tensors are not ``torch.equal``
    (or that only one of them has)."""
    return sorted(set(a) ^ set(b)) + [k for k in a if k in b and not torch.equal(a[k], b[k])]


def table_batch(rng, cfg):
    """A grid batch in point-table mode: CAPTURE_TABLE_SCENES scenes of
    MUL_EVAL_POINTS points on the card, each row a scene and its subsample
    (uint16 indices, past 32,767)."""
    n = MUL_EVAL_POINTS
    table = bench_points(rng, CAPTURE_TABLE_SCENES, n)[1]
    batch = to_device_batch({
        "scene_row": rng.randint(0, CAPTURE_TABLE_SCENES, B).astype(np.int32),
        "pc_choices": np.stack([rng.choice(n, cfg.num_points, replace=False)
                                for _ in range(B)]).astype(np.uint16)}, torch.device(DEV))
    batch["point_table"] = torch.from_numpy(table).to(DEV)
    batch["center_table"] = torch.from_numpy(
        rng.rand(CAPTURE_TABLE_SCENES, 128, 3).astype(np.float32) * 6.0).to(DEV)
    return batch


def phase_captured_eval():
    """The captured eval step (``make_eval_step``'s default on CUDA, a
    ``train/capture.py::CapturedFunction``) against the eager one
    (``capture=False``) at full width (default ModelConfig, B = 8, 40,000
    points, seeded weights), unfused, fused, compact, in point-table mode,
    and with the decode's early exit at 4 stages (a graph a stage: with the
    seeded weights every stage runs; with the EOS logit raised the first
    stage's test skips the rest). Gates, each path: the wrappers count a
    forward's launches twice in the capture call (the eager warm-up, then
    the capture) and not at all in a replay; a profiled replay's kernel
    spans are FPS 2, ball query 5 and the decode kernels 0, or 31 and 192
    fused; the outputs of the capture call and of the replays equal the
    eager step's under ``torch.equal``, every key. On the unfused
    path also: outputs kept from one replay are unchanged after
    CAPTURE_LATER replays of other batches; parameters and BN buffers
    updated in place reach the next replay (no recapture; its outputs equal
    the eager step's on the new weights and differ from the old); a
    replaced parameter recaptures (one graph set left). Logs the capture
    seconds a key, the graphs and nodes of each replay, eager against
    eager, and the peak memory with every path's graphs held."""
    base = ModelConfig()
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        _, pc = bench_points(rng, B, base.num_points)
        batches.append(to_device_batch({"point_clouds": pc, "center_label": (
            rng.rand(B, 128, 3) * 6.0).astype(np.float32)}, torch.device(DEV)))
    n_steps = base.max_des_len + 1
    plain = {"fps": 2, "ball_query": 5, "generator_argmax": 0, "ffn": 0, "ffn_partial": 0}
    fused = dict(plain, generator_argmax=n_steps,
                 ffn=base.num_layers * (n_steps + int(base.early_guide)))
    early = dataclasses.replace(base, eval_decode_early_exit=True, eval_decode_stages=4)
    paths = {
        "unfused": (base, False, plain, None),
        "fused": (dataclasses.replace(base, eval_decode_fused=True), False, fused, None),
        "compact": (base, True, plain, None),
        "point_table": (base, True, plain, None),
        "early_exit": (early, False, plain, None),
        "early_exit_skip": (early, False, plain, CAPTURE_EOS_BIAS),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held, results = [], {}

    def counted(step, model, batch, want, what):
        for k in KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = step(model, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: f.launches for k, f in KERNELS.items()}
        if got != wrapper_want(step, want):
            raise AssertionError(f"captured_eval {what}: the wrappers counted {got}, want "
                                 f"{wrapper_want(step, want)}")
        return out, wall

    for name, (cfg, compact, want, eos_bias) in paths.items():
        model = init_spacap(cfg, seed=0, device=DEV)
        if eos_bias is not None:
            with torch.no_grad():
                model.caption.model.generator.proj.bias[EOS_ID] += eos_bias
        step = make_eval_step(cfg, device=DEV, compact=compact)
        step.program.keep_graphs = True
        eager = make_eval_step(cfg, device=DEV, compact=compact, capture=False)
        batch = table_batch(rng, cfg) if name == "point_table" else batches[0]
        warm, capture_wall = counted(step, model, batch, want, f"{name} capture")
        captured = dict(step.program.last)
        replay, replay_wall = counted(step, model, batch, want, f"{name} replay")
        replayed = dict(step.program.last)
        # a profiled replay: its kernel spans by name are its launches
        profiled = []
        prof = device_profile(lambda: profiled.append(counted(
            step, model, batch, want, f"{name} profiled replay")), want, program=step.program)
        want_out = eager(model, batch)
        again = eager(model, batch)
        graphs = last_key_graphs(step.program)
        res = {"capture_s": captured["capture_s"], "capture_call_s": capture_wall,
               "graphs": len(graphs), "graph_nodes": [cuda_graph_nodes(g) for g in graphs],
               "replayed_graphs": replayed["replayed"], "replay_call_s": replay_wall,
               "launches": prof["kernel_spans"], "profile_check": prof.get("check"),
               "graph_spans": prof.get("graph_spans"), "graph_nodes_replayed":
               prof.get("graph_nodes"), "device_busy_ms": prof.get("device_busy_ms"),
               "replay_vs_eager": differing(replay, want_out),
               "profiled_replay_vs_eager": differing(profiled[-1][0], want_out),
               "warm_up_vs_eager": differing(warm, want_out),
               "eager_vs_eager": differing(want_out, again)}
        if not captured["captured"] or replayed["captured"]:
            raise AssertionError(f"captured_eval {name}: capture {captured}, replay {replayed}")
        if prof["kernel_spans"] != want:
            raise AssertionError(f"captured_eval {name}: the replay's kernel spans "
                                 f"{prof['kernel_spans']}, want {want}")
        if name == "early_exit_skip":
            res["all_eos"] = bool((want_out["lang_cap"] == EOS_ID).all())
            if len(replayed["replayed"]) != 2 or not res["all_eos"]:
                raise AssertionError(f"captured_eval {name}: graphs {replayed['replayed']} "
                                     f"replayed, all EOS {res['all_eos']}")
        elif name == "early_exit" and len(replayed["replayed"]) != len(graphs):
            raise AssertionError(f"captured_eval {name}: graphs {replayed['replayed']} replayed")
        if name == "unfused":
            res.update(unfused_extras(step, eager, model, batches, want))
        results[name] = res
        log("captured_eval", path=name, **res)
        if any(res.get(k) for k in ("replay_vs_eager", "profiled_replay_vs_eager",
                                    "warm_up_vs_eager", "kept_changed", "updated_vs_eager",
                                    "replaced_vs_eager")):
            raise AssertionError(f"captured_eval {name}: outputs differ: {res}")
        held.append((step, model))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("captured_eval", graphs_held=sum(len(s.program.entries) for s, _ in held),
        peak_mem_gib_with_graphs=peak,
        reserved_gib=torch.cuda.memory_reserved() / 2 ** 30)
    del held
    torch.cuda.empty_cache()
    return results


def unfused_extras(step, eager, model, batches, want):
    """Kept outputs, in-place updates and a replaced parameter (see
    ``phase_captured_eval``) on the unfused path."""
    res = {}
    kept = step(model, batches[1])
    kept_want = eager(model, batches[1])
    for j in range(CAPTURE_LATER):
        step(model, batches[j % 3])
    torch.cuda.synchronize()
    res["kept_changed"] = differing(kept, kept_want)
    before = step(model, batches[0])
    with torch.no_grad():
        for prm in model.parameters():
            prm.mul_(1.01)
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(buf * 1.02)
    updated = step(model, batches[0])
    res["updated_recaptured"] = step.program.last["captured"]
    res["updated_vs_eager"] = differing(updated, eager(model, batches[0]))
    res["updated_moved"] = differing(updated, before)
    if res["updated_recaptured"] or not res["updated_moved"]:
        raise AssertionError(f"captured_eval: an in-place update recaptured "
                             f"({res['updated_recaptured']}) or moved nothing")
    head = model.proposal.proposal[6]
    bias = head.bias.detach().clone()
    bias[1] += 2.0
    head.bias = torch.nn.Parameter(bias)
    step(model, batches[0])
    res["replaced_recaptured"] = step.program.last["captured"]
    replaced = step(model, batches[0])
    res["replaced_vs_eager"] = differing(replaced, eager(model, batches[0]))
    res["graph_sets_after_replace"] = len(step.program.entries)
    if not res["replaced_recaptured"] or res["graph_sets_after_replace"] != 1:
        raise AssertionError(f"captured_eval: a replaced parameter: {res}")
    return res


@contextlib.contextmanager
def fps_sites():
    """Wraps each ``ops.furthest_point_sample`` call of the model in a
    profiler range named for its site (a forward or a train step samples at
    SA1, then at the vote aggregation), so that a profile that lost an FPS
    span can say which launch it was."""
    real, calls = ops.furthest_point_sample, [0]

    def annotated(xyz, npoint, **kw):
        site = ("SA1", "aggregation")[calls[0] % 2]
        calls[0] += 1
        with torch.profiler.record_function(f"fps_site {site} {xyz.shape[1]}->{npoint}"):
            return real(xyz, npoint, **kw)

    ops.furthest_point_sample = annotated
    try:
        yield
    finally:
        ops.furthest_point_sample = real


def fps_launch_report(events):
    """Each FPS site range of a profile: the CPU-side kernel launch calls
    the trace holds inside it, and how many of them have their device span
    (a launch call and its kernel share a correlation id)."""
    spans = {e.id for e in events if e.device_type == DeviceType.CUDA}
    calls = [e for e in events if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name]
    report = []
    for r in sorted((e for e in events if e.name.startswith("fps_site ")),
                    key=lambda e: e.time_range.start):
        inside = [c for c in calls if c.thread == r.thread
                  and r.time_range.start <= c.time_range.start <= r.time_range.end]
        report.append({"site": r.name[len("fps_site "):], "cpu_launch_calls": len(inside),
                       "device_spans": sum(c.id in spans for c in inside)})
    return report


def runtime_calls(events, kinds=("LaunchKernel", "Memcpy")):
    """The CPU-side CUDA runtime calls of a profile that start device work
    (kernel launches and copies), in time order."""
    return sorted((e for e in events if e.device_type == DeviceType.CPU
                   and any(k in e.name for k in kinds)), key=lambda e: e.time_range.start)


def device_profile(fn, want, tries=3, program=None):
    """One call of ``fn`` under torch.profiler: the device's busy time (the
    union of its kernel and copy spans), their count, and the kernels with
    the most device time.

    The window opens with PROFILE_MARKERS marker kernels
    (``torch.cuda._sleep``) launched on the stream just before ``fn()`` and
    waited for; only the runtime calls after the markers', and the device
    spans after the last marker's span, count (``markers_lost``: the markers
    whose spans the profile dropped). A profile is complete when the last
    marker has its span, every kernel launch
    and every copy ``fn`` made (a runtime call and its device span share a
    correlation id) has its span, the host-to-device copies among them
    included, and each PROFILED kernel's spans number the launches ``fn``
    made (``want``: launches of one forward; ``fn`` checks the wrappers'
    counts). Where ``fn`` replays the graphs of a captured step
    (``program``, its ``CapturedFunction``, which keeps its graphs:
    ``keep_graphs``), each graph launch's kernels share that launch's
    correlation id: the spans of the window's graph launches must then
    number the kernel, copy and memset nodes of the graphs the call
    replayed, read from those graphs (``replayed_nodes``; ``check``: "graph
    nodes", else "launch calls"). The kernel spans by name are then the
    launches of the replayed forward on the card. An incomplete profile is
    taken again, up to ``tries`` times, and logs the calls that lost their
    spans (the runtime call, the op that made it and, for FPS, its site);
    if none is complete, no busy time is reported and the result names
    what each try lost."""
    lost_by_try = []
    for attempt in range(tries):
        with fps_sites(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as p:
            with torch.profiler.record_function("profile_window_marker"):
                for _ in range(PROFILE_MARKERS):
                    torch.cuda._sleep(PROFILE_MARKER_CYCLES)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            wall_ms = (time.perf_counter() - t0) * 1e3
        nodes = replayed_nodes(program)
        replayed = nodes is not None
        graph_want = (sum(nodes.get(k, 0) for k in GRAPH_NODE_TYPES.values())
                      if replayed else None)
        events = p.events()
        device_events = [e for e in events if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)]
        device = {e.id: e for e in device_events}
        per_id = collections.Counter(e.id for e in device_events)
        marker = next(e for e in events if e.name == "profile_window_marker"
                      and e.device_type == DeviceType.CPU)
        calls = runtime_calls(events)
        marker_calls = [c for c in calls if c.thread == marker.thread
                        and marker.time_range.start <= c.time_range.start <= marker.time_range.end]
        # the window opens at the last marker's span: it must be there
        marker_span = device.get(marker_calls[-1].id) if marker_calls else None
        head_lost = sum(c.id not in device for c in marker_calls)
        window = [c for c in calls if c.time_range.start > marker.time_range.end]
        lost = [{"call": c.name, "op": c.cpu_parent.name if c.cpu_parent else None}
                for c in window if c.id not in device]
        graph_calls = [c for c in runtime_calls(events, ("GraphLaunch",))
                       if c.time_range.start > marker.time_range.end]
        graph_spans = sum(per_id[c.id] for c in graph_calls)
        copies = [c for c in window if "Memcpy" in c.name]
        htod = [device[c.id] for c in copies if c.id in device and "HtoD" in device[c.id].name]
        opened = marker_span.time_range.end if marker_span is not None else float("inf")
        # kernels and copies; not the ranges that annotate them (the
        # optimizer's step is one)
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in device_events
                       if e.time_range.start >= opened)
        counted = {k: sum(pat in name for _, _, name in spans) for k, pat in PROFILED.items()}
        copy_counts = {"copy_calls": len(copies), "copy_spans": sum(c.id in device for c in copies),
                       "htod_spans": len(htod)}
        graphs = {"check": "graph nodes" if replayed else "launch calls",
                  "graph_launches": len(graph_calls), "graph_spans": graph_spans,
                  "graph_nodes": graph_want}
        if (marker_span is not None and not lost and counted == want
                and graph_spans == (graph_want or 0)):
            break
        lost_by_try.append({"marker_span": marker_span is not None, "lost": lost[:12],
                            "markers_lost": head_lost, "lost_calls": len(lost),
                            "kernel_spans": counted, **graphs})
        log("profile", incomplete=True, attempt=attempt, marker_span=marker_span is not None,
            markers_lost=head_lost, lost_calls=len(lost), lost=lost[:12], kernel_spans=counted,
            launches=want, **graphs,
            device_spans=len(spans), window_calls=len(window), **copy_counts,
            fps_launches=fps_launch_report(events))
    else:
        return {"device_busy": f"not measured: each of {tries} profiles lost spans",
                "lost_by_try": lost_by_try, "kernel_spans": counted, "launches": want, **graphs}
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    ours = {k: sum(t for name, t in by_name.items() if pat in name) / 1e3
            for k, pat in PROFILED.items()}
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "device_spans": len(spans), "kernel_spans": counted, "window_calls": len(window),
            **copy_counts, **graphs, "markers_lost": head_lost, "incomplete_profiles": attempt,
            "lost_by_try": lost_by_try,
            "kernel_device_ms": ours,
            "top_device_ms": [[name[:90], t / 1e3] for name, t in top]}


def host_cpu():
    """The host's CPU as ``lscpu`` gives it (vendor, model name, family and
    model number: a virtual machine may report the name as unknown) and
    its logical CPUs."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    fields = dict(ln.split(":", 1) for ln in out.splitlines() if ":" in ln)
    return {k: fields.get(k, "not reported").strip()
            for k in ("Vendor ID", "Model name", "CPU family", "Model")} | {
        "logical_cpus": os.cpu_count()}


def host_inputs(rng):
    """One scene's worth of each binding's inputs, as the grid and the train
    CLI give them: a 52,000-point room of 6 x 6 x 3 m whose floor lies near
    z = 0, 40,000 of its points drawn, ~30 instances, 256 proposal boxes of
    0.3-2 m with scores and 18 classes."""
    n, k = HOST_SCENE_POINTS, HOST_DRAWN
    xyz = rng.rand(n, 3) * [6.0, 6.0, 3.0]
    xyz[: n // 3, 2] = rng.randn(n // 3) * 0.01          # the floor
    ins = rng.randint(0, HOST_INSTANCES, n)
    sem = rng.randint(0, 41, n)
    idx = rng.choice(n, k, replace=False)
    cen = rng.rand(HOST_BOXES, 3) * [6.0, 6.0, 3.0]
    size = 0.3 + rng.rand(HOST_BOXES, 3) * 1.7
    lo, hi = (cen - size / 2).astype(np.float32), (cen + size / 2).astype(np.float32)
    score = rng.rand(HOST_BOXES).astype(np.float32)
    cls = rng.randint(0, 18, HOST_BOXES).astype(np.float64)
    pc = xyz[idx].astype(np.float32)
    return {
        "choice_noreplace_native": lambda: (n, k, np.random.RandomState(7)),
        "gather_rows f32": lambda: (np.ascontiguousarray(np.c_[xyz, xyz[:, 2]], np.float32), idx),
        "gather_rows f64": lambda: (np.ascontiguousarray(np.c_[xyz, xyz[:, 2]]), idx),
        "percentile_z": lambda: (xyz[:, 2], 0.99),
        "compute_votes_native": lambda: (xyz, ins, sem, ScannetDatasetConfig().nyu40ids),
        "greedy_nms_native": lambda: (lo.astype(np.float64), hi.astype(np.float64), cls,
                                      np.argsort(score), 0.25, 1e-8),
        "points_in_boxes_native": lambda: (pc, lo, hi, 5),
    }


def host_equal(a, b):
    if isinstance(a, tuple):
        return all(host_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


def phase_host():
    """The host library (``csrc/spacap_host.cpp`` through ``data/native.py``):
    its build at first use, then each binding against its plain numpy
    version at the grid's and the train CLI's shapes (HOST_SCENE_POINTS,
    HOST_DRAWN, HOST_INSTANCES, HOST_BOXES): equal under ``==`` (the choice
    also in the state it leaves: the next draws agree), and HOST_RUNS timed
    calls of each, library and plain in turns, as host ms. Also the floor's
    distance from np.percentile in ulps."""
    compiled = not any(_build.BUILD_DIR.glob("libspacap_host-*.so"))
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    inputs = host_inputs(np.random.RandomState(0))
    rows, bad = {}, []
    for name, make in inputs.items():
        binding = name.split()[0]
        lib_fn, plain_fn = getattr(native, binding), getattr(native, PLAIN_BINDINGS[binding])
        a, b = make(), make()
        got, want = lib_fn(*a), plain_fn(*b)
        equal = host_equal(got, want)
        if binding == "choice_noreplace_native":
            equal = equal and host_equal(a[2].randn(5), b[2].randn(5))
        times = {"library": [], "plain": []}
        for i in range(HOST_RUNS):
            for leg in (("library", "plain") if i % 2 == 0 else ("plain", "library")):
                args = make()
                fn = lib_fn if leg == "library" else plain_fn
                t0 = time.perf_counter()
                fn(*args)
                times[leg].append((time.perf_counter() - t0) * 1e3)
        rows[name] = {"equal": equal, "library_ms": float(np.median(times["library"])),
                      "plain_ms": float(np.median(times["plain"])),
                      "library_ms_all": times["library"], "plain_ms_all": times["plain"]}
        if not equal:
            bad.append(name)
    z = inputs["percentile_z"]()[0]
    floor, ref = native.percentile_z(z, 0.99), float(np.percentile(z, 0.99))
    log("host", cpu=host_cpu(), build_s=build_s, compiled_here=compiled,
        library=os.path.basename(str(_build.host_build())), flags=_build.HOST_FLAGS,
        shapes={"scene_points": HOST_SCENE_POINTS, "drawn": HOST_DRAWN,
                "instances": HOST_INSTANCES, "boxes": HOST_BOXES}, runs=HOST_RUNS,
        floor_minus_np_percentile_ulps=(floor - ref) / float(np.spacing(abs(ref))),
        bindings=rows)
    if bad:
        raise AssertionError(f"host bindings differ from their plain versions: {bad}")
    return rows


@contextlib.contextmanager
def host_leg(leg, calls=None):
    """The ``library`` leg runs the host library; the ``plain`` leg puts each
    binding's plain numpy version in its place on ``data/native.py`` (the
    data layer and the detection eval call them through the module).
    ``calls`` (a dict) counts each binding's calls in either leg."""
    real = {name: getattr(native, name) for name in PLAIN_BINDINGS}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return run

    for name, plain in PLAIN_BINDINGS.items():
        fn = real[name] if leg == "library" else getattr(native, plain)
        setattr(native, name, counted(name, fn) if calls is not None else fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(native, name, fn)


def padded_vocabulary(anns):
    """The vocabulary of ``anns``, padded with filler words to the default
    model's 4528 entries, so that the model has the full generator."""
    vocab = Vocabulary.build(anns)
    for i in range(len(vocab), ModelConfig().vocab_size):
        vocab.word2idx[f"filler_{i}"] = i
        vocab.idx2word[str(i)] = f"filler_{i}"
    return vocab


def mul_eval_split(root, num_scenes):
    """A synthetic val split written under ``root``: ``num_scenes`` scenes
    of MUL_EVAL_SCENE, one annotation an object, and a vocabulary built
    from them and padded with filler words to the model's 4528 entries."""
    anns, scene_ids = write_synthetic_dataset(root, num_scenes=num_scenes, seed=0,
                                              anns_per_object=1, **MUL_EVAL_SCENE)
    vocab = padded_vocabulary(anns)
    store = SceneStore(DataConfig(data_root=root).scannet_data, scene_ids)
    return anns, store, vocab


def mul_eval_dataset(anns, store, vocab, num_scenes):
    """A fresh dataset (an empty per-scene cache) over the first
    ``num_scenes`` scenes, one annotation a scene (the eval protocol), and
    the caption corpus of their objects."""
    scenes = sorted(store.scenes)[:num_scenes]
    anns = [a for a in anns if a["scene_id"] in scenes]
    seen = set()
    eval_list = [a for a in anns if not (a["scene_id"] in seen or seen.add(a["scene_id"]))]
    ds = ScanReferDataset(eval_list, store, vocab, ScannetDatasetConfig(),
                          DataConfig(num_points=ModelConfig().num_points, augment=False,
                                     use_relation=False), split="val")
    return ds, anns


def counted_step(step, per_forward, want):
    """``step`` that appends to ``per_forward`` each call's counts of every
    kernel's launches (the wrappers count on the calling thread, the grid's
    main thread) and what they should be (``wrapper_want``)."""
    def run(model, batch):
        before = {k: f.launches for k, f in KERNELS.items()}
        out = step(model, batch)
        per_forward.append(({k: f.launches - before[k] for k, f in KERNELS.items()},
                            wrapper_want(step, want)))
        return out
    return run


def numeric(metrics, seed):
    return {"seed": seed, **{k: v for k, v in metrics.items() if k != "detection"}}


def phase_mul_eval(forward_scenes_per_s):
    """The eval harness at full width (default ModelConfig, B = 8, seeded
    weights with the objectness-1 logit raised by 2, so that random weights
    detect) on a synthetic split of 141 scenes of ~52,000 points, written
    to a temporary directory. Gates: on 16 scenes and seeds 0 and 1, the
    grid (point table on and off) and the serial protocol (``eval_cap``
    with the full step over ``DataLoader(seed=s)``, in scene order and
    shuffled) give equal per-seed rows, at min_iou 0.05 so that
    candidates survive, and the seeds' rows differ; the point table's
    uint16 indices pass 32,767; every grid forward launches FPS 2, ball
    query 5 and the decode kernels 0 times (as the wrappers count them:
    ``wrapper_want``); every metric is finite. Then
    the grid over
    141 scenes x MUL_EVAL_SEEDS seeds, cold (a fresh dataset each repeat),
    as bench.py times it: rows over the wall time of the whole call, the
    median of MUL_EVAL_REPEATS, with each repeat's phases. The grid runs
    the default (captured) compact step; the gate's grid also runs the
    eager one (``capture=False``), whose rows must be equal. Each repeat
    runs three legs in turns: the captured step with the host library and
    with its plain numpy versions (``host_leg``), and the eager step with
    the library; their rows must equal the first repeat's; each leg's
    rows/s, ``table_s``, ``launch_s`` and ``post_s`` are logged. The gate's
    first grid is the counted run (every count set to 0 just before; its
    first call captures). Returns its launches."""
    cfg = ModelConfig()
    model = init_spacap(cfg, seed=0, device=DEV)
    with torch.no_grad():
        model.proposal.proposal[6].bias[1] += 2.0
    grid_step = make_eval_step(cfg, device=DEV, compact=True)
    eager_step = make_eval_step(cfg, device=DEV, compact=True, capture=False)
    per_forward = []
    want = {"fps": 2, "ball_query": 5, "generator_argmax": 0, "ffn": 0, "ffn_partial": 0}
    meteor = Meteor()
    meteor.close()

    def forwards_ok(what):
        bad = [(got, expected) for got, expected in per_forward if got != expected]
        if bad or not per_forward:
            raise AssertionError(f"{what}: {len(bad)} of {len(per_forward)} forwards counted "
                                 f"other than they should (counted, want): {bad[:3]}")
        n = len(per_forward)
        per_forward.clear()
        return n

    with tempfile.TemporaryDirectory(prefix="mul_eval_") as root:
        t0 = time.perf_counter()
        anns, store, vocab = mul_eval_split(root, MUL_EVAL_SCENES)
        write_s = time.perf_counter() - t0
        dc = ScannetDatasetConfig()
        points = [len(sc.mesh_vertices) for sc in store.scenes.values()]

        # gate 1: grid (table on, off) and serial rows on 16 scenes x 2 seeds
        ds, gate_anns = mul_eval_dataset(anns, store, vocab, MUL_EVAL_GATE_SCENES)
        corpus, organized = prepare_corpus(gate_anns), organize_annotations(gate_anns)
        rows, timings = {}, {}
        for table, step in (("auto", grid_step), ("off", grid_step), ("eager", eager_step)):
            timings[table] = {}
            if table == "auto":         # the counted run: its first call captures
                for k in KERNELS.values():
                    k.launches = 0
            rows[table] = mul_eval_grid(
                counted_step(step, per_forward, want), model, ds, vocab, dc, corpus, organized,
                MUL_EVAL_GATE_SEEDS, B, min_iou=MUL_EVAL_GATE_IOU, timing_out=timings[table],
                point_table="off" if table == "off" else "auto", device=DEV)
            if table == "auto":
                launches = {k: f.launches for k, f in KERNELS.items()}
                missing = [k for k, n in want.items() if n and not launches[k]]
                if missing:
                    raise AssertionError(f"the counted grid never launched {missing}")
            forwards_ok(f"gate grid, {table}")
        if not timings["auto"]["point_table"] or timings["off"]["point_table"]:
            raise AssertionError(f"point tables: {timings}")
        # the serial protocol in scene order, and shuffled: its batches then
        # hold other scenes than the grid's, so equal rows also show that a
        # row's result does not depend on what shares its batch
        full_step, serial, matched = make_eval_step(cfg, device=DEV), {}, []
        for shuffle in (False, True):
            serial[shuffle] = []
            for seed in MUL_EVAL_GATE_SEEDS:
                metrics, candidates = eval_cap(
                    full_step, model, ds,
                    DataLoader(ds, B, shuffle=shuffle, seed=seed, num_workers=8),
                    vocab, dc, gate_anns, min_iou=MUL_EVAL_GATE_IOU, also_detection=True,
                    device=DEV)
                serial[shuffle].append(numeric(metrics, seed))
                matched.append(sum(c != ["sos eos"] for c in candidates.values()))
        equal = {"off": rows["off"] == rows["auto"], "eager": rows["eager"] == rows["auto"],
                 "serial": serial[False] == rows["auto"],
                 "serial_shuffled": serial[True] == rows["auto"]}
        choices = ds.getitem_cached(0, np.random.RandomState(0), with_points=False)["pc_choices"]
        log("mul_eval", gate="rows", scenes=MUL_EVAL_GATE_SCENES, seeds=MUL_EVAL_GATE_SEEDS,
            min_iou=MUL_EVAL_GATE_IOU, scene_points_min=min(points),
            scene_points_max=max(points), write_s=write_s, rows=rows["auto"],
            equal=equal, serial_matched_candidates=matched, corpus_keys=len(corpus),
            pc_choices_dtype=str(choices.dtype), pc_choices_max=int(choices.max()),
            pc_choices_share_above_32767=float((choices > 32767).mean()),
            meteor_is_exact=meteor.is_exact, timing=timings["auto"])
        if not all(equal.values()):
            raise AssertionError(f"grid rows differ from {[k for k, v in equal.items() if not v]}:"
                                 f" grid {rows['auto']}, off {rows['off']}, serial {serial}")
        if choices.dtype != np.uint16 or choices.max() <= 32767:
            raise AssertionError(f"pc_choices {choices.dtype}, max {choices.max()}: the gate "
                                 "does not reach uint16 indices past 32,767")
        if rows["auto"][0] == rows["auto"][1]:
            raise AssertionError("the two seeds' rows are equal: the comparison is vacuous")

        # a grid forward alone, in point-table mode: host launch and synced
        # forward time, against the grid's launch_s a forward
        ds, full_anns = mul_eval_dataset(anns, store, vocab, MUL_EVAL_SCENES)
        tables = mul_eval_tables(ds, DEV)
        batch = to_device_batch({"pc_choices": np.stack([ds.getitem_cached(
            i, np.random.RandomState(i), with_points=False)["pc_choices"] for i in range(B)]),
            "scene_row": tables[2][:B]}, torch.device(DEV))
        batch.update(point_table=tables[0], center_table=tables[1])
        launch_ms, forward_ms = {"captured": [], "eager": []}, {"captured": [], "eager": []}
        for _ in range(6):
            for leg, step in (("captured", grid_step), ("eager", eager_step)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(model, batch)
                launch_ms[leg].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                forward_ms[leg].append((time.perf_counter() - t0) * 1e3)
        del batch, tables

        corpus, organized = prepare_corpus(full_anns), organize_annotations(full_anns)
        seeds = list(range(MUL_EVAL_SEEDS))
        legs = ("library", "plain", "eager")
        rps = {leg: [] for leg in legs}
        repeats = {leg: [] for leg in legs}
        want_rows = None
        for rep in range(MUL_EVAL_REPEATS):
            # the legs in turns, their order rotated a repeat: the captured
            # step with the library, with the plain versions swapped in, and
            # the eager step with the library
            for leg in legs[rep % 3:] + legs[:rep % 3]:
                ds, _ = mul_eval_dataset(anns, store, vocab, MUL_EVAL_SCENES)
                timing, host_calls = {}, {}
                step = eager_step if leg == "eager" else grid_step
                with host_leg("plain" if leg == "plain" else "library", host_calls):
                    t0 = time.perf_counter()
                    rows = mul_eval_grid(counted_step(step, per_forward, want), model, ds,
                                         vocab, dc, corpus, organized, seeds, B, num_workers=8,
                                         score_workers=min(8, len(seeds)), timing_out=timing,
                                         device=DEV)
                    total_s = time.perf_counter() - t0
                forwards = forwards_ok(f"grid repeat {rep}, {leg}")
                bad = [r for r in rows if not all(np.isfinite(v) for v in r.values())]
                if len(rows) != len(seeds) or bad:
                    raise AssertionError(f"grid rows: {len(rows)}, non-finite {bad}")
                if want_rows is None:
                    want_rows = rows
                elif rows != want_rows:
                    raise AssertionError(f"grid repeat {rep}, {leg} leg: rows {rows} differ "
                                         f"from the first repeat's {want_rows}")
                rps[leg].append(MUL_EVAL_SCENES * len(seeds) / total_s)
                repeats[leg].append(dict(timing, total_s=total_s, rows_per_s=rps[leg][-1],
                                         host_calls=host_calls))
                log("mul_eval", repeat=rep, leg=leg, scenes=MUL_EVAL_SCENES, seeds=len(seeds),
                    batch=B, forwards=forwards, rows_per_s=rps[leg][-1], total_s=total_s,
                    phases=timing, host_calls=host_calls, rows=rows)
    med = int(np.argsort(rps["library"])[len(rps["library"]) // 2])
    phases = repeats["library"][med]
    legs = {leg: {"rows_per_s": float(np.median(rps[leg])),
                  **{k: float(np.median([r[k] for r in repeats[leg]]))
                     for k in ("table_s", "stream_s", "launch_s", "consume_s", "post_s",
                               "load_s", "fetch_s", "score_s", "total_s")},
                  "host_calls": repeats[leg][0]["host_calls"]} for leg in rps}
    log("mul_eval", legs=legs, rows_equal_across_legs=True,
        library_over_plain_rows_per_s=legs["library"]["rows_per_s"] / legs["plain"]["rows_per_s"],
        captured_over_eager_rows_per_s=legs["library"]["rows_per_s"] / legs["eager"]["rows_per_s"],
        launch_ms_per_forward={leg: legs[leg]["launch_s"] / phases["forwards"] * 1e3
                               for leg in legs})
    log("mul_eval", mul_eval_e2e_rows_per_sec=float(np.median(rps["library"])),
        rows_per_sec_all=rps["library"], scenes=MUL_EVAL_SCENES, seeds=MUL_EVAL_SEEDS,
        repeats=MUL_EVAL_REPEATS, batch=B, num_points=cfg.num_points,
        vocab_size=cfg.vocab_size, decode_dtype=cfg.eval_decode_dtype, min_iou=EVAL_MIN_IOU,
        phases=phases, grid_launch_ms_per_forward=phases["launch_s"] / phases["forwards"] * 1e3,
        alone_launch_ms={k: v[1:] for k, v in launch_ms.items()},
        alone_forward_ms={k: v[1:] for k, v in forward_ms.items()},
        eval_forward_scenes_per_s=forward_scenes_per_s,
        launches=launches, meteor_is_exact=meteor.is_exact)
    return launches


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


def bn_buffers(model):
    """Copies of every BN's running mean and variance, by buffer name."""
    return {f"{n}.{k}": getattr(m, k).clone() for n, m in model.named_modules()
            if isinstance(m, BatchNorm) for k in ("running_mean", "running_var")}


def phase_train_step():
    """The full-width train step: default ModelConfig, TrainConfig(), B=8,
    ``train_batch`` at 40,000 points (``run_train_steps``)."""
    cfg = ModelConfig()
    return run_train_steps(cfg, train_batch(cfg, B, seed=0), "train_step")


def run_train_steps(cfg, batch, what):
    """``make_train_step`` of ``cfg`` on one ``batch`` (numpy), TrainConfig(),
    seeded weights and a seeded CUDA dropout generator (rate 0.1), captured
    (the default on CUDA: the first step runs eagerly and captures, the
    others replay). The first step is the counted run (every count set to
    0 just before); 3 warm-up steps, then 10 timed, each ending in a
    synchronise, the wrappers counting FPS 2, ball query 5 and the decode
    kernels 0 twice in the capture call and not at all in a replay
    (``wrapper_want``); a profiled replay's kernel spans by name are the
    step's launches. The split into forward, loss, backward and optimizer
    is the eager step's (``phase_captured_train``). Gates: finite losses and
    metrics, every parameter's gradient finite and not zero over the run,
    ``mean_size_arr`` unchanged, every BN's running stats moved, and the
    best loss of the second half below the first step's. Logs ``[what]``
    and returns (launches, {step_ms, peak_mem_gib, device_busy_ms})."""
    tc = TrainConfig()
    batch = to_device_batch(batch, torch.device(DEV))
    model = init_spacap(cfg, seed=0, device=DEV)
    opt, sched = make_optimizer(model, tc, steps_per_epoch=1000)
    step = make_train_step(cfg, tc, opt, device=DEV, scheduler=sched)
    step.program.keep_graphs = True
    gen = torch.Generator(device=DEV).manual_seed(0)
    msa, bn0 = model.mean_size_arr.clone(), bn_buffers(model)
    params = list(model.named_parameters())
    seen = torch.zeros(len(params), device=DEV)     # largest |g| of each leaf over the run
    finite = torch.ones(len(params), dtype=torch.bool, device=DEV)
    losses, times, last = [], [], {}

    def run():
        before = {k: f.launches for k, f in KERNELS.items()}
        metrics = step(model, batch, gen, 0.1)
        torch.cuda.synchronize()
        got = {k: f.launches - before[k] for k, f in KERNELS.items()}
        if got != wrapper_want(step, TRAIN_WANT):
            raise AssertionError(f"train step: the wrappers counted {got}, want "
                                 f"{wrapper_want(step, TRAIN_WANT)}")
        return metrics

    def check(metrics):
        nonlocal seen, finite
        missing = [n for n, p in params if p.grad is None]
        if missing:
            raise AssertionError(f"no gradient: {missing[:5]}")
        norms = torch.stack(torch._foreach_norm([p.grad for _, p in params], float("inf")))
        seen = torch.maximum(seen, torch.nan_to_num(norms, nan=0.0))
        finite &= torch.isfinite(norms)
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"non-finite metrics {bad}")
        losses.append(float(metrics["loss"]))
        last.update({k: float(v) for k, v in metrics.items()})

    for k in KERNELS.values():     # the counted run
        k.launches = 0
    check(run())
    wrapper_launches = {k: f.launches for k, f in KERNELS.items()}
    capture_s = step.program.last["capture_s"]
    for _ in range(TRAIN_WARMUP - 1):
        check(run())
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_TIMED):
        t0 = time.perf_counter()
        metrics = run()
        times.append((time.perf_counter() - t0) * 1e3)
        check(metrics)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # a profiled replay: its kernel spans by name are the step's launches
    prof = device_profile(lambda: check(run()), TRAIN_WANT, program=step.program)
    launches = prof["kernel_spans"]
    med = float(np.median(times))
    if "device_busy_ms" in prof:
        prof["device_busy_share"] = prof["device_busy_ms"] / med
    half = len(losses) // 2
    zero = [n for (n, _), v in zip(params, seen.tolist()) if v == 0.0]
    nonfinite = [n for (n, _), ok in zip(params, finite.tolist()) if not ok]
    bn_still = [n for n, b in bn_buffers(model).items() if torch.equal(b, bn0[n])]
    log(what, batch=B, num_points=cfg.num_points, proposals=cfg.num_proposals,
        input_feature_dim=cfg.input_feature_dim,
        dropout=cfg.transformer_dropout, lr=tc.lr, transformer_lr=tc.transformer_lr, wd=tc.wd,
        launches=launches, wrapper_launches=wrapper_launches, capture_s=capture_s,
        warmup_steps=TRAIN_WARMUP, timed_steps=TRAIN_TIMED,
        step_ms=med, step_ms_all=times, train_scenes_per_s=B / (med / 1e3),
        device_busy_ms=prof.get("device_busy_ms"), device_spans=prof.get("device_spans"),
        device_busy_share=prof.get("device_busy_share"),
        fps_device_ms=prof.get("kernel_device_ms", {}).get("fps"),
        ball_query_device_ms=prof.get("kernel_device_ms", {}).get("ball_query"),
        peak_mem_gib=peak, losses=losses, first_loss=losses[0],
        best_second_half=min(losses[half:]), last_metrics=last, parameters=len(params),
        grads_zero_over_run=zero, grads_nonfinite=nonfinite, bn_buffers=len(bn0),
        bn_buffers_unmoved=bn_still, mean_size_arr_unchanged=bool(torch.equal(
            model.mean_size_arr, msa)))
    log("profile", path=what, **prof)
    if zero or nonfinite:
        raise AssertionError(f"gradients zero over the run {zero[:5]} or non-finite "
                             f"{nonfinite[:5]}")
    if bn_still or not torch.equal(model.mean_size_arr, msa):
        raise AssertionError(f"BN stats that did not move {bn_still[:5]}, or mean_size_arr "
                             f"changed")
    if not min(losses[half:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if launches != TRAIN_WANT:
        raise AssertionError(f"{what}: the replay's kernel spans {launches}, want {TRAIN_WANT}")
    return launches, {"step_ms": med, "peak_mem_gib": peak,
                      "device_busy_ms": prof.get("device_busy_ms")}


def determinism_leg(cfg, tc, batches, momenta):
    """CAPTURED_TRAIN_STEPS steps of the eager and of the captured train
    step, each from seeded weights and a dropout generator seeded alike, on
    ``batches`` at ``momenta``. Returns what the captured run did (its
    calls' capture flags, its rates after each step, whether the
    scheduler filled the rate tensors in place) and what differs from the
    eager run under ``torch.equal``: each step's metrics and dropout masks
    (``recorded_masks``; a capture call's first half are its warm-up's, its
    second the graph's, which the replays rewrite), then the parameters,
    Adam's state, the BN buffers and the caller's generator state; and
    the parameters that got no gradient in the captured run, with those of
    them that moved from their initial values in either run."""
    runs = {}
    for kind in ("eager", "captured"):
        model = init_spacap(cfg, seed=0, device=DEV)
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt, sched = make_optimizer(model, tc, steps_per_epoch=1)
        step = make_train_step(cfg, tc, opt, device=DEV, scheduler=sched,
                               capture=kind == "captured")
        gen = torch.Generator(device=DEV).manual_seed(3)
        rates = [g["lr"] for g in opt.param_groups]
        run = {"metrics": [], "masks": [], "captured": [], "lr": []}
        graph_masks = []
        with recorded_masks() as rec:
            for batch, m in zip(batches, momenta):
                run["metrics"].append(step(model, batch, gen, m))
                new = list(rec)
                if step.program is not None:
                    run["captured"].append(step.program.last["captured"])
                    if run["captured"][-1]:
                        new, graph_masks = new[:len(new) // 2], new[len(new) // 2:]
                    else:
                        new = graph_masks
                run["masks"].append([t.clone() for t in new])
                rec.clear()
                run["lr"].append([float(g["lr"]) for g in opt.param_groups])
        run["no_gradient"] = [n for n, p in model.named_parameters() if p.grad is None]
        run["no_gradient_moved"] = [n for n, p in model.named_parameters()
                                    if p.grad is None and not torch.equal(p, init[n])]
        run.update(model=model, opt=opt, gen_state=gen.get_state(),
                   lr_in_place=all(a is b for a, b in zip(rates, (g["lr"] for g in
                                                                 opt.param_groups))),
                   capture_s=step.program.last["capture_s"] if step.program else None)
        runs[kind] = run
    e, c = runs["eager"], runs["captured"]
    torch.cuda.synchronize()
    return {
        "captured_calls": c["captured"], "capture_s": c["capture_s"],
        "lr": c["lr"], "lr_eager": e["lr"], "lr_tensors_filled_in_place": c["lr_in_place"],
        "masks_per_step": [len(m) for m in e["masks"]],
        "metrics_differ": [differing(a, b) for a, b in zip(c["metrics"], e["metrics"])],
        "masks_differ": [[i for i, (a, b) in enumerate(zip(cm, em)) if not torch.equal(a, b)]
                         + ([] if len(cm) == len(em) else ["count"])
                         for cm, em in zip(c["masks"], e["masks"])],
        "parameters_differ": differing(dict(c["model"].named_parameters()),
                                       dict(e["model"].named_parameters())),
        "adam_state_differ": differing(adam_state(c["opt"]), adam_state(e["opt"])),
        "adam_state_tensors": len(adam_state(c["opt"])),
        "bn_buffers_differ": differing(bn_buffers(c["model"]), bn_buffers(e["model"])),
        "generator_state_equal": bool(torch.equal(c["gen_state"], e["gen_state"])),
        "no_gradient": c["no_gradient"], "no_gradient_eager": e["no_gradient"],
        "no_gradient_moved": c["no_gradient_moved"],
        "no_gradient_moved_eager": e["no_gradient_moved"],
    }


def generator_probe(seeds=(1, 2, 3), n=1 << 20):
    """A graph that draws two masks from a registered generator, replayed
    once a seed after that generator took the state of a caller's generator
    (seeded, then advanced by a draw of 7): per seed, whether the replay's
    masks equal those drawn eagerly from the same state, and whether the
    caller's state after the replay (written back) equals the eager
    generator's."""
    own = torch.Generator(device=DEV)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(own)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        drawn = [torch.empty(n, device=DEV).bernoulli_(0.9, generator=own) for _ in range(2)]
    out = []
    for seed in seeds:
        caller = torch.Generator(device=DEV).manual_seed(seed)
        torch.empty(7, device=DEV).bernoulli_(0.5, generator=caller)
        ref = torch.Generator(device=DEV)
        ref.set_state(caller.get_state())
        want = [torch.empty(n, device=DEV).bernoulli_(0.9, generator=ref) for _ in range(2)]
        own.set_state(caller.get_state())
        graph.replay()
        caller.set_state(own.get_state())
        out.append({"seed": seed, "masks_equal": all(torch.equal(a, b) for a, b in
                                                     zip(drawn, want)),
                    "state_equal": bool(torch.equal(caller.get_state(), ref.get_state()))})
    return out


def train_determinism_worker():
    """``chip_smoke.py --train-determinism``: the captured train step
    against the eager one under ``torch.use_deterministic_algorithms``
    (this process's ``CUBLAS_WORKSPACE_CONFIG`` set by its parent before
    cuBLAS starts), at full width (default ModelConfig, TrainConfig(), B =
    8, ``train_batch`` at 40,000 points), four legs: dropout 0, dropout 0.1
    (masks compared), detection pretraining (``no_caption``) at
    CAPTURED_TRAIN_MOMENTA with its rate decayed at updates 1 and 2, and
    the relation head out of the loss (``use_relation=False``: its
    parameters get no gradient, and Adam must leave them as they were in
    both steps); and ``generator_probe``. Prints ``TRAIN_DETERMINISM`` and one JSON object:
    each leg's ``determinism_leg``, the probe, the warnings of operations
    without a deterministic implementation, and ``failures``."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig()
    batches = [to_device_batch(train_batch(cfg, B, seed=s), torch.device(DEV))
               for s in range(CAPTURED_TRAIN_STEPS)]
    legs = {
        "dropout_0": (dataclasses.replace(cfg, transformer_dropout=0.0), TrainConfig(),
                      (0.1,) * CAPTURED_TRAIN_STEPS),
        "dropout_0.1": (dataclasses.replace(cfg, transformer_dropout=0.1), TrainConfig(),
                        (0.1,) * CAPTURED_TRAIN_STEPS),
        "pretraining": (dataclasses.replace(cfg, no_caption=True, check_relation=False),
                        TrainConfig(no_caption=True, use_relation=False, lr_decay_step=(1, 2)),
                        CAPTURED_TRAIN_MOMENTA),
        # the relation head built but out of the loss: its parameters get no
        # gradient (ROADMAP Queue 3, "Adam and parameters without a gradient")
        "relation_head_without_loss": (cfg, TrainConfig(use_relation=False),
                                       (0.1,) * CAPTURED_TRAIN_STEPS),
    }
    out, failures = {}, []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, (leg_cfg, tc, momenta) in legs.items():
            t0 = time.perf_counter()
            try:
                res = determinism_leg(leg_cfg, tc, batches, momenta)
            except Exception as e:      # a capture or replay that fails
                res = {"error": f"{type(e).__name__}: {e}"[:2000]}
                failures.append(f"{name}: {res['error'][:300]}")
            res["wall_s"] = time.perf_counter() - t0
            out[name] = res
            if "error" in res:
                continue
            differ = {k: res[k] for k in ("metrics_differ", "masks_differ", "parameters_differ",
                                          "adam_state_differ", "bn_buffers_differ")
                      if any(res[k])}
            if differ or not res["generator_state_equal"]:
                failures.append(f"{name}: replays differ from eager steps: {differ}, generator "
                                f"state equal {res['generator_state_equal']}")
            if (res["no_gradient"] != res["no_gradient_eager"] or res["no_gradient_moved"]
                    or res["no_gradient_moved_eager"]
                    or bool(res["no_gradient"]) != (name == "relation_head_without_loss")):
                failures.append(f"{name}: parameters without a gradient {res['no_gradient']}, "
                                f"moved {res['no_gradient_moved']}, eager "
                                f"{res['no_gradient_moved_eager']}")
            if res["captured_calls"] != [True] + [False] * (CAPTURED_TRAIN_STEPS - 1):
                failures.append(f"{name}: captured calls {res['captured_calls']}")
            dropped = leg_cfg.transformer_dropout > 0 and not leg_cfg.no_caption
            if not (all(res["masks_per_step"]) if dropped else not any(res["masks_per_step"])):
                failures.append(f"{name}: masks a step {res['masks_per_step']}")
            # the rate decays after updates 1 and 2: the replays run at the
            # rates the scheduler filled in
            if name == "pretraining" and (res["lr"] != res["lr_eager"]
                                          or not res["lr_tensors_filled_in_place"]
                                          or not res["lr"][1][0] < res["lr"][0][0] < tc.lr):
                failures.append(f"pretraining: rates {res['lr']} against {res['lr_eager']}, "
                                f"filled in place {res['lr_tensors_filled_in_place']}")
        out["generator_probe"] = generator_probe()
    if not all(r["masks_equal"] and r["state_equal"] for r in out["generator_probe"]):
        failures.append(f"generator probe: {out['generator_probe']}")
    out["nondeterministic_ops"] = sorted({str(w.message)[:200] for w in caught
                                          if "deterministic" in str(w.message)})
    out["failures"] = failures
    print("TRAIN_DETERMINISM " + json.dumps(out), flush=True)


def phase_captured_train():
    """The captured train step (``make_train_step``'s default on CUDA)
    against the eager one (``capture=False``) at full width: default
    ModelConfig, TrainConfig(), B = 8, ``train_batch`` at 40,000 points,
    dropout 0.1, seeded weights and generators. First the deterministic
    legs in a process of their own (``train_determinism_worker``): the
    replays bit-equal to eager steps (metrics, dropout masks, parameters,
    Adam's state, BN buffers, the caller's generator state), the momentum
    and a scheduler milestone reaching the replays. Then here: the
    wrappers count a step's launches twice in the capture call and not at
    all in a replay; a profiled replay's kernel spans are FPS 2, ball query
    5, decode kernels 0; the captured and the eager step timed in turns,
    TRAIN_TIMED each after TRAIN_WARMUP (step ms, train scenes/s, the
    eager step's split from its CUDA events), each profiled (device busy ms
    and share, spans a step), their peak memory and the capture's seconds;
    last, an in-place update of the weights replays, and a loaded optimizer
    state and a replaced parameter each capture anew. Returns the captured
    and eager summaries."""
    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=CUBLAS_DETERMINISTIC)
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"),
                           "--train-determinism"], capture_output=True, text=True, env=env,
                          cwd=here, timeout=900)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("TRAIN_DETERMINISM ")),
                None)
    if proc.returncode != 0 or line is None:
        raise AssertionError(f"captured_train: the deterministic process exited "
                             f"{proc.returncode}: {proc.stderr[-4000:]}")
    det = json.loads(line[len("TRAIN_DETERMINISM "):])
    log("captured_train", determinism=det, determinism_process_s=time.perf_counter() - t0)
    if det["failures"]:
        raise AssertionError(f"captured_train: {det['failures']}")

    cfg, tc = ModelConfig(), TrainConfig()
    batch = to_device_batch(train_batch(cfg, B, seed=0), torch.device(DEV))
    legs = {}
    for kind in ("captured", "eager"):
        model = init_spacap(cfg, seed=0, device=DEV)
        opt, sched = make_optimizer(model, tc, steps_per_epoch=1000)
        step = make_train_step(cfg, tc, opt, device=DEV, scheduler=sched,
                               capture=kind == "captured")
        if step.program is not None:
            step.program.keep_graphs = True
        legs[kind] = {"model": model, "opt": opt, "step": step, "times": [],
                      "gen": torch.Generator(device=DEV).manual_seed(0)}

    def run(kind, marks=None):
        leg = legs[kind]
        before = {k: f.launches for k, f in KERNELS.items()}
        t0 = time.perf_counter()
        metrics = leg["step"](leg["model"], batch, leg["gen"], 0.1, marks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = {k: f.launches - before[k] for k, f in KERNELS.items()}
        if got != wrapper_want(leg["step"], TRAIN_WANT):
            raise AssertionError(f"captured_train {kind}: the wrappers counted {got}, want "
                                 f"{wrapper_want(leg['step'], TRAIN_WANT)}")
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"captured_train {kind}: non-finite metrics")
        return wall

    program = legs["captured"]["step"].program
    res = {"capture_call_ms": run("captured"), "capture_s": program.last["capture_s"]}
    if not program.last["captured"]:
        raise AssertionError("captured_train: the first call did not capture")
    res["graph_nodes"] = [cuda_graph_nodes(g) for g in last_key_graphs(program)]
    memory = {}
    for kind in ("captured", "eager"):
        for _ in range(TRAIN_WARMUP):
            run(kind)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run(kind)
        memory[kind] = {"peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30}
    splits = {"forward": [], "loss": [], "backward": [], "optimizer": []}
    for turn in range(TRAIN_TIMED):
        for kind in (("captured", "eager") if turn % 2 == 0 else ("eager", "captured")):
            marks = [] if kind == "eager" else None
            legs[kind]["times"].append(run(kind, marks))
            if marks is not None:
                for j, name in enumerate(splits):
                    splits[name].append(marks[j].elapsed_time(marks[j + 1]))
    summary = {}
    for kind in ("captured", "eager"):
        prof = device_profile(lambda kind=kind: run(kind), TRAIN_WANT,
                              program=legs[kind]["step"].program)
        med = float(np.median(legs[kind]["times"]))
        summary[kind] = {
            "step_ms": med, "step_ms_all": legs[kind]["times"],
            "train_scenes_per_s": B / (med / 1e3), "launches": prof["kernel_spans"],
            "device_busy_ms": prof.get("device_busy_ms"), "device_spans": prof.get("device_spans"),
            "device_busy_share": (prof["device_busy_ms"] / med if "device_busy_ms" in prof
                                  else None),
            "profile_check": prof.get("check"), "graph_spans": prof.get("graph_spans"),
            "graph_nodes_replayed": prof.get("graph_nodes"),
            "top_device_ms": prof.get("top_device_ms"), **memory[kind]}
        if prof["kernel_spans"] != TRAIN_WANT:
            raise AssertionError(f"captured_train {kind}: the profiled step's kernel spans "
                                 f"{prof['kernel_spans']}, want {TRAIN_WANT}")
    summary["eager"]["split_ms"] = {k: float(np.median(v)) for k, v in splits.items()}

    model, opt, step = (legs["captured"][k] for k in ("model", "opt", "step"))
    with torch.no_grad():
        for prm in model.parameters():
            prm.mul_(1.001)
    run("captured")
    res["in_place_update_recaptured"] = program.last["captured"]
    load_optimizer_state(opt, copy.deepcopy(opt.state_dict()))
    run("captured")
    res["loaded_state_recaptured"] = program.last["captured"]
    res["graph_sets_after_load"] = len(program.entries)
    head = model.proposal.proposal[6]
    head.bias = torch.nn.Parameter(head.bias.detach().clone())
    run("captured")
    res["replaced_parameter_recaptured"] = program.last["captured"]
    res["graph_sets_after_replace"] = len(program.entries)
    run("captured")
    res["replayed_after_replace"] = not program.last["captured"]
    log("captured_train", **res, **{f"{k}_leg": v for k, v in summary.items()},
        captured_over_eager_step_ms=summary["captured"]["step_ms"] / summary["eager"]["step_ms"])
    if (res["in_place_update_recaptured"] or not res["loaded_state_recaptured"]
            or not res["replaced_parameter_recaptured"] or not res["replayed_after_replace"]
            or res["graph_sets_after_load"] != 1 or res["graph_sets_after_replace"] != 1):
        raise AssertionError(f"captured_train: keys {res}")
    del legs
    torch.cuda.empty_cache()
    return summary


def train_once(model, cfg, tc, batch, pin=None):
    """One ``make_train_step`` step of ``model`` on ``batch`` -> (metrics,
    gradients on the CPU). With ``pin`` (argmax indices by POOLS name), each
    neighbour max-pool takes the neighbour ``pin`` names instead of its own
    maximum."""
    dev = next(model.parameters()).device
    hooks = pin_pools(model, pin) if pin is not None else []
    opt, _ = make_optimizer(model, tc, steps_per_epoch=1)
    # eager: the pins are uploaded inside the forward's hooks, which a
    # capture cannot hold
    metrics = make_train_step(cfg, tc, opt, device=dev, capture=False)(model, batch)
    for h in hooks:
        h.remove()
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()})


def pin_pools(model, pin):
    """Forward hooks that make each POOLS max-pool take the neighbours
    ``pin`` names; returns the hooks."""
    return [model.get_submodule(path).register_forward_hook(
        lambda m, i, o, k=k: o.gather(2, pin[k].to(o.device)[:, :, None, :]))
        for k, path in POOLS.items()]


@contextlib.contextmanager
def index_tape(tape, replay):
    """Within: FPS and ball query append their index outputs to ``tape``
    (``replay`` False), or return ``tape``'s in call order, whatever the
    input dtype (``replay`` True)."""
    names = ("furthest_point_sample", "ball_query")
    saved = {n: getattr(ops, n) for n in names}
    played = iter(tape)

    def taped(fn):
        def call(*args, **kw):
            if replay:
                return next(played)
            tape.append(fn(*args, **kw))
            return tape[-1]
        return call

    for n in names:
        setattr(ops, n, taped(saved[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(ops, n, saved[n])


def train_f64(model, cfg, tc, batch, pin, tape):
    """The f64 reference of a pinned step on the CPU -> gradients: the
    train forward, ``get_scene_cap_loss`` and the backward of
    ``make_train_step``, taken outside it because the step casts its batch
    to f32, with the FPS and ball-query indices of the CPU's f32 step
    replayed from ``tape``."""
    model = model.double().train()
    hooks = pin_pools(model, pin)
    dev_batch = {k: torch.as_tensor(batch[k]) for k in TRAIN_KEYS}
    dev_batch = {k: v.double() if v.is_floating_point() else v for k, v in dev_batch.items()}
    with index_tape(tape, replay=True):
        ep = model.train_forward(dev_batch, None, 0.1)
    ep = get_scene_cap_loss(
        ep, model.mean_size_arr, cfg.num_heading_bin, cfg.num_size_cluster,
        detection=not tc.no_detection, caption=not tc.no_caption,
        use_relation=tc.use_relation and cfg.check_relation)
    ep["loss"].backward()
    for h in hooks:
        h.remove()
    return {n: p.grad for n, p in model.named_parameters()}


def leaf_shares(grads, ref):
    """Each leaf's largest difference from ``ref`` as a share of the ref
    leaf's largest entry, floored at TRAIN_GRAD_FLOOR of the largest entry
    of all ref leaves."""
    top = max(float(v.abs().max()) for v in ref.values())
    return {n: float((grads[n].double() - v.double()).abs().max())
            / max(float(v.abs().max()), TRAIN_GRAD_FLOOR * top) for n, v in ref.items()}


def phase_cpu_vs_gpu_train():
    """One train step on the CPU and on the card from the same weights and
    batch at the reduced size, dropout 0: equal SA1 and aggregation FPS
    and ball-query indices; the step taken free (the losses within
    TRAIN_LOSS_TOL and TRAIN_LOSS_ATOL, the gradient leaves' shares within
    TRAIN_GRAD_MEDIAN, median, and TRAIN_GRAD_SHARE, largest; the
    neighbour max-pools' argmax flips logged) and pinned, POOLS taking the
    CPU's argmax (the losses as before, each GPU leaf within
    TRAIN_F64_FACTOR times the CPU leaf's share of the f64 reference's
    plus TRAIN_F64_ATOL)."""
    cfg = dataclasses.replace(ModelConfig(), num_points=8192, num_proposals=64,
                              transformer_dropout=0.0)
    tc = TrainConfig()
    batch = train_batch(cfg, 2, seed=1)
    init = init_spacap(cfg, seed=1, device="cpu")
    out = {}
    for dev in ("cpu", DEV):
        model = copy.deepcopy(init).to(dev)
        dev_batch = to_device_batch(batch, torch.device(dev))
        pooled = {}
        hooks = [model.get_submodule(path).register_forward_hook(
            lambda m, i, o, k=k: pooled.__setitem__(k, o.argmax(2).cpu()))
            for k, path in POOLS.items()]
        with torch.no_grad():
            ep = model.train().train_forward(dev_batch)
        for h in hooks:
            h.remove()
        xyz = dev_batch["point_clouds"][..., :3].contiguous()
        idx = {"sa1_fps": ep["sa1_inds"], "aggregation_fps": ep["aggregated_vote_inds"],
               "sa1_ball_query": ops.ball_query(xyz, ep["sa1_xyz"], cfg.sa_radii[0],
                                                cfg.sa_nsamples[0]),
               "aggregation_ball_query": ops.ball_query(
                   ep["vote_xyz"].contiguous(), ep["aggregated_vote_xyz"], cfg.agg_radius,
                   cfg.agg_nsample)}
        out[dev] = {"idx": {k: v.cpu() for k, v in idx.items()}, "pooled": pooled,
                    "free": train_once(copy.deepcopy(init).to(dev), cfg, tc, batch)}
    pin, tape = out["cpu"]["pooled"], []
    with index_tape(tape, replay=False):
        out["cpu"]["pinned"] = train_once(copy.deepcopy(init), cfg, tc, batch, pin)
    out[DEV]["pinned"] = train_once(copy.deepcopy(init).to(DEV), cfg, tc, batch, pin)
    ref = train_f64(copy.deepcopy(init), cfg, tc, batch, pin, tape)
    c, g = out["cpu"], out[DEV]
    equal = {k: bool(torch.equal(c["idx"][k], g["idx"][k])) for k in c["idx"]}
    flips = {k: int((c["pooled"][k] != g["pooled"][k]).sum()) for k in POOLS}
    res, failed = {}, []
    for run in ("free", "pinned"):
        loss_over = {k: abs(g[run][0][k] - v) / (TRAIN_LOSS_TOL * abs(v) + TRAIN_LOSS_ATOL)
                     for k, v in c[run][0].items() if k.endswith("loss")}
        share = leaf_shares(g[run][1], c[run][1])
        worst = sorted(share.items(), key=lambda kv: -kv[1])[:5]
        median = float(np.median(list(share.values())))
        res[run] = {"loss_cpu": c[run][0], "loss_gpu": g[run][0],
                    "max_loss_err_over_tol": max(loss_over.values()),
                    "grad_share_worst": worst, "grad_share_median": median,
                    "leaves_above_1e3": sum(v > 1e-3 for v in share.values())}
        if max(loss_over.values()) > 1.0:
            failed.append(f"{run}: losses beyond {TRAIN_LOSS_TOL} relative + "
                          f"{TRAIN_LOSS_ATOL}: {loss_over}")
    if res["free"]["grad_share_median"] > TRAIN_GRAD_MEDIAN or (
            res["free"]["grad_share_worst"][0][1] > TRAIN_GRAD_SHARE):
        failed.append(f"free: gradients beyond {TRAIN_GRAD_MEDIAN} (median share of a leaf's "
                      f"largest entry) or {TRAIN_GRAD_SHARE} (largest): {res['free']}")
    e_cpu, e_gpu = leaf_shares(c["pinned"][1], ref), leaf_shares(g["pinned"][1], ref)
    over = {n: e_gpu[n] / (TRAIN_F64_FACTOR * e_cpu[n] + TRAIN_F64_ATOL) for n in ref}
    res["pinned"].update({
        "cpu_f64_share_worst": sorted(e_cpu.items(), key=lambda kv: -kv[1])[:5],
        "gpu_f64_share_worst": sorted(e_gpu.items(), key=lambda kv: -kv[1])[:5],
        "cpu_f64_share_median": float(np.median(list(e_cpu.values()))),
        "gpu_f64_share_median": float(np.median(list(e_gpu.values()))),
        "gpu_over_limit_worst": [(n, v, e_gpu[n], e_cpu[n]) for n, v in
                                 sorted(over.items(), key=lambda kv: -kv[1])[:5]]})
    if max(over.values()) > 1.0:
        failed.append(f"pinned: GPU leaves beyond {TRAIN_F64_FACTOR} x the CPU's share of the "
                      f"f64 reference + {TRAIN_F64_ATOL}: {res['pinned']['gpu_over_limit_worst']}")
    log("cpu_vs_gpu_train", batch=2, num_points=cfg.num_points, proposals=cfg.num_proposals,
        indices_equal=equal, maxpool_argmax_flips=flips,
        maxpool_outputs={k: v.numel() for k, v in c["pooled"].items()},
        grad_leaves=len(ref), loss_tol=TRAIN_LOSS_TOL, loss_atol=TRAIN_LOSS_ATOL,
        grad_median_tol=TRAIN_GRAD_MEDIAN, grad_share_tol=TRAIN_GRAD_SHARE,
        grad_floor=TRAIN_GRAD_FLOOR, f64_factor=TRAIN_F64_FACTOR, f64_atol=TRAIN_F64_ATOL,
        **res)
    if not all(equal.values()):
        raise AssertionError(f"CPU and GPU train-forward indices differ: {equal}")
    if failed:
        raise AssertionError("CPU and GPU train steps differ: " + "; ".join(failed))


def mv_intrinsic():
    """The frames' pinhole intrinsic at MV_H x MV_W (4 x 4, as ScanNet's
    ``intrinsic.txt``)."""
    k = np.eye(4)
    k[0, 0] = k[1, 1] = MV_FOCAL
    k[0, 2], k[1, 2] = (MV_W - 1) / 2, (MV_H - 1) / 2
    return k


def mv_poses():
    """MV_FRAMES_PER_SCENE camera-to-world poses: a 4 x 2 grid over the 6 x 6
    m room, MV_CAMERA_Z above the floor, looking straight down."""
    poses = []
    for cy in (1.5, 4.5):
        for cx in (0.75, 2.25, 3.75, 5.25):
            pose = np.eye(4)
            pose[:3, :3] = np.diag([1.0, -1.0, -1.0])
            pose[:3, 3] = [cx, cy, MV_CAMERA_Z]
            poses.append(pose)
    return poses


def mv_depth(helper, xyz, pose):
    """A depth map at the helper's (feature-map) grid rendered from the
    scene's own points: the nearest point each pixel, 0 where none lands
    (the projection's arithmetic, ``ProjectionHelper.project_points``)."""
    w, h = helper.image_dims
    cam = (np.concatenate([xyz, np.ones((len(xyz), 1))], 1) @ np.linalg.inv(pose).T)[:, :3]
    z = cam[:, 2]
    px = np.round(cam[:, 0] / z * helper.intrinsic[0, 0] + helper.intrinsic[0, 2])
    py = np.round(cam[:, 1] / z * helper.intrinsic[1, 1] + helper.intrinsic[1, 2])
    ok = (z > 0) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    depth = np.full((h, w), np.inf)
    np.minimum.at(depth, (py[ok].astype(np.int64), px[ok].astype(np.int64)), z[ok])
    depth[np.isinf(depth)] = 0.0
    return depth


def mv_helper():
    return make_map_projection_helper(mv_intrinsic(), (MV_H, MV_W), (MV_W // 8, MV_H // 8),
                                      MV_DEPTH_MIN, MV_DEPTH_MAX)


def mv_project(xyz, feats):
    """ENet maps (MV_FRAMES_PER_SCENE, H/8, W/8, 128) of one scene onto its
    points (``aggregate_frames_maxpool``) -> ((N, 128) float32, the share of
    points some frame saw)."""
    helper = mv_helper()
    frames = [{"features": f, "depth": mv_depth(helper, xyz, pose), "pose": pose}
              for f, pose in zip(feats, mv_poses())]
    seen = np.zeros(len(xyz), bool)
    for fr in frames:
        seen |= helper.project_points(xyz, fr["depth"], fr["pose"])[0]
    return aggregate_frames_maxpool(xyz, frames, helper), float(seen.mean())


def multiview_clouds(batch, mv):
    """``train_batch``'s (B, N, xyz + height) clouds -> the multiview+normal
    input (B, N, 3 + 132): xyz, normals (the synthetic scenes' floor normal,
    0 0 1, as ``data/synthetic.py`` writes them), the projected features,
    height; the dataset's order."""
    pc = batch["point_clouds"]
    normals = np.broadcast_to(np.array([0, 0, 1], np.float32), pc.shape[:2] + (3,))
    return np.concatenate([pc[..., :3], normals, mv, pc[..., 3:]], -1).astype(np.float32)


def mv_enet(imgs):
    """ENet at MV_FRAMES x MV_H x MV_W on the card (seeded weights, eval): the
    first MV_CPU_FRAMES frames' features and logits against the CPU's, device
    ms a batch, busy ms, peak memory -> (features NHWC numpy, summary)."""
    model = init_enet(seed=0, device=DEV)
    x = torch.from_numpy(imgs).to(DEV).permute(0, 3, 1, 2)       # as the feature CLI
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        feats, logits = model(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        cpu_feats, cpu_logits = init_enet(seed=0, device="cpu")(
            torch.from_numpy(imgs[:MV_CPU_FRAMES]).permute(0, 3, 1, 2))
        err = {}
        for name, got, want in (("features", feats, cpu_feats), ("logits", logits, cpu_logits)):
            got = got[:MV_CPU_FRAMES].cpu()
            err[name] = float((got - want).abs().max() / want.abs().max())
        ms = cuda_ms(lambda: model.encode(x), reps=1, runs=MV_ENET_RUNS, warmup=3)
        prof = device_profile(lambda: (model.encode(x), torch.cuda.synchronize()),
                              {k: 0 for k in PROFILED})
    summary = {"frames": MV_FRAMES, "height": MV_H, "width": MV_W,
               "feature_map": list(feats.shape), "logits": list(logits.shape),
               "rel_err_vs_cpu": err, "tolerance": MV_ENET_REL, "ms_per_batch": ms,
               "frames_per_s": MV_FRAMES / (ms / 1e3),
               "device_busy_ms": prof.get("device_busy_ms"),
               "device_spans": prof.get("device_spans"), "peak_mem_gib": peak,
               "top_device_ms": prof.get("top_device_ms", [])[:6]}
    log("multiview", enet=summary)
    if max(err.values()) > MV_ENET_REL or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"ENet on the card against the CPU: {err}")
    return feats.permute(0, 2, 3, 1).contiguous().cpu().numpy(), summary


def mv_packages():
    """Which of the CLIs' host packages import on this machine."""
    import importlib

    have = {}
    for name in ("PIL", "h5py", "matplotlib"):
        try:
            importlib.import_module(name)
            have[name] = True
        except ImportError:
            have[name] = False
    return have


def mv_write_frames(frames_root, scene_dir, sid, rng):
    """One scene's frames as ScanNet lays them out: colour jpg (seeded
    noise), 16-bit depth png in mm at MV_H x MV_W (rendered at the feature
    grid from the scene's points, each cell repeated 8 x 8, so that the
    CLI's resample to the grid reads it back), pose txt, intrinsic.txt."""
    from PIL import Image

    xyz = np.load(os.path.join(scene_dir, f"{sid}_aligned_vert.npy"))[:, :3]
    d = os.path.join(frames_root, sid)
    for sub in ("color", "depth", "pose"):
        os.makedirs(os.path.join(d, sub))
    np.savetxt(os.path.join(d, "intrinsic.txt"), mv_intrinsic())
    helper = mv_helper()
    for i, pose in enumerate(mv_poses()):
        Image.fromarray((rng.rand(MV_H, MV_W, 3) * 255).astype(np.uint8)).save(
            os.path.join(d, "color", f"{i}.jpg"))
        depth = np.repeat(np.repeat(mv_depth(helper, xyz, pose), 8, 0), 8, 1)
        Image.fromarray(np.round(depth * 1000).astype(np.uint16)).save(
            os.path.join(d, "depth", f"{i}.png"))
        np.savetxt(os.path.join(d, "pose", f"{i}.txt"), pose)


def mv_clis():
    """The multiview CLIs on the card on what a user would give them:
    MV_CLI_SCENES synthetic scenes of MUL_EVAL_SCENE (the last one val)
    written to a temporary directory, with their frames
    (``mv_write_frames``). ``compute_multiview_features --device cuda`` and
    ``project_multiview_labels --maxpool --device cuda`` (PIL); the
    features projected onto each scene's points by the projection CLI's own
    ``project_scene``; where h5py imports, ``project_multiview_features``
    into the data root's ``enet_feats_maxpool.hdf5`` and one ``train
    --arch_preset full --epoch 1 --use_multiview --use_normal`` epoch on it,
    with FPS 2, ball query 5, decode 0 in every train step and validation
    forward. Gates on their files. A CLI whose package is missing is logged
    as NOT RUN. Returns the counts from just before the first CLI to just
    after the last."""
    have = mv_packages()
    log("multiview", packages=have)
    if not have["PIL"]:
        log("multiview", cli="NOT RUN: every multiview CLI reads images with PIL")
        return None
    with tempfile.TemporaryDirectory(prefix="multiview_") as root, CliCalls() as calls, \
            SnapshotCheck() as snap:
        t0 = time.perf_counter()
        anns, sids = write_synthetic_dataset(root, num_scenes=MV_CLI_SCENES, seed=2,
                                             anns_per_object=1, **MUL_EVAL_SCENE)
        scene_dir = os.path.join(root, "scannet", "scannet_data")
        train_anns = [a for a in anns if a["scene_id"] in set(sids[:-1])]
        for split, split_anns in (("train", train_anns),
                                  ("val", [a for a in anns if a["scene_id"] == sids[-1]])):
            with open(os.path.join(root, f"ScanRefer_filtered_{split}.json"), "w") as f:
                json.dump(split_anns, f)
        padded_vocabulary(train_anns).save(os.path.join(root, "ScanRefer_vocabulary.json"))
        frames_root, feats_root = os.path.join(root, "frames"), os.path.join(root, "enet")
        rng = np.random.RandomState(3)
        for sid in sids:
            mv_write_frames(frames_root, scene_dir, sid, rng)
        points = {sid: np.load(os.path.join(scene_dir, f"{sid}_aligned_vert.npy"))[:, :3]
                  for sid in sids}
        write_s = time.perf_counter() - t0

        for k in KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        mv_features_cli.main(["--frames_root", frames_root, "--out_root", feats_root,
                              "--device", DEV])
        features_s = time.perf_counter() - t0
        shapes = {np.load(os.path.join(feats_root, sid, f)).shape
                  for sid in sids for f in os.listdir(os.path.join(feats_root, sid))}
        seen = {}
        for sid in sids:
            agg, _ = mv_project_cli.project_scene(
                points[sid], os.path.join(frames_root, sid), os.path.join(feats_root, sid),
                MV_DEPTH_MIN, MV_DEPTH_MAX)
            if agg.shape != (len(points[sid]), 128) or not np.isfinite(agg).all():
                raise AssertionError(f"{sid}: projected features {agg.shape}")
            seen[sid] = float((agg != 0).any(1).mean())
        labels_root = os.path.join(root, "labels")
        t0 = time.perf_counter()
        mv_labels_cli.main(["--scene_dir", scene_dir, "--frames_root", frames_root,
                            "--out_root", labels_root, "--maxpool", "--device", DEV])
        labels_s = time.perf_counter() - t0
        plys = {}
        for sid in sids:
            with open(os.path.join(labels_root, f"{sid}.ply")) as f:
                plys[sid] = int(f.read(60).split("element vertex ")[1].split()[0])
        log("multiview", cli_files={"scenes": MV_CLI_SCENES, "frames_per_scene":
                                    MV_FRAMES_PER_SCENE, "feature_shapes": sorted(shapes),
                                    "share_seen": seen, "label_ply_vertices": plys},
            write_s=write_s, features_s=features_s, labels_s=labels_s)
        if (shapes != {(MV_H // 8, MV_W // 8, 128)} or min(seen.values()) < MV_SEEN_MIN
                or any(plys[sid] != len(points[sid]) for sid in sids)):
            raise AssertionError(f"multiview CLI files: {shapes}, seen {seen}, plys {plys}")
        if not have["h5py"]:
            log("multiview", cli="NOT RUN: project_multiview_features and train "
                "--use_multiview read and write HDF5 with h5py, which does not import here")
            return {k: f.launches for k, f in KERNELS.items()}

        h5 = os.path.join(scene_dir, "enet_feats_maxpool.hdf5")
        mv_project_cli.main(["--scene_dir", scene_dir, "--frames_root", frames_root,
                             "--features_root", feats_root, "--out", h5])
        steps_per_epoch = len(train_anns) // B
        solver, steps = train_cli_run(
            calls, snap, ["--data_root", root, "--output_dir", os.path.join(root, "outputs"),
                          "--arch_preset", "full", "--batch_size", str(B), "--epoch", "1",
                          "--use_multiview", "--use_normal", "--val_step",
                          str(steps_per_epoch - 1), "--verbose", "2", "--num_workers", "8",
                          "--seed", "0", "--device", DEV, "--tag", "multiview"],
            "multiview_train")
        launches = {k: f.launches for k, f in KERNELS.items()}
        dim = solver.mc.input_feature_dim
        if dim != 132 or len(steps) != steps_per_epoch or not solver.timing["val"]:
            raise AssertionError(f"multiview train CLI: input_feature_dim {dim}, "
                                 f"{len(steps)} steps, {len(solver.timing['val'])} validations")
        log("multiview", cli_launches=launches, train_steps=len(steps),
            input_feature_dim=dim)
    return launches


def phase_multiview(default_forward_scenes_per_s, default_train):
    """The multiview path at full width. ENet over MV_FRAMES frames of MV_H x
    MV_W (``mv_enet``); its features projected onto the B scenes of
    ``train_batch`` (40,000 points; MV_FRAMES_PER_SCENE frames a scene,
    depth rendered from the scene's points, ``mv_project``); then the
    multiview+normal configuration (``DataConfig(use_multiview=True,
    use_normal=True)``, input_feature_dim 132, the default ModelConfig
    otherwise) on those clouds: the eval forward (counted run: FPS 2, ball
    query 5, decode 0; tokens in range, floats finite; MV_FORWARDS timed in
    turns with the default input's forward on the same scenes, both
    profiled) and the train step (``run_train_steps``), beside the default
    configuration's from the train-step phase; then the CLIs
    (``mv_clis``). Every count is set to 0 just before each counted run and
    read just after. Returns the launches by run."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(0)
    imgs = rng.rand(MV_FRAMES, MV_H, MV_W, 3).astype(np.float32)
    feats, enet = mv_enet(imgs)

    dim = DataConfig(use_multiview=True, use_normal=True).input_feature_dim
    cfg = dataclasses.replace(ModelConfig(), input_feature_dim=dim)
    batch = train_batch(cfg, B, seed=0)
    t0 = time.perf_counter()
    per_scene = [mv_project(batch["point_clouds"][b, :, :3].astype(np.float64),
                            feats[b * MV_FRAMES_PER_SCENE:(b + 1) * MV_FRAMES_PER_SCENE])
                 for b in range(B)]
    project_s = time.perf_counter() - t0
    mv = np.stack([p[0] for p in per_scene])
    seen = [p[1] for p in per_scene]
    plain_clouds = batch["point_clouds"]
    batch["point_clouds"] = multiview_clouds(batch, mv)
    log("multiview", projected_scenes=B, points=cfg.num_points, share_seen=seen,
        host_project_s=project_s, cloud_shape=list(batch["point_clouds"].shape))
    if min(seen) < MV_SEEN_MIN or not np.isfinite(mv).all():
        raise AssertionError(f"projection: share of points seen {seen}")

    # the same scenes through the default input (xyz + height) and through
    # the multiview one, timed in turns
    want = {"fps": 2, "ball_query": 5, "generator_argmax": 0, "ffn": 0, "ffn_partial": 0}
    paths = {}
    for name, c, pc in (("multiview", cfg, batch["point_clouds"]),
                        ("default", ModelConfig(), plain_clouds)):
        paths[name] = {"cfg": c, "model": init_spacap(c, seed=0, device=DEV),
                       "step": make_eval_step(c, device=DEV),
                       "batch": {"point_clouds": pc, "center_label": batch["center_label"]}}
        paths[name]["step"].program.keep_graphs = True    # for the profiles' node counts

    def forward(name):
        p = paths[name]
        before = {k: f.launches for k, f in KERNELS.items()}
        out = p["step"](p["model"], p["batch"])
        torch.cuda.synchronize()
        got = {k: f.launches - before[k] for k, f in KERNELS.items()}
        if got != wrapper_want(p["step"], want):
            raise AssertionError(f"{name} forward: the wrappers counted {got}, want "
                                 f"{wrapper_want(p['step'], want)}")
        return out

    for k in KERNELS.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = forward("multiview")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"eval_forward": {k: f.launches for k, f in KERNELS.items()}}
    shapes = check_outputs(cfg, out)
    times = {name: [] for name in paths}
    for name in ["multiview", "default", "default", "multiview"] * (MV_FORWARDS // 2):
        t0 = time.perf_counter()
        forward(name)
        times[name].append(time.perf_counter() - t0)
    summary = {}
    for name in paths:
        med = float(np.median(times[name]))
        prof = device_profile(lambda: forward(name), want, program=paths[name]["step"].program)
        summary[name] = {"forward_s": med, "scenes_per_s": B / med,
                         "device_busy_ms": prof.get("device_busy_ms"),
                         "device_spans": prof.get("device_spans"),
                         "markers_lost": prof.get("markers_lost"),
                         "htod_spans": prof.get("htod_spans"),
                         "top_device_ms": prof.get("top_device_ms", [])[:5],
                         "forward_s_all": times[name]}
    log("multiview_eval_forward", batch=B, num_points=cfg.num_points, input_feature_dim=dim,
        launches=launches["eval_forward"], outputs=shapes, peak_mem_gib=peak,
        in_turns=summary, eval_phase_default_scenes_per_s=default_forward_scenes_per_s)
    del paths, out

    launches["train_step"], train = run_train_steps(cfg, batch, "multiview_train_step")
    log("multiview", train_step_ms=train["step_ms"], default_train_step_ms=default_train["step_ms"],
        train_peak_mem_gib=train["peak_mem_gib"],
        default_train_peak_mem_gib=default_train["peak_mem_gib"],
        train_device_busy_ms=train["device_busy_ms"],
        default_train_device_busy_ms=default_train["device_busy_ms"])
    cli = mv_clis()
    if cli is not None:
        launches["cli"] = cli
    log("multiview", phase_s=time.perf_counter() - t_phase, enet_ms_per_batch=enet["ms_per_batch"])
    return launches


def cli_split(root):
    """The cli phase's synthetic split under ``root``: CLI_TRAIN_SCENES
    train and CLI_VAL_SCENES val scenes of MUL_EVAL_SCENE (relation labels
    written), one annotation an object, and the vocabulary cache padded to
    the model's 4528 words; a second data root of CLI_VIS_SCENES val
    scenes for ``--eval_visualize`` (the same scene files)."""
    n = CLI_TRAIN_SCENES + CLI_VAL_SCENES
    anns, scene_ids = write_synthetic_dataset(root, num_scenes=n, seed=1, anns_per_object=1,
                                              **MUL_EVAL_SCENE)
    train_ids, val_ids = set(scene_ids[:CLI_TRAIN_SCENES]), scene_ids[CLI_TRAIN_SCENES:]
    train_anns = [a for a in anns if a["scene_id"] in train_ids]
    val_anns = [a for a in anns if a["scene_id"] in set(val_ids)]
    vocab = padded_vocabulary(train_anns)
    vis_root = os.path.join(root, "vis_data")
    os.makedirs(vis_root)
    os.symlink(os.path.join(root, "scannet"), os.path.join(vis_root, "scannet"))
    vis_anns = [a for a in val_anns if a["scene_id"] in set(val_ids[:CLI_VIS_SCENES])]
    for r, split, split_anns in ((root, "train", train_anns), (root, "val", val_anns),
                                 (vis_root, "val", vis_anns)):
        with open(os.path.join(r, f"ScanRefer_filtered_{split}.json"), "w") as f:
            json.dump(split_anns, f)
    for r in (root, vis_root):
        vocab.save(os.path.join(r, "ScanRefer_vocabulary.json"))
    return train_anns, val_anns, vis_root


class CliCalls:
    """Counting shims for the factories the CLIs build their steps with:
    every call of a built step records its kind, its start time, each
    kernel's launches as the wrappers count them and what they should be
    (``wrapper_want``) and, for a train step, the batch's ``dataset_idx``.
    A shim keeps its step's ``program``. Installed on the modules the CLIs
    read them from while the ``with`` lasts."""

    SITES = ((solver_module, "make_train_step", "train_step"),
             (solver_module, "make_eval_step", "val_forward"),
             (step_module, "make_eval_step", "eval_forward"),
             (step_module, "make_attn_dump_step", "attn_dump"))

    def __init__(self):
        self.calls = []

    def wrap(self, make, kind):
        def factory(*a, **kw):
            step = make(*a, **kw)

            def run(*args, **kwargs):
                before = {k: f.launches for k, f in KERNELS.items()}
                t0 = time.perf_counter()
                out = step(*args, **kwargs)
                self.calls.append({
                    "kind": kind, "t0": t0,
                    "launches": {k: f.launches - before[k] for k, f in KERNELS.items()},
                    "want": wrapper_want(step, CLI_WANT),
                    "dataset_idx": (args[1]["dataset_idx"].tolist()
                                    if kind == "train_step" else None)})
                return out
            run.program = getattr(step, "program", None)
            return run
        return factory

    def __enter__(self):
        self.real = [(mod, name, getattr(mod, name)) for mod, name, _ in self.SITES]
        for (mod, name, kind), (_, _, make) in zip(self.SITES, self.real):
            setattr(mod, name, self.wrap(make, kind))
        return self

    def __exit__(self, *exc):
        for mod, name, make in self.real:
            setattr(mod, name, make)

    def take(self, kind=None):
        """The calls so far (of ``kind``), which are then forgotten; raises
        unless each launched FPS 2, ball query 5 and the decode kernels 0
        times (as the wrappers count them: ``wrapper_want``)."""
        got = [c for c in self.calls if kind is None or c["kind"] == kind]
        self.calls = [c for c in self.calls if c not in got]
        bad = [c for c in got if c["launches"] != c["want"]]
        if bad or not got:
            raise AssertionError(f"{kind or 'cli'}: {len(bad)} of {len(got)} calls counted "
                                 f"other than they should (counted, want): "
                                 f"{[(c['launches'], c['want']) for c in bad[:3]]}")
        return got


class SnapshotCheck:
    """Wraps ``Solver._save``: clones the model's state dict when a save is
    called; once that file is written (at the next save, or ``finish``), a
    fresh model loads it and its state dict must equal the clone bit for
    bit, though the train loop went on updating the parameters in place."""

    def __init__(self):
        self.pending, self.checked = [], []

    def check(self, solver):
        solver.ckpt.wait()
        for path, clone, cfg in self.pending:
            fresh = SpaCapNet(cfg).to(DEV)
            fresh.load_state_dict(load_checkpoint(path)["model_state_dict"])
            bad = [k for k, v in fresh.state_dict().items() if not torch.equal(v, clone[k])]
            if bad or set(clone) != set(fresh.state_dict()):
                raise AssertionError(f"{path} differs from its snapshot: {bad[:5]}")
            self.checked.append(os.path.basename(path))
        self.pending = []

    def __enter__(self):
        real = self.real = Solver._save

        def save(solver, name, epoch):
            self.check(solver)
            clone = {k: v.detach().clone() for k, v in solver.model.state_dict().items()}
            real(solver, name, epoch)
            self.pending.append((os.path.join(solver.root, name), clone, solver.mc))

        Solver._save = save
        return self

    def __exit__(self, *exc):
        Solver._save = self.real


def save_records(solver, steps):
    """Each of ``solver``'s saves: snapshot and write ms, and the train
    steps that started while the file was being written."""
    return [{"file": os.path.basename(r["path"]), "snapshot_ms": r["snapshot_s"] * 1e3,
             "write_ms": r["write_s"] * 1e3,
             "steps_during_write": sum(r["saved_at"] < c["t0"] < r["written_at"]
                                       for c in steps)} for r in solver.ckpt.records]


def train_cli_run(calls, snap, argv, what):
    """The train CLI on ``argv``; logs its steps, validations and saves, and
    the card's memory: reserved at the end (the validations' graphs
    dropped) and the run's peak reserved and allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = train_cli.main(argv)
    wall_s = time.perf_counter() - t0
    memory = {"reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
              "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2 ** 30,
              "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "graph_sets_held": (len(solver.eval_step.program.entries)
                                  if solver.eval_step.program is not None else 0),
              "train_graph_sets_held": (len(solver.train_step.program.entries)
                                        if solver.train_step.program is not None else 0)}
    snap.check(solver)
    steps, vals = calls.take("train_step"), calls.take("val_forward")
    with open(os.path.join(solver.root, "all_scalars.json")) as f:
        scalars = json.load(f)
    losses = {k: [v for _, _, v in series] for k, series in scalars.items()
              if k.startswith("train/") and k.endswith("loss")}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"{what}: non-finite losses {losses}")
    log("cli", run=what, wall_s=wall_s, steps=len(steps), val_forwards=len(vals),
        validations=len(solver.timing["val"]), start_epoch=solver.start_epoch,
        global_iter=solver.global_iter,
        median_step_ms=float(np.median(solver.timing["step"])) * 1e3,
        step_samples=len(solver.timing["step"]),
        mean_fetch_ms=float(np.mean(solver.timing["fetch"])) * 1e3,
        validation_wall_s=solver.timing["val"], saves=save_records(solver, steps),
        loss_first_last=[losses["train/loss"][0], losses["train/loss"][-1]],
        best=solver.best, **memory)
    return solver, steps


def eval_cli_run(calls, argv, what, kinds=("eval_forward",)):
    t0 = time.perf_counter()
    rows = eval_cli.main(["--device", DEV, "--num_workers", "8", "--batch_size", str(B)]
                         + argv)
    wall_s = time.perf_counter() - t0
    counted = {k: len(calls.take(k)) for k in kinds}
    for row in rows or []:
        if not all(np.isfinite(v) for v in row.values()):
            raise AssertionError(f"{what}: non-finite metrics {row}")
    log("cli", run=what, wall_s=wall_s, calls=counted, rows=rows)
    return rows


def check_visualize(run_root):
    """Each scene's ply holds the evaluated cloud; its box plys are exactly
    the entries of predictions.json, each a 12-edge cylinder mesh in the
    object's palette colour. Returns the scenes' prediction counts."""
    counts = {}
    for scene in sorted(os.listdir(os.path.join(run_root, "vis"))):
        d = os.path.join(run_root, "vis", scene)
        with open(os.path.join(d, "predictions.json")) as f:
            preds = json.load(f)
        with open(os.path.join(d, f"{scene}.ply")) as f:
            head = f.read(200)
        want = {f"pred-{oid}-{e['object_name']}.ply" for oid, e in preds.items()}
        have = {n for n in os.listdir(d) if n.startswith("pred-")}
        if f"element vertex {ModelConfig().num_points}\n" not in head or have != want:
            raise AssertionError(f"{scene}: plys {sorted(have)} against {sorted(want)}")
        for oid, entry in preds.items():
            with open(os.path.join(d, f"pred-{oid}-{entry['object_name']}.ply")) as f:
                lines = f.read().splitlines()
            colour = " ".join(str(int(c)) for c in COLORS[int(oid) % len(COLORS)])
            verts = lines[lines.index("end_header") + 1:][:12 * 16]
            if "element vertex 192" not in lines or not all(
                    v.endswith(colour) and np.isfinite([float(x) for x in v.split()[:3]]).all()
                    for v in verts):
                raise AssertionError(f"{scene} pred-{oid}: bad box mesh")
            if not entry["description"].startswith("sos"):
                raise AssertionError(f"{scene} pred-{oid}: {entry}")
        counts[scene] = len(preds)
    return counts


def cli_host_legs(calls, snap, common):
    """The train CLI's sampled step and fetch with the host library and with
    its plain numpy versions swapped in (``host_leg``), in turns: plain,
    library, each a 1-epoch run of ``common`` without validation. The legs
    must draw the same batches in the same order, and their first losses
    agree (the items are equal bit for bit)."""
    legs = {}
    for leg in ("plain", "library"):
        host_calls = {}
        t0 = time.perf_counter()
        with host_leg(leg, host_calls):
            solver = train_cli.main(common + ["--epoch", "1", "--val_step", "1000000",
                                              "--tag", f"host_{leg}"])
        wall_s = time.perf_counter() - t0
        snap.check(solver)
        steps = calls.take("train_step")
        calls.calls = [c for c in calls.calls if c["kind"] != "val_forward"]
        with open(os.path.join(solver.root, "all_scalars.json")) as f:
            loss = [v for _, _, v in json.load(f)["train/loss"]]
        legs[leg] = {"wall_s": wall_s, "steps": len(steps),
                     "median_step_ms": float(np.median(solver.timing["step"])) * 1e3,
                     "step_samples": len(solver.timing["step"]),
                     "mean_fetch_ms": float(np.mean(solver.timing["fetch"])) * 1e3,
                     "first_loss": loss[0], "host_calls": host_calls,
                     "batches": [c["dataset_idx"] for c in steps]}
    same = legs["plain"]["batches"] == legs["library"]["batches"]
    close = abs(legs["plain"]["first_loss"] - legs["library"]["first_loss"]) <= (
        CLI_LEG_LOSS_RTOL * abs(legs["library"]["first_loss"]))
    log("cli", host_legs={leg: {k: v for k, v in d.items() if k != "batches"}
                          for leg, d in legs.items()}, same_batches=same,
        library_over_plain_step_ms=legs["library"]["median_step_ms"]
        / legs["plain"]["median_step_ms"])
    if not same or not close:
        raise AssertionError(f"host legs differ: same batches {same}, first losses "
                             f"{legs['plain']['first_loss']} / {legs['library']['first_loss']}")


def phase_cli():
    """The port's command lines on the card at the default ModelConfig's
    width (40,000 points, 256 proposals, 6+6 layers, d_ff 2048, B = 8, the
    vocabulary padded to 4528), through their ``main(argv)``, on a
    synthetic split of CLI_TRAIN_SCENES + CLI_VAL_SCENES scenes of ~52,000
    points written to a temporary directory. Train: ``--arch_preset full
    --epoch 2`` with a validation in each epoch, then ``--use_checkpoint
    --epoch 3``. Gates: the run's files; the resumed run starts at epoch
    index 2 with the iteration count carried over and the batch order of an
    uninterrupted run; finite logged losses; every checkpoint, loaded into
    a fresh model, equal bit for bit to the state dict at its save; FPS 2,
    ball query 5 and decode kernels 0 in every train step and every
    forward. Evaluate: one seed with detection, the grid of 2 seeds against
    ``--serial_mul_eval`` (equal rows), ``--detection_only``, the attention
    and proposal dumps and ``--eval_visualize`` on CLI_VIS_SCENES scenes
    (these three and the grid on a copy of the checkpoint with its
    objectness-1 logit raised by 2, as the mul_eval phase raises it for
    random weights, so that candidates exist); then the overfit gate at
    the JAX package's CI settings. After the resume, the train CLI's host
    legs (``cli_host_legs``). Every count is set to 0 just before the
    train run and read after the last eval run; returns those launches."""
    with tempfile.TemporaryDirectory(prefix="cli_") as root, CliCalls() as calls, \
            SnapshotCheck() as snap:
        t0 = time.perf_counter()
        train_anns, val_anns, vis_root = cli_split(root)
        out = os.path.join(root, "outputs")
        steps_per_epoch = len(train_anns) // B
        # one validation an epoch (3 epochs of 32 steps: at 30, 60, 90), each
        # followed by train steps while its model.ckpt is written
        val_step = steps_per_epoch - 2
        common = ["--data_root", root, "--output_dir", out, "--arch_preset", "full",
                  "--batch_size", str(B), "--val_step", str(val_step), "--verbose", "4",
                  "--num_workers", "8", "--seed", "0", "--device", DEV]
        log("cli", split_write_s=time.perf_counter() - t0, train_annotations=len(train_anns),
            val_scenes=CLI_VAL_SCENES, steps_per_epoch=steps_per_epoch, val_step=val_step)

        for k in KERNELS.values():
            k.launches = 0
        first, _ = train_cli_run(calls, snap, common + ["--epoch", "2", "--tag", "cli"],
                                 "train")
        run = first.stamp
        files = sorted(os.listdir(first.root))
        missing = [f for f in ("config.json", "info.json", "log.txt", "all_scalars.json",
                               "model_last.ckpt", "model.ckpt", "best.txt", "best.json")
                   if f not in files]
        if missing or len(first.timing["val"]) != 2:
            raise AssertionError(f"run files {files}, missing {missing}; "
                                 f"{len(first.timing['val'])} validations")
        # the same step on one held batch of the run's loader, with no loader
        # thread running: the CLI's step time without the loader's Python
        batch = next(iter(DataLoader(first.train_dataset, B, shuffle=True, seed=0,
                                     num_workers=8)))
        held_ms = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first.train_step(first.model, batch, first.dropout_generator(i), 0.1)
            torch.cuda.synchronize()
            held_ms.append((time.perf_counter() - t0) * 1e3)
        calls.take("train_step")
        log("cli", held_batch_step_ms=float(np.median(held_ms[1:])), held_batch_all=held_ms,
            cli_median_step_ms=float(np.median(first.timing["step"])) * 1e3)
        resumed, steps = train_cli_run(calls, snap, common + ["--epoch", "3", "--use_checkpoint",
                                                              run], "resume")
        loader = DataLoader(resumed.train_dataset, B, shuffle=True, seed=0, num_workers=8)
        loader.epoch = 2
        want_idx = next(iter(loader))["dataset_idx"].tolist()
        position = {"start_epoch": resumed.start_epoch, "first_global_iter": first.global_iter,
                    "global_iter": resumed.global_iter, "first_batch": steps[0]["dataset_idx"],
                    "uninterrupted_first_batch": want_idx}
        log("cli", resume=position, snapshots_checked=snap.checked)
        if (resumed.start_epoch != 2 or resumed.global_iter != 3 * steps_per_epoch
                or len(steps) != steps_per_epoch or steps[0]["dataset_idx"] != want_idx
                or len(resumed.timing["val"]) != 1):
            raise AssertionError(f"resume position: {position}")
        # model_last after each of the 3 epochs; model at each new best
        if snap.checked.count("model_last.ckpt") != 3 or "model.ckpt" not in snap.checked:
            raise AssertionError(f"checkpoints checked: {snap.checked}")
        cli_host_legs(calls, snap, common)

        run_root = os.path.join(out, run)
        ckpt = load_checkpoint(os.path.join(run_root, "model.ckpt"))
        ckpt["model_state_dict"]["proposal.proposal.6.bias"][1] += 2.0
        save_checkpoint_sync(os.path.join(run_root, "detects.ckpt"), ckpt)
        ev = ["--folder", run, "--data_root", root, "--output_dir", out]
        eval_cli_run(calls, ev + ["--checkpoint", "model.ckpt", "--eval_tag", "one"], "one_seed")
        with open(os.path.join(run_root, "one_results.csv")) as f:
            header = f.readline().strip().split(",")
        if not {"cider", "bleu-4", "rouge", "meteor", "mAP@0.5"} <= set(header):
            raise AssertionError(f"CSV columns {header}")
        det = ev + ["--checkpoint", "detects.ckpt", "--min_iou", str(MUL_EVAL_GATE_IOU)]
        grid = eval_cli_run(calls, det + ["--eval_tag", "grid", "--mul_eval", "--num_seeds",
                                          "2"], "mul_eval")
        serial = eval_cli_run(calls, det + ["--eval_tag", "serial", "--mul_eval",
                                            "--num_seeds", "2", "--serial_mul_eval"],
                              "serial_mul_eval")
        if grid != serial or grid[0] == grid[1]:
            raise AssertionError(f"grid rows {grid} against serial rows {serial}")
        eval_cli_run(calls, ev + ["--checkpoint", "model.ckpt", "--eval_tag", "det",
                                  "--detection_only"], "detection_only")
        eval_cli_run(calls, det + ["--eval_tag", "dumps", "--save_encoder_attn",
                                   "--save_decoder_attn", "--save_proposal"], "dumps",
                     kinds=("eval_forward", "attn_dump"))
        with open(os.path.join(run_root, "dumps_dumps", "attn_weights.pkl"), "rb") as f:
            attn = pickle.load(f)
        cfg = ModelConfig()
        k, t = cfg.num_proposals, cfg.max_des_len + 2
        shapes = {(e["encoder_attn_weights"].shape, e["decoder_attn_weights"].shape)
                  for e in attn.values()}
        want_shapes = {((cfg.num_layers, cfg.num_heads, k, k),
                        (cfg.num_layers, cfg.num_heads, t, t))}
        if not attn or shapes != want_shapes or not all(
                np.isfinite(e["encoder_attn_weights"]).all() for e in attn.values()):
            raise AssertionError(f"attention dump: {len(attn)} entries, shapes {shapes}")
        log("cli", attention_entries=len(attn), attention_shapes=[list(s) for s in shapes.pop()],
            dump_mb={n: os.path.getsize(os.path.join(run_root, "dumps_dumps", n)) / 2 ** 20
                     for n in os.listdir(os.path.join(run_root, "dumps_dumps"))})
        eval_cli_run(calls, ["--folder", run, "--data_root", vis_root, "--output_dir", out,
                             "--checkpoint", "detects.ckpt", "--min_iou",
                             str(MUL_EVAL_GATE_IOU), "--eval_visualize", "--nodryrun"],
                     "eval_visualize")
        vis = check_visualize(run_root)
        if len(vis) != CLI_VIS_SCENES or not sum(vis.values()):
            raise AssertionError(f"visualized scenes {vis}")
        launches = {k: f.launches for k, f in KERNELS.items()}
        log("cli", visualized_predictions=vis, launches=launches)

        t0 = time.perf_counter()
        result = overfit_gate_run(root)
        gate_s = time.perf_counter() - t0
        log("overfit_gate", wall_s=gate_s, args=OVERFIT_ARGS, **result)
        if not result["passed"]:
            raise AssertionError(f"overfit gate failed: {result}")
    return launches


def overfit_gate_run(root):
    """``scripts/overfit_gate.py --deterministic`` at OVERFIT_ARGS in a
    fresh process (its cuBLAS must start after ``CUBLAS_WORKSPACE_CONFIG``
    is set), working under ``root``; returns its JSON result."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "overfit_result.json")
    proc = subprocess.run([sys.executable, "-m", "spacap3d_tpu_torch.scripts.overfit_gate",
                           "--workdir", os.path.join(root, "overfit"), "--device", DEV,
                           "--deterministic", "--out", out] + OVERFIT_ARGS,
                          capture_output=True, text=True, cwd=here, timeout=600)
    print(proc.stdout, end="", flush=True)
    if proc.returncode not in (0, 1) or not os.path.exists(out):
        raise AssertionError(f"overfit gate process exited {proc.returncode}: "
                             f"{proc.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


def run_ranks(cmd, world, what, expect_fail=False):
    """``python *cmd`` on ``world`` ranks (``mp_dryrun.launch``); raises
    unless every rank exits 0. Returns the finished processes."""
    t0 = time.perf_counter()
    done = launch(cmd, world, PARALLEL_TIMEOUT)
    bad = [(r, p.returncode, p.stdout[-1500:], p.stderr[-3000:])
           for r, p in enumerate(done) if p.returncode != 0]
    if bad:
        raise AssertionError(f"{what}: ranks failed: {bad}")
    log("parallel", leg=what, ranks=world, wall_s=time.perf_counter() - t0)
    return done


def dryrun(out, world, backend, cfg, *args):
    """``mp_dryrun`` on ``world`` ranks of ``backend`` on the card, at the
    width of ``cfg``; returns each rank's JSON."""
    os.makedirs(out, exist_ok=True)
    cfg_path = os.path.join(out, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    run_ranks(["-m", "spacap3d_tpu_torch.parallel.mp_dryrun", "--out", out, "--device", DEV,
               "--backend", backend, "--timeout", str(PARALLEL_COLLECTIVE_S), "--config",
               cfg_path, *map(str, args)], world, f"mp_dryrun {args[1]} ({backend})")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def refuse_nccl(out):
    """P0: two ranks asking NCCL for the one card must both be refused by
    the runtime's own message, naming gloo."""
    done = run_ranks(["-m", "spacap3d_tpu_torch.parallel.mp_dryrun", "--out", out, "--legs",
                      "refuse_nccl", "--device", DEV, "--timeout", str(PARALLEL_COLLECTIVE_S)],
                     2, "P0 refuse_nccl")
    refusals = [p.stdout.strip().splitlines()[-1] for p in done]
    if not all(r.startswith("refused: NCCL cannot run two ranks on one device")
               and "backend='gloo'" in r for r in refusals):
        raise AssertionError(f"P0: {refusals}")
    log("parallel", leg="P0", refusals=refusals)


def metric_misses(got, want, rtol, atol):
    """The metrics of ``want`` that ``got`` misses by more than atol + rtol
    |want|, with both values."""
    return {k: (got[k], v) for k, v in want.items() if abs(got[k] - v) > atol + rtol * abs(v)}


def check_launches(what, per_call, want=CLI_WANT):
    """Every train step and forward of a rank launches as ``want`` says (by
    default as one of the CLIs')."""
    bad = [c for c in per_call if c != want]
    if bad or not per_call:
        raise AssertionError(f"{what}: {len(bad)} of {len(per_call)} calls launched other "
                             f"than {want}: {bad[:3]}")


def turns_differ(turns):
    """What differs between a captured run and its eager turns
    (``mp_dryrun``'s ``captured_train_turns``) under ``torch.equal``:
    per call its metrics and masks, then the state, with the largest
    differences."""
    out = {k: turns[k] for k in ("metrics_differ", "masks_differ") if any(turns[k])}
    out.update({k: turns[k] for k in ("parameters_differ", "adam_state_differ",
                                      "bn_buffers_differ") if turns[k]})
    if not turns["generator_states_equal"]:
        out["generator_states"] = "differ"
    return out


def replay_profile(profiles, want, world):
    """A captured call's profile (``mp_dryrun.kernel_spans``) against the
    eager call's: the replay's kernel spans by name, which must be
    ``want``, and NCCL's device spans in each, which must be equal, and
    at least one where the world has more than one rank (NCCL issues no
    device work for an in-place sum over a group of one). Returns (the
    log, the misses)."""
    replay, eager = profiles["captured"], profiles["eager"]
    spans = {k: replay["kernel_spans"][k] for k in want}
    nccl = {"replay": replay["kernel_spans"]["nccl"], "eager": eager["kernel_spans"]["nccl"]}
    misses = []
    if replay["call"]["captured"] or spans != want:
        misses.append(f"replay spans {spans} (call {replay['call']}), not {want}")
    if nccl["replay"] != nccl["eager"] or (world > 1 and not nccl["replay"]):
        misses.append(f"NCCL spans {nccl}")
    return {"replay_spans": spans, "nccl_spans": nccl,
            "eager_collectives": eager["collectives"],
            "nccl_span_names": replay["nccl_device_spans"],
            "incomplete_profiles": [replay["incomplete_profiles"],
                                    eager["incomplete_profiles"]]}, misses


def turns_ms(ms):
    """Each kind's call ms in turns, and their median after the first (a
    captured run's first call is its warm-up and capture)."""
    return {k: {"each": v, "median_after_first": float(np.median(v[1:]))}
            for k, v in ms.items()}


def parallel_tp1(out, cfg, smi, launches):
    """P1 TP 1: tensor parallelism at tp 1 on NCCL over a world of one
    (``make_tp_mesh(1)``: every attention and FFN all-reduce a collective
    over a group of one), the captured steps against eager ones in turns
    under deterministic algorithms: the train step at the default dropout
    bit-equal, the eval forward unfused and fused with every output
    ``torch.equal``; the launches from a replay's kernel spans (FPS 2,
    ball query 5, and fused ``generator_argmax`` 31, ``ffn_partial``
    192), NCCL's spans of a replay equal to the eager call's; ms in turns
    and peak reserved memory."""
    r = dryrun(os.path.join(out, "p1_tp1"), 1, "nccl", cfg, "--legs", "tp", "--tp", 1,
               "--global_batch", B, "--steps", 1, "--dropout", cfg.transformer_dropout,
               "--captured", "--deterministic")[0]["tp"]
    train, ev = r["captured"], r["captured_eval"]
    misses = {}
    if turns_differ(train):
        misses["train"] = turns_differ(train)
    train_prof, m = replay_profile(train["profiles"], TRAIN_WANT, 1)
    if m:
        misses["train_profile"] = m
    wants = {"unfused": TRAIN_WANT, "fused": TP_FUSED_WANT}
    eval_log = {}
    for name, want in wants.items():
        e = ev[name]
        prof, m = replay_profile(e["profiles"], want, 1)
        if any(e["differ"]) or [c["captured"] for c in e["calls"]][1:] != [False] * (
                len(e["calls"]) - 1) or m:
            misses[name] = {"differ": e["differ"], "calls": e["calls"], "profile": m}
        eval_log[name] = {"ms": turns_ms(e["ms"]), "calls": e["calls"], **prof}
        launches[f"P1_tp1_{name}_replay"] = [e["profiles"]["captured"]["kernel_spans"]]
    launches["P1_tp1_step_replay"] = [train["profiles"]["captured"]["kernel_spans"]]
    log("parallel", leg="P1 TP 1", backend="nccl", world=1, tp=1,
        sharded_parameters=r["sharded_parameters"],
        train={"steps": train["steps"], "ms": turns_ms(train["ms"]), "calls": train["calls"],
               "masks_per_step": train["masks_per_step"], "bit_equal": not turns_differ(train),
               **train_prof, "peak_reserved_gib": train["peak_reserved_gib"]},
        eval=eval_log, eval_peak_reserved_gib=ev["peak_reserved_gib"], misses=misses,
        nvidia_smi=smi)
    if misses:
        raise AssertionError(f"P1 TP 1: {misses}")


def parallel_captured_ranks(results, ranks, launches, smi):
    """P2 and P3 captured, over NCCL on ``ranks`` cards: each rank's
    captured DP and TP train steps against its eager turns, every metric
    within PARALLEL_RTOL plus PARALLEL_ATOL (the backward's atomics make
    two runs of one step differ in the last bits; what differs is logged
    with its largest difference), the ranks' parameters bit-equal; the TP
    eval forwards' tokens equal to the eager ones and objectness within
    PARALLEL_OBJ_ATOL; the launches and NCCL's spans of each replay."""
    misses, entries = {}, {}
    for leg, want in (("dp", TRAIN_WANT), ("tp", TRAIN_WANT)):
        turns = [r[leg]["captured"] for r in results]
        for rank, t in enumerate(turns):
            bad = [metric_misses(c, e, PARALLEL_RTOL, PARALLEL_ATOL)
                   for c, e in zip(t["metrics"]["captured"], t["metrics"]["eager"])]
            prof, m = replay_profile(t["profiles"], want, ranks)
            if any(bad) or m:
                misses[f"{leg} rank {rank}"] = {"metrics": bad, "profile": m}
            entries.setdefault(leg, []).append({
                "ms": turns_ms(t["ms"]), "calls": t["calls"], "differ": turns_differ(t),
                **prof, "peak_reserved_gib": t["peak_reserved_gib"]})
        if len({t["param_digest"] for t in turns}) != 1:
            misses[f"{leg} ranks"] = "captured parameters differ across ranks"
        launches[f"P2_{leg}_step_replay" if leg == "dp" else "P3_tp_step_replay"] = [
            t["profiles"]["captured"]["kernel_spans"] for t in turns]
    for name, want in (("unfused", TRAIN_WANT), ("fused", TP_FUSED_WANT)):
        for rank, r in enumerate(results):
            e = r["tp"]["captured_eval"][name]
            prof, m = replay_profile(e["profiles"], want, ranks)
            bad = [d for d in e["differ"] if "lang_cap" in d
                   or d.get("objectness_scores", 0.0) > PARALLEL_OBJ_ATOL]
            if bad or m:
                misses[f"{name} eval rank {rank}"] = {"differ": bad, "profile": m}
            entries.setdefault(f"tp_eval_{name}", []).append({
                "ms": turns_ms(e["ms"]), "calls": e["calls"], "differ": e["differ"], **prof})
        launches[f"P3_tp_{name}_replay"] = [
            r["tp"]["captured_eval"][name]["profiles"]["captured"]["kernel_spans"]
            for r in results]
    log("parallel", leg="P2-P3 captured", backend="nccl", world=ranks, per_rank=entries,
        eval_peak_reserved_gib=[r["tp"]["captured_eval"]["peak_reserved_gib"] for r in results],
        misses=misses, nvidia_smi=smi)
    if misses:
        raise AssertionError(f"P2-P3 captured: {misses}")


def parallel_shared_card(out, cfg, smi, launches):
    """P0, P1 and P1 TP 1 of ``phase_parallel``: NCCL refusing two ranks on
    the card, and NCCL over a world of one against the plain steps, the
    captured steps against eager ones."""
    refuse_nccl(os.path.join(out, "p0"))
    # P1: NCCL, a world of one
    p1 = dryrun(os.path.join(out, "p1"), 1, "nccl", cfg, "--legs", "dp",
                "--global_batch", B, "--steps", PARALLEL_P1_STEPS, "--dropout",
                cfg.transformer_dropout, "--plain", "--deterministic", "--captured")[0]["dp"]
    misses = [metric_misses(g["metrics"], w["metrics"], PARALLEL_P1_RTOL, 0.0)
              for g, w in zip(p1["steps"], p1["plain_steps"])]
    check_launches("P1 steps", [s["launches"] for s in p1["steps"]])
    launches["P1_nccl_step"] = [s["launches"] for s in p1["steps"]]
    log("parallel", leg="P1", backend="nccl", world=1, steps=PARALLEL_P1_STEPS,
        dropout=cfg.transformer_dropout, max_metric_rel=max(p1["plain_rel"]),
        bit_equal=p1["plain_bit_equal"], max_param_abs_diff=p1["plain_param_max_abs"],
        step_ms=[s["ms"] for s in p1["steps"]],
        plain_step_ms=[s["ms"] for s in p1["plain_steps"]],
        launches_per_step=launches["P1_nccl_step"], nvidia_smi=smi)
    if any(misses):
        raise AssertionError(f"P1: group path against plain: {misses}")
    # the captured DP step against eager ones in turns, both against plain
    cap = p1["captured"]
    cap_misses = {kind: [metric_misses(g, w["metrics"], PARALLEL_P1_RTOL, 0.0)
                         for g, w in zip(cap["metrics"][kind], p1["plain_steps"])]
                  for kind in ("eager", "captured")}
    prof, prof_misses = replay_profile(cap["profiles"], TRAIN_WANT, 1)
    launches["P1_nccl_step_replay"] = [cap["profiles"]["captured"]["kernel_spans"]]
    log("parallel", leg="P1 captured", backend="nccl", world=1, steps=cap["steps"],
        ms=turns_ms(cap["ms"]), calls=cap["calls"], masks_per_step=cap["masks_per_step"],
        bit_equal=not turns_differ(cap), differ=turns_differ(cap), plain_misses=cap_misses,
        **prof, peak_reserved_gib=cap["peak_reserved_gib"], nvidia_smi=smi)
    if turns_differ(cap) or any(any(m) for m in cap_misses.values()) or prof_misses:
        raise AssertionError(f"P1 captured: {turns_differ(cap)}, against plain {cap_misses}, "
                             f"profile {prof_misses}")
    parallel_tp1(out, cfg, smi, launches)


def phase_parallel(smi, ranks=2, backend="gloo"):
    """The parallel runtimes on the card (``spacap3d_tpu_torch/parallel``),
    every rank a process of its own, so that this process holds no process
    group; the kernel library is already built. P0: NCCL asked for two
    ranks on one card refuses. P1: NCCL over a world of one at full width
    (default ModelConfig and TrainConfig, B = 8, 40,000 points, dropout
    0.1): PARALLEL_P1_STEPS group-path steps against as many plain steps
    from the same weights, batch and generators, every metric within rel
    1e-6, under torch's deterministic algorithms (the backward's atomic
    sums would otherwise make two runs of one step differ in the last
    bits, which Adam turns into other updates of near-zero gradients).
    P2: two gloo ranks sharing the card, 4 rows each of the same batch at
    dropout 0, one step against the 1-process step on the 8 rows (rank
    0's), each rank's FPS and ball-query indices and max-pools pinned to
    that step's (a BN statistic's two sums round apart, which moves the
    votes that the aggregation samples and groups, and flips near ties;
    the flips are logged): every metric
    within rel PARALLEL_RTOL plus PARALLEL_ATOL, the ranks' parameters and
    BN buffers bit-equal. P3: tensor parallelism over the
    same two ranks: the eval forward's tokens against the replicated
    forward's here (equal, or each differing row a near tie by
    ``compare_tokens``), objectness within 1e-5; the fused eval forward
    (``eval_decode_fused``: the FFN kernel's partial sums on each rank's
    d_ff slice, one all-reduce after each) against the replicated fused
    forward here as the unfused one, its ranks' token digests equal and
    each rank's launches TP_FUSED_WANT, both forwards timed in turns; and
    one TP train step's metrics against P2's 1-process step as P2's, the
    ranks' parameters bit-equal after it. P4: the
    seed-sharded grid over PARALLEL_GRID_SCENES scenes of the cli split x
    PARALLEL_GRID_SEEDS seeds against the 1-process grid here: equal rows.
    P5: the train CLI with --multihost on two ranks (one epoch, one
    validation) writes one run directory, from rank 0; the eval CLI with
    --multihost --mul_eval gives the 1-process CLI's rows. Every other train
    step and forward of P1-P4 launches FPS 2, ball query 5 and the decode
    kernels 0 times on each rank. P1 also runs the captured DP step against
    eager ones in turns (``parallel_shared_card``), and P1 TP 1 the captured
    TP steps at tp 1 (``parallel_tp1``). Returns the launches by leg (a
    replay's from its profile's kernel spans, with NCCL's under ``nccl``).

    ``python3 chip_smoke.py --ranks N``, on a machine of N cards, runs
    P2-P5 alone over N ranks, one card a rank over NCCL (TP then splits the
    world into N / 2 data x 2 model ranks), the steps of P2, P3 and P5
    captured (P2 and P3 also eager, in turns: ``parallel_captured_ranks``);
    P0 and P1 belong to the shared card. It is the entry point of the multi-card checks until a
    multi-card cell exists."""
    cfg = ModelConfig()
    dev = torch.device(DEV)
    launches = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="parallel_") as root:
        out = os.path.join(root, "runs")
        if backend == "gloo":       # the ranks share one card
            parallel_shared_card(out, cfg, smi, launches)
        # the cli split, and weights that detect (the objectness-1 logit +2)
        t0 = time.perf_counter()
        train_anns, val_anns, _ = cli_split(root)
        model = init_spacap(cfg, seed=0, device=DEV)
        with torch.no_grad():
            model.proposal.proposal[6].bias[1] += 2.0
        weights = os.path.join(root, "weights.pt")
        torch.save(model.state_dict(), weights)
        log("parallel", split_write_s=time.perf_counter() - t0)

        # P2-P4: two gloo ranks sharing the card
        seeds = list(range(PARALLEL_GRID_SEEDS))
        p2_dir = os.path.join(out, "p2")
        results = dryrun(p2_dir, ranks, backend, cfg, "--legs", "dp,tp,grid", "--global_batch", B,
                       "--weights", weights, "--plain", "--pin", "--data_root", root,
                       "--anns",
                       os.path.join(root, "ScanRefer_filtered_train.json"), "--vocab",
                       os.path.join(root, "ScanRefer_vocabulary.json"), "--scenes",
                       PARALLEL_GRID_SCENES, "--seeds", ",".join(map(str, seeds)),
                       "--grid_batch", B, "--workers", 4,
                       *(["--captured"] if backend == "nccl" else []))
        dp = [r["dp"] for r in results]
        plain = dp[0]["plain_steps"][0]["metrics"]
        p2_miss = [metric_misses(d["steps"][0]["metrics"], plain, PARALLEL_RTOL, PARALLEL_ATOL)
                   for d in dp]
        same = {k: len({d[k] for d in dp}) == 1 for k in ("param_digest", "bn_digest")}
        launches["P2_dp_step"] = [d["steps"][0]["launches"] for d in dp]
        check_launches("P2 steps", launches["P2_dp_step"])
        rel = {k: abs(v - plain[k]) / max(abs(plain[k]), 1e-12)
               for k, v in dp[0]["steps"][0]["metrics"].items()}
        log("parallel", leg="P2", backend=backend, world=ranks,
            rows_per_rank=[d["rows"] for d in dp], pinned=dp[1]["pinned"], pool_flips=[d["pool_flips"] for d in dp],
            index_flips=[d["index_flips"] for d in dp],
            metric_rel=rel, misses=p2_miss,
            ranks_bit_equal=same,
            max_param_abs_diff_vs_plain=dp[0]["plain_param_max_abs"],
            step_ms=[d["steps"][0]["ms"] for d in dp],
            plain_step_ms=dp[0]["plain_steps"][0]["ms"], launches=launches["P2_dp_step"],
            nvidia_smi=smi)
        if any(p2_miss) or not all(same.values()):
            raise AssertionError(f"P2: {p2_miss}, ranks bit-equal {same}")
        if backend == "nccl":
            parallel_captured_ranks(results, ranks, launches, smi)

        tp = [r["tp"] for r in results]
        got = torch.load(os.path.join(p2_dir, "tp_eval.pt"), weights_only=True)
        batch = train_batch(cfg, B, seed=0)
        dev_batch = to_device_batch({k: batch[k] for k in ("point_clouds", "center_label")},
                                    dev)
        want = make_eval_step(cfg, device=DEV)(model, dev_batch)
        tokens = compare_tokens({"model": model}, dev_batch, want["lang_cap"],
                                got["lang_cap"].to(dev))
        obj = float((got["objectness_scores"].to(dev) - want["objectness_scores"]).abs().max())
        tp_miss = [metric_misses(t["steps"][0]["metrics"], plain, PARALLEL_RTOL, PARALLEL_ATOL)
                   for t in tp]
        launches["P3_tp_eval"] = [t["eval_launches"] for t in tp]
        launches["P3_tp_step"] = [t["steps"][0]["launches"] for t in tp]
        check_launches("P3", launches["P3_tp_eval"] + launches["P3_tp_step"])
        # the fused TP forward (counts set to 0 just before it on each rank)
        # against the replicated fused forward here
        fused_cfg = dataclasses.replace(cfg, eval_decode_fused=True)
        fused_model = init_spacap(fused_cfg, seed=0, device=DEV)
        fused_model.load_state_dict(model.state_dict())
        want_fused = make_eval_step(fused_cfg, device=DEV)(fused_model, dev_batch)
        got_fused = torch.load(os.path.join(p2_dir, "tp_eval_fused.pt"), weights_only=True)
        fused_tokens = compare_tokens({"model": fused_model}, dev_batch, want_fused["lang_cap"],
                                      got_fused["lang_cap"].to(dev))
        fused_obj = float((got_fused["objectness_scores"].to(dev)
                           - want_fused["objectness_scores"]).abs().max())
        launches["P3_tp_fused_eval"] = [t["fused"]["eval_launches"] for t in tp]
        check_launches("P3 fused", launches["P3_tp_fused_eval"], TP_FUSED_WANT)
        fused_same = len({t["fused"]["token_digest"] for t in tp}) == 1
        tp_same = len({t["param_digest"] for t in tp}) == 1
        log("parallel", leg="P3", tp=2, sharded_parameters=tp[0]["sharded_parameters"],
            tokens=tokens, token_digests_equal=len({t["token_digest"] for t in tp}) == 1,
            objectness_max_abs=obj, step_misses=tp_miss,
            step_ms=[t["steps"][0]["ms"] for t in tp], ranks_bit_equal=tp_same,
            fused_tokens=fused_tokens, fused_token_digests_equal=fused_same,
            fused_objectness_max_abs=fused_obj, eval_ms=[t["eval_ms"] for t in tp],
            launches={k: launches[k] for k in ("P3_tp_eval", "P3_tp_step", "P3_tp_fused_eval")},
            nvidia_smi=smi)
        if (obj > PARALLEL_OBJ_ATOL or fused_obj > PARALLEL_OBJ_ATOL or any(tp_miss)
                or not tp_same or not fused_same):
            raise AssertionError(f"P3: objectness {obj}, fused {fused_obj}, step {tp_miss}, "
                                 f"ranks bit-equal {tp_same}, fused digests equal {fused_same}")

        grid = [r["grid"] for r in results]
        anns, ds, vocab, dc = grid_dataset(root, os.path.join(
            root, "ScanRefer_filtered_train.json"), os.path.join(
            root, "ScanRefer_vocabulary.json"), cfg, PARALLEL_GRID_SCENES)
        t0 = time.perf_counter()
        want_rows = mul_eval_grid(make_eval_step(cfg, device=DEV, compact=True), model, ds,
                                  vocab, dc, prepare_corpus(anns), organize_annotations(anns),
                                  seeds, B, min_iou=GRID_MIN_IOU, num_workers=4,
                                  score_workers=4, device=DEV)
        one_s = time.perf_counter() - t0
        launches["P4_grid_forward"] = [c for g in grid for c in g["launches"]]
        # each forward as the wrappers count it: eagerly, or twice where it
        # captured a graph and not at all where it replayed one
        for g in grid:
            for got, captured in zip(g["launches"], g["captured"]):
                times = 1 if captured is None else 2 if captured else 0
                check_launches("P4", [got], {k: times * n for k, n in CLI_WANT.items()})
        log("parallel", leg="P4", seeds=seeds, scenes=PARALLEL_GRID_SCENES,
            local_seeds=[g["local_seeds"] for g in grid], forwards=[g["forwards"] for g in grid],
            rank_grid_s=[g["seconds"] for g in grid], one_process_grid_s=one_s,
            rows_equal=all(g["rows"] == want_rows for g in grid), rows=want_rows)
        if not all(g["rows"] == want_rows for g in grid) or want_rows[0] == want_rows[1]:
            raise AssertionError(f"P4: rows {[g['rows'] for g in grid]} against {want_rows}")

        # P5: the command lines over two gloo ranks sharing the card
        cli_out = os.path.join(root, "outputs")
        steps_per_epoch = len(train_anns) // B
        train = ["-m", "spacap3d_tpu_torch.scripts.train", "--multihost", "--dist_backend",
                 backend, "--dist_timeout", str(PARALLEL_COLLECTIVE_S), "--device", DEV,
                 "--data_root", root, "--output_dir", cli_out, "--arch_preset", "full",
                 "--batch_size", str(B), "--epoch", "1", "--val_step", str(steps_per_epoch - 2),
                 "--verbose", "8", "--num_workers", "4", "--seed", "0", "--tag", "mh"]
        t0 = time.perf_counter()
        logs = run_ranks(train, ranks, "P5 train --multihost")
        train_s = time.perf_counter() - t0
        runs = os.listdir(cli_out)
        run_root = os.path.join(cli_out, runs[0])
        files = sorted(os.listdir(run_root))
        missing = [f for f in ("config.json", "info.json", "log.txt", "all_scalars.json",
                               "model_last.ckpt", "model.ckpt", "best.txt") if f not in files]
        with open(os.path.join(run_root, "log.txt")) as f:
            epoch_line = [ln for ln in f.read().splitlines() if "done |" in ln]
        ckpt = load_checkpoint(os.path.join(run_root, "model_last.ckpt"))
        ckpt["model_state_dict"]["proposal.proposal.6.bias"][1] += 2.0
        save_checkpoint_sync(os.path.join(run_root, "detects.ckpt"), ckpt)
        ev = ["--folder", runs[0], "--data_root", root, "--output_dir", cli_out,
              "--checkpoint", "detects.ckpt", "--min_iou", str(MUL_EVAL_GATE_IOU),
              "--mul_eval", "--num_seeds", str(PARALLEL_GRID_SEEDS), "--batch_size", str(B),
              "--num_workers", "4", "--device", DEV]
        t0 = time.perf_counter()
        ev_logs = run_ranks(["-m", "spacap3d_tpu_torch.scripts.eval", "--multihost",
                             "--dist_backend", backend, "--dist_timeout",
                             str(PARALLEL_COLLECTIVE_S), "--eval_tag", "mh", *ev], ranks,
                            "P5 eval --multihost --mul_eval")
        eval_s = time.perf_counter() - t0
        printed = [json.loads(ln) for ln in ev_logs[0].stdout.splitlines()
                   if ln.startswith('{"seed"')]
        t0 = time.perf_counter()
        one = eval_cli.main(["--eval_tag", "sp", *ev])
        with open(os.path.join(run_root, "mh_results.csv")) as f:
            mh_csv = f.read()
        with open(os.path.join(run_root, "sp_results.csv")) as f:
            sp_csv = f.read()
        quiet = all("iter" not in t.stdout and not any(
            ln.startswith('{"seed"') for ln in e.stdout.splitlines())
            for t, e in zip(logs[1:], ev_logs[1:]))
        log("parallel", leg="P5", runs=runs, files=files, missing=missing,
            epoch=epoch_line, train_wall_s=train_s, eval_wall_s=eval_s,
            one_process_eval_s=time.perf_counter() - t0, rows=printed,
            rows_equal=printed == one and mh_csv == sp_csv, other_ranks_silent=quiet)
        if (len(runs) != 1 or missing or printed != one or mh_csv != sp_csv or not quiet
                or printed[0] == printed[1]):
            raise AssertionError(f"P5: runs {runs}, missing {missing}, rows {printed} "
                                 f"against {one}, other ranks silent {quiet}")
    return launches


def device_info():
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if "--train-determinism" in sys.argv:
        train_determinism_worker()
        return 0
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
    log("build", seconds=time.perf_counter() - t0, ptxas=_build.ptxas_info())
    phase_host()
    if "--ranks" in sys.argv:
        ranks = int(sys.argv[sys.argv.index("--ranks") + 1])
        if torch.cuda.device_count() < ranks:
            raise SystemExit(f"--ranks {ranks} needs {ranks} cards, not "
                             f"{torch.cuda.device_count()}")
        launches = phase_parallel(smi, ranks, "nccl")
        print(json.dumps({"parallel_launches": launches}), flush=True)
        print(json.dumps({"ok": True, "device": device_info()}), flush=True)
        return 0

    per_shape = phase_kernels()
    per_shape.update(phase_decode_kernels())
    launches, wrapper_launches, forward_scenes_per_s = phase_eval_forward()
    phase_captured_eval()
    train_launches, train_summary = phase_train_step()
    phase_captured_train()
    phase_cpu_vs_gpu()
    phase_cpu_vs_gpu_train()
    mul_eval_launches = phase_mul_eval(forward_scenes_per_s)
    cli_launches = phase_cli()
    multiview_launches = phase_multiview(forward_scenes_per_s, train_summary)
    parallel_launches = phase_parallel(smi)

    meta = {
        "fps": ("spacap3d_tpu_torch/csrc/fps.cu", "spacap3d_tpu/ops/fps_pallas.py:35"),
        "ball_query": ("spacap3d_tpu_torch/csrc/ball_query.cu",
                       "spacap3d_tpu/ops/ball_query_pallas.py:50"),
        "generator_argmax": ("spacap3d_tpu_torch/csrc/decode.cu",
                             "spacap3d_tpu/ops/decode_pallas.py:57"),
        "ffn": ("spacap3d_tpu_torch/csrc/decode.cu", "spacap3d_tpu/ops/decode_pallas.py:127"),
        "ffn_partial": ("spacap3d_tpu_torch/csrc/decode.cu",
                        "spacap3d_tpu/ops/decode_pallas.py:127"),
    }
    # the partial-sum kernel's path is P3's fused TP eval forward (eager):
    # rank 0's count, set to 0 just before that forward and read just after
    launches["ffn_partial"] = parallel_launches["P3_tp_fused_eval"][0]["ffn_partial"]
    wrapper_launches["ffn_partial"] = launches["ffn_partial"]
    kernels = []
    for name, rows in per_shape.items():
        # per call, summed over the distinct shapes the main path gives it
        # (FPS and ball query launch once at each; the decode kernels 31 and
        # 192 times at one shape, ffn_partial 192 on each TP rank); ragged,
        # tie and tp-4 shapes are checks only
        main = [r for r in rows if r.get("main_path", True)]
        lib = [r.get("library_ms") for r in main]
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "wrapper_launches": wrapper_launches[name],
            "train_launches": train_launches[name],
            "multiview_launches": {run: per[name] for run, per in multiview_launches.items()},
            "mul_eval_launches": mul_eval_launches[name],
            "cli_launches": cli_launches[name],
            "parallel_launches": {leg: [c[name] for c in per]
                                  for leg, per in parallel_launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": max(main, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(lib),
            "per_shape": rows,
        })
        if name == "ball_query":   # the block and build of each main-path launch
            kernels[-1]["launch"] = [{k: r[k] for k in (
                "shape", "nsample", "warp_centres", "warps", "centres_per_block", "blocks",
                "tile_points", "shared_memory", "blocks_per_sm", "registers", "spill_stores",
                "spill_loads")} for r in main]
        if name == "fps":   # the split, block and build of each main-path launch
            kernels[-1]["launch"] = [{k: r[k] for k in (
                "shape", "npoint", "cluster", "threads", "points_per_thread", "shared_memory",
                "max_active_clusters", "registers", "spill_stores", "spill_loads",
                "us_per_step")} for r in main]
        if name in ("generator_argmax", "ffn", "ffn_partial"):   # main-path launch: split, build
            kernels[-1].update({k: main[0][k] for k in (
                "cluster", "stages", "dynamic_smem", "max_active_clusters", "ptxas")})
        if name == "generator_argmax":
            kernels[-1]["chunk"] = main[0]["chunk"]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

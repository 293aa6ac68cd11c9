"""Fused greedy-decode kernels: the generator's argmax and the FFN.

Contract (as ``spacap3d_tpu/ops/decode_pallas.py``), all operands bf16:

* ``generator_argmax(x, pack_generator(w, b))``: for each row of x (R, d),
  the first index j < vocab of the maximum of ``x . w[j] + b[j]``, with f32
  accumulation and the bias added in f32; the logits are never written.
* ``ffn(x, pack_ffn(w1, b1, w2, b2))``:
  ``bf16(bf16(relu(x @ w1^T + b1)) @ w2^T + b2)``, f32 accumulation, the
  (R, d_ff) hidden kept on chip.
* ``ffn_partial(x, pack_ffn(w1, b1, w2, b2))``, for tensor parallelism,
  where w1, b1 and w2 are one rank's d_ff slice:
  ``bf16(relu(x @ w1^T + b1)) @ w2^T`` in f32, without b2 and unrounded.
  The caller sums the ranks' partials, adds b2 and rounds once, as the
  unfused decode's row-parallel layer does.

Weights are given in the port's (out, in) layout. ``pack_generator`` and
``pack_ffn`` lay them out once per decode as the shared-memory image each
kernel reads (see their docstrings); the generator's padded columns are
never candidates. d and d_ff are multiples of 16 and d is at most 256, or
the wrappers raise.

The wrappers launch the CUDA kernels (``csrc/decode.cu``) for CUDA tensors
and take the plain versions for CPU tensors. The plain versions repeat the
captioner's unfused op sequence (f32 products of the bf16 operands, bias,
relu, rounding, ``torch.argmax`` on f32 logits), so on the CPU the fused
and unfused decodes give the same bits.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional

import torch

from spacap3d_tpu_torch.ops import _build

MAX_D = 256
# both kernels (csrc/decode.cu): 64 rows a block, d padded to a multiple of
# 64, 8 x 8 core matrices, at most 8 blocks (the portable cluster size) in
# the cluster that splits the weights; the generator cuts the vocab into
# 128-column chunks (namespace gen, kChunk), the FFN d_ff into 64-column ones
ROWS = 64
D_TILE = 64
CORE = 8
MAX_CLUSTER = 8
GEN_CHUNK = 128
FFN_CHUNK = 64


def generator_argmax_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           vocab: int) -> torch.Tensor:
    """(R, d), (>= vocab, d), (>= vocab,) -> (R,) int64: argmax of the f32
    logits of the first ``vocab`` columns, first maximum on ties."""
    logits = torch.matmul(x.float(), w[:vocab].float().t()) + b[:vocab].float()
    return torch.argmax(logits, dim=-1)


@dataclasses.dataclass(frozen=True)
class PackedGenerator:
    """The generator's weights as ``pack_generator`` lays them out, and as given."""

    image: torch.Tensor      # (chunks, stage bytes) uint8: the kernel's shared-memory image
    w: torch.Tensor          # (vocab, d) bf16, as given: the plain version's operands
    b: torch.Tensor          # (vocab,)

    @property
    def vocab(self) -> int:
        return self.w.shape[0]

    @property
    def d(self) -> int:
        return self.w.shape[1]

    @property
    def chunks(self) -> int:
        return self.image.shape[0]


def ffn_partial_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                      w2: torch.Tensor) -> torch.Tensor:
    """(R, d) -> (R, d) f32, the hidden rounded to x's dtype, no b2."""
    hid = torch.relu(torch.matmul(x.float(), w1.float().t()) + b1.float()).to(x.dtype)
    return torch.matmul(hid.float(), w2.float().t())


def ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """(R, d) -> (R, d) in x's dtype, the hidden rounded to x's dtype."""
    return (ffn_partial_plain(x, w1, b1, w2) + b2.float()).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class PackedFFN:
    """One FFN's weights as ``pack_ffn`` lays them out, and as given."""

    image: torch.Tensor      # (chunks, stage bytes) uint8: the kernel's shared-memory image
    b2_pad: torch.Tensor     # (d_pad,) f32, zero past d
    w1: torch.Tensor         # (d_ff, d) bf16, as given: the plain version's operands
    b1: torch.Tensor         # (d_ff,)
    w2: torch.Tensor         # (d, d_ff)
    b2: torch.Tensor         # (d,)

    @property
    def d(self) -> int:
        return self.w1.shape[1]

    @property
    def d_ff(self) -> int:
        return self.w1.shape[0]

    @property
    def chunks(self) -> int:
        return self.image.shape[0]


def _cores(m: torch.Tensor) -> torch.Tensor:
    """(..., rows, k) -> (..., rows / 8, k / 8, 8, 8): core matrix (i, j) holds
    rows 8i.. and columns 8j.., each core's 8 rows of 16 bytes contiguous."""
    *lead, rows, k = m.shape
    m = m.reshape(*lead, rows // CORE, CORE, k // CORE, CORE)
    return m.transpose(-3, -2)


def pack_generator(w: torch.Tensor, b: torch.Tensor) -> PackedGenerator:
    """Lays out the generator's bf16 weight w (vocab, d) and bias b (vocab,)
    as the generator kernel's shared-memory image; once per decode.

    d is zero-padded to d_pad (a multiple of 64) and the vocab to a
    multiple of 128; the kernel masks the padded columns by index. Chunk c of
    the image (one bulk copy) holds w rows [128c, 128c + 128) as a (128,
    d_pad) matrix, K-major without swizzle in 8 x 8 core matrices (as in
    ``pack_ffn``), then b[128c:128c + 128] in f32, which is exact. Runs on
    any device, in plain torch.
    """
    if w.dim() != 2:
        raise ValueError(f"pack_generator: w must be (vocab, d), got {tuple(w.shape)}")
    _check("pack_generator", (("w", w), ("b", b)), (tuple(w.shape), (w.shape[0],)))
    _check_width("pack_generator", w.shape[1])
    v, d = w.shape
    if v <= 0:
        raise ValueError("pack_generator: the vocab is empty")
    dp, vp = d + (-d % D_TILE), v + (-v % GEN_CHUNK)
    chunks = vp // GEN_CHUNK
    wp = w.new_zeros((vp, dp))
    wp[:v, :d] = w
    bp = torch.zeros((vp,), dtype=torch.float32, device=b.device)
    bp[:v] = b.float()
    wc = _cores(wp.reshape(chunks, GEN_CHUNK, dp))
    image = torch.cat([wc.reshape(chunks, -1).view(torch.uint8),
                       bp.reshape(chunks, GEN_CHUNK).view(torch.uint8)], dim=1)
    return PackedGenerator(image.contiguous(), w.contiguous(), b.contiguous())


def pack_ffn(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor) -> PackedFFN:
    """Lays out one FFN's bf16 weights, w1 (d_ff, d), b1 (d_ff,), w2 (d, d_ff)
    and b2 (d,), as the FFN kernel's shared-memory image; once per decode.

    d is zero-padded to d_pad (a multiple of 64) and d_ff to a multiple of
    64; a zero row of w1 with a zero b1 gives relu(0) = 0, which adds nothing.
    Chunk c of the image (one bulk copy) holds, in order:

    * w1 rows [64c, 64c + 64) as a (64, d_pad) matrix,
    * w2 columns [64c, 64c + 64) as a (d_pad, 64) matrix,
    * b1[64c:64c + 64] in f32.

    Each matrix is K-major without swizzle (K: d for w1, d_ff for w2), cut
    into 8 x 8 core matrices of 128 contiguous bytes, core (i, j) at byte
    128 (i K / 8 + j): the layout the kernel's wgmma descriptors name.
    b1 and b2 go to f32, which is exact. Runs on any device, in plain torch.
    """
    if w1.dim() != 2:
        raise ValueError(f"pack_ffn: w1 must be (d_ff, d), got {tuple(w1.shape)}")
    f, d = w1.shape
    _check("pack_ffn", (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)),
           ((f, d), (f,), (d, f), (d,)))
    _check_width("pack_ffn", d)
    if f % 16 or f <= 0:
        raise ValueError(f"pack_ffn: d_ff = {f} must be a positive multiple of 16")
    dp, fp = d + (-d % D_TILE), f + (-f % FFN_CHUNK)
    chunks = fp // FFN_CHUNK
    w1p = w1.new_zeros((fp, dp))
    w1p[:f, :d] = w1
    w2p = w2.new_zeros((dp, fp))
    w2p[:d, :f] = w2
    b1p = torch.zeros((fp,), dtype=torch.float32, device=b1.device)
    b1p[:f] = b1.float()
    b2p = torch.zeros((dp,), dtype=torch.float32, device=b2.device)
    b2p[:d] = b2.float()
    w1c = _cores(w1p.reshape(chunks, FFN_CHUNK, dp))
    w2c = _cores(w2p.reshape(dp, chunks, FFN_CHUNK).transpose(0, 1))
    image = torch.cat([w1c.reshape(chunks, -1).view(torch.uint8),
                       w2c.reshape(chunks, -1).view(torch.uint8),
                       b1p.reshape(chunks, FFN_CHUNK).view(torch.uint8)], dim=1)
    return PackedFFN(image.contiguous(), b2p, *(t.contiguous() for t in (w1, b1, w2, b2)))


def one_wave_cluster(r: int, chunks: int, resident: Callable[[int], int]) -> int:
    """Blocks that split the weights (S), for either kernel: the largest
    S <= 8, and no more than the chunks, whose ceil(r / 64) clusters of S
    blocks the device holds all at once (``resident(S)``: co-resident
    clusters), so the grid is one wave; 1 where no S >= 2 fits in one
    wave."""
    tiles = -(-r // ROWS)
    for s in range(min(MAX_CLUSTER, chunks), 1, -1):
        if resident(s) >= tiles:
            return s
    return 1


@functools.lru_cache(maxsize=None)
def ffn_launch_info(device_index: int, d: int, chunks: int, cluster: int,
                    partial: bool = False) -> dict:
    """The FFN kernel's launch (``partial``: ``ffn_partial``'s) on CUDA
    device ``device_index``: ring stages, dynamic shared memory (bytes) and
    co-resident clusters."""
    out = [ctypes.c_int() for _ in range(3)]
    lib = _build.library()
    info = lib.spacap_ffn_partial_launch_info if partial else lib.spacap_ffn_launch_info
    with torch.cuda.device(device_index):
        err = info(d, chunks, cluster, *map(ctypes.byref, out))
    _build.check(err, "ffn launch info")
    return dict(zip(("stages", "dynamic_smem", "max_active_clusters"), (o.value for o in out)))


@functools.lru_cache(maxsize=None)
def ffn_default_cluster(device_index: int, r: int, d: int, chunks: int,
                        partial: bool = False) -> int:
    """The S that ``ffn`` (``partial``: ``ffn_partial``) takes by default
    for R = r on that device."""
    return one_wave_cluster(r, chunks, lambda s: ffn_launch_info(
        device_index, d, chunks, s, partial)["max_active_clusters"])


@functools.lru_cache(maxsize=None)
def generator_launch_info(device_index: int, d: int, vocab: int, cluster: int) -> dict:
    """The generator kernel's launch on CUDA device ``device_index``: ring
    stages, dynamic shared memory (bytes) and co-resident clusters."""
    out = [ctypes.c_int() for _ in range(3)]
    chunks = -(-vocab // GEN_CHUNK)
    with torch.cuda.device(device_index):
        err = _build.library().spacap_generator_launch_info(d, vocab, chunks, cluster,
                                                            *map(ctypes.byref, out))
    _build.check(err, "generator launch info")
    return dict(zip(("stages", "dynamic_smem", "max_active_clusters"), (o.value for o in out)))


@functools.lru_cache(maxsize=None)
def generator_default_cluster(device_index: int, r: int, d: int, vocab: int) -> int:
    """The S that ``generator_argmax`` takes by default for R = r on that device."""
    return one_wave_cluster(r, -(-vocab // GEN_CHUNK), lambda s: generator_launch_info(
        device_index, d, vocab, s)["max_active_clusters"])


def _check(name: str, named, shapes) -> torch.device:
    """Dtype, shape and device checks of (arg name, tensor) pairs."""
    dev = named[0][1].device
    for (arg, t), shape in zip(named, shapes):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {arg} must be bfloat16, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, {named[0][0]} on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, want {shape}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _check_cuda(name: str, named) -> None:
    """The kernels read matrices as 16-byte vectors and 32-byte fragments."""
    for arg, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.dim() == 2 and t.data_ptr() % 32:
            raise ValueError(f"{name}: {arg} must be 32-byte aligned")


def _check_width(name: str, d: int) -> None:
    if d % 16 or not 0 < d <= MAX_D:
        raise ValueError(f"{name}: d = {d} must be a multiple of 16 and at most {MAX_D}")


def _cluster(name: str, cluster: Optional[int], default: Callable[[], int]) -> int:
    if cluster is None:
        return default()
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"{name}: cluster = {cluster} must be in [1, {MAX_CLUSTER}]")
    return cluster


def generator_argmax(x: torch.Tensor, packed: PackedGenerator, *,
                     cluster: Optional[int] = None) -> torch.Tensor:
    """x (R, d) bf16, ``packed = pack_generator(w, b)`` on x's device ->
    (R,) int64 indices below ``packed.vocab``. ``cluster`` (1-8) sets how
    many blocks split the vocab; by default ``generator_default_cluster``
    picks it from R and the device."""
    if x.dim() != 2:
        raise ValueError(f"generator_argmax: x must be (R, d), got {tuple(x.shape)}")
    r, d = x.shape
    dev = _check("generator_argmax", (("x", x), ("packed.w", packed.w)),
                 ((r, packed.d), (packed.vocab, packed.d)))
    if dev.type == "cpu":
        return generator_argmax_plain(x, packed.w, packed.b, packed.vocab)
    _check_cuda("generator_argmax", (("x", x),))
    cluster = _cluster("generator_argmax", cluster, lambda: generator_default_cluster(
        dev.index, r, d, packed.vocab))
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((r,), dtype=torch.long, device=dev)
        err = lib.spacap_generator_argmax(
            x.data_ptr(), packed.image.data_ptr(), r, d, packed.vocab, packed.chunks, cluster,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "generator_argmax")
    generator_argmax.launches += 1
    return out


def _ffn_args(name: str, x: torch.Tensor, packed: PackedFFN) -> torch.device:
    """Both FFN wrappers' checks; returns the device."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (R, d), got {tuple(x.shape)}")
    dev = _check(name, (("x", x), ("packed.w1", packed.w1)),
                 ((x.shape[0], packed.d), (packed.d_ff, packed.d)))
    _check_width(name, packed.d)
    return dev


def ffn(x: torch.Tensor, packed: PackedFFN, *, cluster: Optional[int] = None) -> torch.Tensor:
    """x (R, d) bf16, ``packed = pack_ffn(w1, b1, w2, b2)`` on x's device ->
    (R, d) bf16. ``cluster`` (1-8) sets how many blocks split d_ff; by
    default ``ffn_default_cluster`` picks it from R and the device."""
    dev = _ffn_args("ffn", x, packed)
    if dev.type == "cpu":
        return ffn_plain(x, packed.w1, packed.b1, packed.w2, packed.b2)
    _check_cuda("ffn", (("x", x),))
    r, d = x.shape
    cluster = _cluster("ffn", cluster, lambda: ffn_default_cluster(dev.index, r, d, packed.chunks))
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((r, d), dtype=torch.bfloat16, device=dev)
        err = lib.spacap_ffn(x.data_ptr(), packed.image.data_ptr(), packed.b2_pad.data_ptr(), r, d,
                             packed.chunks, cluster, out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn")
    ffn.launches += 1
    return out


def ffn_partial(x: torch.Tensor, packed: PackedFFN, *,
                cluster: Optional[int] = None) -> torch.Tensor:
    """x (R, d) bf16, ``packed = pack_ffn(w1, b1, w2, b2)`` of one rank's d_ff
    slice on x's device -> (R, d) f32: the slice's partial sum, without b2
    and unrounded (``packed.b2`` is not read). ``cluster`` (1-8) sets how
    many blocks split the slice; by default ``ffn_default_cluster`` picks
    it from R and the device."""
    dev = _ffn_args("ffn_partial", x, packed)
    if dev.type == "cpu":
        return ffn_partial_plain(x, packed.w1, packed.b1, packed.w2)
    _check_cuda("ffn_partial", (("x", x),))
    r, d = x.shape
    cluster = _cluster("ffn_partial", cluster, lambda: ffn_default_cluster(
        dev.index, r, d, packed.chunks, True))
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((r, d), dtype=torch.float32, device=dev)
        err = lib.spacap_ffn_partial(x.data_ptr(), packed.image.data_ptr(), r, d, packed.chunks,
                                     cluster, out.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn_partial")
    ffn_partial.launches += 1
    return out


generator_argmax.launches = 0
ffn.launches = 0
ffn_partial.launches = 0

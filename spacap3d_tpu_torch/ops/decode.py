"""Fused greedy-decode kernels: the generator's argmax and the FFN.

Contract (as ``spacap3d_tpu/ops/decode_pallas.py``), all operands bf16:

* ``generator_argmax(x, w, b, vocab)``: for each row of x (R, d), the first
  index j < vocab of the maximum of ``x . w[j] + b[j]``, with f32
  accumulation and the bias added in f32; the logits are never written.
* ``ffn(x, w1, b1, w2, b2)``: ``bf16(bf16(relu(x @ w1^T + b1)) @ w2^T + b2)``,
  f32 accumulation, the (R, d_ff) hidden kept on chip.

Weights keep the port's (out, in) layout. The generator's rows are padded
to a multiple of 16 (``pad_generator``), the kernel's column fragment; the
padded columns are never candidates. d and d_ff are multiples of 16 and
d is at most 256, or the wrappers raise.

The wrappers launch the CUDA kernels (``csrc/decode.cu``) for CUDA tensors
and take the plain versions for CPU tensors. The plain versions repeat the
captioner's unfused op sequence (f32 products of the bf16 operands, bias,
relu, rounding, ``torch.argmax`` on f32 logits), so on the CPU the fused
and unfused decodes give the same bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

from spacap3d_tpu_torch.ops import _build

COL_MULTIPLE = 16
MAX_D = 256


def pad_generator(w: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pads the generator's (vocab, d) weight and (vocab,) bias to a
    multiple of 16 rows, contiguous. Padded rows are masked by index."""
    pad = -w.shape[0] % COL_MULTIPLE
    if pad:
        w = torch.cat([w, w.new_zeros((pad, w.shape[1]))])
        b = torch.cat([b, b.new_zeros((pad,))])
    return w.contiguous(), b.contiguous()


def generator_argmax_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           vocab: int) -> torch.Tensor:
    """(R, d), (>= vocab, d), (>= vocab,) -> (R,) int64: argmax of the f32
    logits of the first ``vocab`` columns, first maximum on ties."""
    logits = torch.matmul(x.float(), w[:vocab].float().t()) + b[:vocab].float()
    return torch.argmax(logits, dim=-1)


def ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """(R, d) -> (R, d) in x's dtype, the hidden rounded to x's dtype."""
    hid = torch.relu(torch.matmul(x.float(), w1.float().t()) + b1.float()).to(x.dtype)
    return (torch.matmul(hid.float(), w2.float().t()) + b2.float()).to(x.dtype)


def _check(name: str, named, shapes) -> torch.device:
    """Dtype, shape and device checks of (arg name, tensor) pairs."""
    dev = named[0][1].device
    for (arg, t), shape in zip(named, shapes):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {arg} must be bfloat16, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {dev}")
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


def generator_argmax(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """x (R, d), w (V, d) and b (V,) bf16 with V = vocab rounded up to 16
    (``pad_generator``) -> (R,) int64 indices below ``vocab``."""
    if x.dim() != 2:
        raise ValueError(f"generator_argmax: x must be (R, d), got {tuple(x.shape)}")
    r, d = x.shape
    v = vocab + (-vocab % COL_MULTIPLE)
    named = (("x", x), ("w", w), ("b", b))
    dev = _check("generator_argmax", named, ((r, d), (v, d), (v,)))
    _check_width("generator_argmax", d)
    if dev.type == "cpu":
        return generator_argmax_plain(x, w, b, vocab)
    _check_cuda("generator_argmax", named)
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((r,), dtype=torch.long, device=dev)
        err = lib.spacap_generator_argmax(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), r, d, vocab, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "generator_argmax")
    generator_argmax.launches += 1
    return out


def ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
        b2: torch.Tensor) -> torch.Tensor:
    """x (R, d), w1 (F, d), b1 (F,), w2 (d, F), b2 (d,) bf16 -> (R, d) bf16."""
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError("ffn: x and w1 must be 2-D")
    r, d = x.shape
    f = w1.shape[0]
    named = (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))
    dev = _check("ffn", named, ((r, d), (f, d), (f,), (d, f), (d,)))
    _check_width("ffn", d)
    if f % 16 or f <= 0:
        raise ValueError(f"ffn: d_ff = {f} must be a positive multiple of 16")
    if dev.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2)
    _check_cuda("ffn", named)
    lib = _build.library()
    with torch.cuda.device(dev):
        out = torch.empty((r, d), dtype=torch.bfloat16, device=dev)
        err = lib.spacap_ffn(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            r, d, f, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ffn")
    ffn.launches += 1
    return out


generator_argmax.launches = 0
ffn.launches = 0

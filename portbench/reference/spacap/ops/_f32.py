"""float32 fused multiply-add for the kernels' plain versions.

The JAX oracles compile their three-term sums to FMA chains on the CPU,
and the CUDA kernels use the same chains (``__fmaf_rn``). PyTorch has no
float32 FMA, so it is computed in float64: the product of two float32
values is exact there, and the sum is rounded once more to float32.
"""
from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def dot3(ax, ay, az, bx, by, bz) -> torch.Tensor:
    """fma(az, bz, fma(ay, by, ax * bx)) in float32."""
    return fma(az, bz, fma(ay, by, ax * bx))

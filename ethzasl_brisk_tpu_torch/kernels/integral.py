"""Integral images (port of ``kernels/integral.py``).

``integral_image_i32`` is the exact 8-bit integral. The float integrals
of the 16-bit pipeline (``integral_image_f32``, ``integral_image_16_f32``,
mirroring ``IntegralImage16``, integral-image.h:163-218) accumulate in
float32, so their value depends on the order of the adds. The JAX package
computes them with ``jnp.cumsum``, which XLA:CPU compiles to a blocked
scan (a cumulative ``reduce_window`` split by its rewriter into blocks of
16): sequential prefix sums inside each block of 16, the block totals
scanned the same way (recursively), and each block's exclusive total
added once. ``_blocked_cumsum`` performs exactly those float32 adds, one
torch op per step, so the result is bit-identical to the JAX package on
the CPU and the same on the card and the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BLOCK = 16  # the base length of XLA's cumulative reduce_window rewrite


def integral_image_i32(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W) -> int32 (..., H+1, W+1) exclusive integral image.

    ``I[y, x] = sum(img[:y, :x])``; first row and column zero. Exact in
    int32 up to 8.4M pixels (255 * H * W < 2^31).
    """
    s = img.to(torch.int32).cumsum(-2, dtype=torch.int32).cumsum(-1, dtype=torch.int32)
    return F.pad(s, (1, 0, 1, 0))


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, one add at a time, left
    to right."""
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k] = out[..., k - 1] + x[..., k]
    return out


def _blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float prefix sums along the last axis in XLA:CPU's order
    (see the module docstring)."""
    n = x.shape[-1]
    if n <= _BLOCK:
        return _sequential_cumsum(x)
    m = -(-n // _BLOCK)
    blocks = F.pad(x, (0, m * _BLOCK - n)).reshape(*x.shape[:-1], m, _BLOCK)
    inner = _sequential_cumsum(blocks)
    totals = _blocked_cumsum(inner[..., -1])
    before = F.pad(totals[..., :-1], (1, 0))  # each block's exclusive total
    return (inner + before[..., None]).reshape(*x.shape[:-1], m * _BLOCK)[..., :n]


def _float_integral(x: torch.Tensor) -> torch.Tensor:
    s = _blocked_cumsum(_blocked_cumsum(x.transpose(-1, -2)).transpose(-1, -2))
    return F.pad(s, (1, 0, 1, 0))


def integral_image_f32(img: torch.Tensor) -> torch.Tensor:
    """uint16/float (..., H, W) -> float32 (..., H+1, W+1) integral image,
    bit-identical to the JAX package's ``integral_image_f32``."""
    return _float_integral(img.to(torch.float32))


def integral_image_16_f32(img: torch.Tensor) -> torch.Tensor:
    """uint16 (..., H, W) -> float32 (..., H+1, W+1) integral of img/65536
    (the scaling is exact), bit-identical to the JAX package's
    ``integral_image_16_f32``."""
    return _float_integral(img.to(torch.float32) * (1.0 / 65536.0))

"""Generic 2-D filters: box 3x3, Gaussian 3x3, any odd kernel (port of
``kernels/filters.py``).

Mirrors the reference's SSE ``Filter2D``/``FilterBox3by316S``/
``FilterGauss3by316S``/``FilterGauss3by332F``
(``brisk/include/brisk/internal/vectorized-filters.h:53-74``): small
fixed-kernel stencils over 8U/16S/32F images, zero border. Plain torch
ops on (H, W) tensors, the taps summed in the JAX function's order; the
integer variants keep the reference's ``>>`` shifts. The JAX package runs
them in XLA and no path of either package calls them.
"""
from __future__ import annotations

import numpy as np
import torch

from ethzasl_brisk_tpu_torch.detect.ast_layer import _shift


def _inside(h: int, w: int, bh: int, bw: int, device) -> torch.Tensor:
    inb = torch.zeros((h, w), dtype=torch.bool, device=device)
    inb[bh : h - bh, bw : w - bw] = True
    return inb


def filter2d(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Correlate with an odd-sized kernel, zero border (Filter2D), 0 within
    half the kernel of the edge. The result type is the JAX package's: the
    promotion of the image's and the kernel's types, a 64-bit kernel taken
    as 32-bit (JAX without x64)."""
    kh, kw = kernel.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"filter2d takes an odd-sized kernel, got {kernel.shape}")
    k32 = np.asarray(kernel)
    if k32.dtype.itemsize == 8:
        k32 = k32.astype(k32.dtype.kind + "4" if k32.dtype.kind in "fi" else k32.dtype)
    coef = torch.from_numpy(np.ascontiguousarray(k32)).to(img.device)
    dtype = torch.promote_types(img.dtype, coef.dtype)
    acc = None
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j] == 0:
                continue
            term = coef[i, j].to(dtype) * _shift(img, i - kh // 2, j - kw // 2).to(dtype)
            acc = term if acc is None else acc + term
    h, w = img.shape
    return torch.where(_inside(h, w, kh // 2, kw // 2, img.device), acc, 0)


def _gauss_sum(p: torch.Tensor) -> torch.Tensor:
    return (
        4 * p
        + 2 * (_shift(p, -1, 0) + _shift(p, 1, 0) + _shift(p, 0, -1) + _shift(p, 0, 1))
        + _shift(p, -1, -1) + _shift(p, -1, 1) + _shift(p, 1, -1) + _shift(p, 1, 1)
    )


def _border_zero(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape
    return torch.where(_inside(h, w, 1, 1, x.device), x, 0)


def filter_box_3x3_i16(img: torch.Tensor) -> torch.Tensor:
    """3x3 box sum on int16, kept raw (16S out; the sum wraps to int16)."""
    p = img.to(torch.int32)
    s = sum(_shift(p, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return _border_zero(s).to(torch.int16)


def filter_gauss_3x3_i16(img: torch.Tensor) -> torch.Tensor:
    """[[1,2,1],[2,4,2],[1,2,1]] >> 4 on int16 (FilterGauss3by316S)."""
    return _border_zero(_gauss_sum(img.to(torch.int32)) >> 4).to(torch.int16)


def filter_gauss_3x3_f32(img: torch.Tensor) -> torch.Tensor:
    """[[1,2,1],[2,4,2],[1,2,1]] / 16 on float32 (FilterGauss3by332F)."""
    p = img.to(torch.float32)
    s = (
        4.0 * p
        + 2.0 * (_shift(p, -1, 0) + _shift(p, 1, 0) + _shift(p, 0, -1) + _shift(p, 0, 1))
        + _shift(p, -1, -1) + _shift(p, -1, 1) + _shift(p, 1, -1) + _shift(p, 1, 1)
    ) / 16.0
    return _border_zero(s)

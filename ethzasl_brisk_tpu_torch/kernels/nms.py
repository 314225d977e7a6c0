"""Dense 2-D non-maximum suppression (port of ``kernels/nms.py``).

A pixel on rows/cols [border, n-1-border] is a maximum if
score >= threshold and no 8-neighbour exceeds it; ties survive
(HarrisScoreCalculator::Get2dMaxima, harris-score-calculator.cc:57-106).

The 3-D checks' shared pieces live here too, for the integer masks
(``kernels/masks.py``) and the float ones (``detect/scale_space.py``):
the zero-filled 3x3 maximum and the bilinear taps of a neighbour layer.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def maxima2d_mask(
    score: torch.Tensor, absolute_threshold: "int | float", border: int = 2
) -> torch.Tensor:
    """(..., H, W) int32 or float32 scores -> bool mask of 2-D maxima
    (outside the map reads the dtype's least value: INT32_MIN or -inf)."""
    h, w = score.shape[-2:]
    low = (float("-inf") if score.dtype.is_floating_point
           else torch.iinfo(score.dtype).min)
    p = F.pad(score, (1, 1, 1, 1), value=low)
    neigh = None
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            s = p[..., dy : dy + h, dx : dx + w]
            neigh = s if neigh is None else torch.maximum(neigh, s)
    mask = (score >= absolute_threshold) & (neigh <= score)
    inb = torch.zeros((h, w), dtype=torch.bool, device=score.device)
    inb[border : h - border, border : w - border] = True
    return mask & inb


def max3x3_zero_fill(x: torch.Tensor) -> torch.Tensor:
    """3x3 neighbourhood maximum, reading 0 outside the image (integer or
    float: the JAX package's ``_max3x3_pair`` and ``_max3x3_f32``)."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1), value=0)
    out = x
    for dy in range(3):
        for dx in range(3):
            out = torch.maximum(out, p[..., dy : dy + h, dx : dx + w])
    return out


def axis_terms(n: int, limit: int, a: int, b: int, d: int):
    """C-truncated source indices, fraction numerators and validity of the
    map (a*u + b) / d over u in [0, n) (exact integer math)."""
    val = a * np.arange(n, dtype=np.int64) + b
    i0 = np.where(val >= 0, val // d, -((-val) // d))
    frac = val - i0 * d
    ok = (i0 + 1 < limit) & (i0 >= 0)
    return i0, frac, ok


def warp_taps(src: torch.Tensor, affine: tuple[int, int, int], dst_shape: tuple[int, int]):
    """The bilinear taps of the map (A*u + B) / D into ``src``: its four
    samples (p00, p01, p10, p11) at every destination pixel, the fraction
    numerators (fu over columns, fv over rows, host int64) and where the
    reference's bilinear is defined (harris-score-calculator.h:57-74:
    truncated u_int, zero if u_int+1 >= cols, v_int+1 >= rows or either is
    negative; u in (-1, 0) truncates to 0 and extrapolates)."""
    a, b, d = affine
    rows, cols = src.shape[-2:]
    h, w = dst_shape
    dev = src.device
    u0, fu, oku = axis_terms(w, cols, a, b, d)
    v0, fv, okv = axis_terms(h, rows, a, b, d)

    def idx(i):
        return torch.as_tensor(np.clip(i, 0, None), device=dev)

    r0 = src.index_select(-2, idx(np.minimum(v0, rows - 1)))
    r1 = src.index_select(-2, idx(np.minimum(v0 + 1, rows - 1)))
    cu0 = idx(np.minimum(u0, cols - 1))
    cu1 = idx(np.minimum(u0 + 1, cols - 1))
    taps = (r0.index_select(-1, cu0), r0.index_select(-1, cu1),
            r1.index_select(-1, cu0), r1.index_select(-1, cu1))
    valid = torch.as_tensor(okv[:, None] & oku[None, :], device=dev)
    return taps, fu, fv, valid

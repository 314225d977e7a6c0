"""Integral images (port of ``kernels/integral.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def integral_image_i32(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W) -> int32 (..., H+1, W+1) exclusive integral image.

    ``I[y, x] = sum(img[:y, :x])``; first row and column zero. Exact in
    int32 up to 8.4M pixels (255 * H * W < 2^31).
    """
    s = img.to(torch.int32).cumsum(-2, dtype=torch.int32).cumsum(-1, dtype=torch.int32)
    return F.pad(s, (1, 0, 1, 0))

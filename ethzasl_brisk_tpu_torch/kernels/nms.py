"""Dense 2-D non-maximum suppression (port of ``kernels/nms.py``).

A pixel on rows/cols [border, n-1-border] is a maximum if
score >= threshold and no 8-neighbour exceeds it; ties survive
(HarrisScoreCalculator::Get2dMaxima, harris-score-calculator.cc:57-106).
"""
from __future__ import annotations

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

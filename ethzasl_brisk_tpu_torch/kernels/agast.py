"""Dense AGAST/OAST corner-score maps (port of ``kernels/agast.py``).

The reference scores corners with decision trees and a per-corner
bisection over the threshold (``agast/src/oast9-16.cc``,
``oast9-16-nms.cc:36-90``, ``agast5-8-nms.cc``). The bisection returns the
largest t in [b, 254] that passes "all of >= N contiguous circle pixels
brighter than p + t or darker than p - t", which is ``max(b, t*)`` with

    t* = max over arcs A of max( min_A(c) - p - 1,  p - max_A(c) - 1 ).

Here every pixel's t* is computed at once: the image shifted by each circle
offset, running arc minima and maxima by log-depth pairwise reductions
along the circle (``vals_run``), no branching. Works on ``(B, H, W)`` uint8
batches (any leading axes); int16 internals, int32 results, -1 on the
border where the circle leaves the image.

Circles: OAST 9/16 (radius-3 Bresenham circle, 16 offsets, arcs of 9;
``oast9-16.h:99-116``), AGAST 5/8 (radius-1 ring, arcs of 5;
``agast5-8.h:66-75``), AGAST 7/12s and 7/12d (square and diamond rings of
12, arcs of 7; ``agast7-12s.h:70-82``, ``agast7-12d.h:70-82``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# (dx, dy) circle offsets, in the reference's index order.
OAST_9_16_OFFSETS = (
    (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3), (2, -2),
    (3, -1), (3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2),
    (-3, 1),
)
AGAST_5_8_OFFSETS = (
    (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1),
)
AGAST_7_12S_OFFSETS = (
    (-2, 0), (-2, -1), (-1, -2), (0, -2), (1, -2), (2, -1), (2, 0),
    (2, 1), (1, 2), (0, 2), (-1, 2), (-2, 1),
)
AGAST_7_12D_OFFSETS = (
    (-3, 0), (-2, -1), (-1, -2), (0, -3), (1, -2), (2, -1), (3, 0),
    (2, 1), (1, 2), (0, 3), (-1, 2), (-2, 1),
)


def _shifted_stack(img: torch.Tensor, offsets, border: int) -> torch.Tensor:
    """(K, ..., H, W) stack with stack[k][..., y, x] = img[..., y + dy_k,
    x + dx_k], zero outside the image (only pixels whose whole circle lies
    inside are used)."""
    h, w = img.shape[-2:]
    p = F.pad(img, (border, border, border, border))
    return torch.stack(
        [p[..., border + dy : border + dy + h, border + dx : border + dx + w]
         for dx, dy in offsets]
    )


def vals_run(vals: torch.Tensor, run: int, op) -> torch.Tensor:
    """``op``-reduction over runs of ``run`` consecutive circular entries
    along axis 0: out[k] = op(vals[k], ..., vals[k + run - 1])."""
    out = vals
    length = 1
    while length < run:
        step = min(length, run - length)
        # out covers [k, k+length); extend it by a step-run from k+length.
        ext = vals_run(vals, step, op) if step != length else out
        out = op(out, torch.roll(ext, -length, dims=0))
        length += step
    return out


def _score_map(img: torch.Tensor, offsets, arc: int, border: int) -> torch.Tensor:
    # Pixels are <= 255 and the bright/dark margins lie in [-256, 255]: every
    # min, max and subtraction is exact in int16.
    p = img.to(torch.int16)
    c = _shifted_stack(p, offsets, border)
    arc_min = vals_run(c, arc, torch.minimum)
    arc_max = vals_run(c, arc, torch.maximum)
    bright = arc_min.amax(dim=0) - p - 1
    dark = p - arc_max.amin(dim=0) - 1
    t_star = torch.maximum(bright, dark).to(torch.int32)
    h, w = img.shape[-2:]
    inb = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    inb[border : h - border, border : w - border] = True
    return torch.where(inb, t_star, torch.full_like(t_star, -1))


def oast9_16_score_map(img: torch.Tensor) -> torch.Tensor:
    """t* map of OAST 9/16, int32, -1 on the 3-px border. ``cornerScore``
    with threshold b is ``max(b, map)`` (oast9-16-nms.cc:36-90)."""
    return _score_map(img, OAST_9_16_OFFSETS, 9, 3)


def agast5_8_score_map(img: torch.Tensor) -> torch.Tensor:
    """t* map of AGAST 5/8, int32, -1 on the 2-px border."""
    return _score_map(img, AGAST_5_8_OFFSETS, 5, 2)


def agast7_12s_score_map(img: torch.Tensor) -> torch.Tensor:
    """t* map of AGAST 7/12s, int32, -1 on the 2-px border."""
    return _score_map(img, AGAST_7_12S_OFFSETS, 7, 2)


def agast7_12d_score_map(img: torch.Tensor) -> torch.Tensor:
    """t* map of AGAST 7/12d, int32, -1 on the 3-px border."""
    return _score_map(img, AGAST_7_12D_OFFSETS, 7, 3)

"""Dense BriskLayer maps: threshold map, OAST corners, score cache (port of
``detect/ast_layer.py``).

Mirrors ``brisk/src/brisk-layer.cc`` on whole batches ``(B, H, W)``:

* ``threshold_map``: local contrast max - min over the center, the four
  5x5 corners and 3x3 max/min blocks at the four 5x5 edge midpoints
  (``CalculateThresholdMap``, brisk-layer.cc:278-598); valid on [3, n-4],
  0 elsewhere;
* the corner mask: OAST 9/16 with the per-pixel threshold modulation
  (oast9-16.cc:86-96): skip where thrmap < b*lower/100, else a corner iff
  t* >= clamp(thrmap, lower, upper)*b/100;
* the score cache (brisk-layer.cc:99-132): ``max(t*, thrmap)`` at corners
  (the reference seeds it with ``cornerScore`` at the unclamped threshold
  map value), ``max(t*, 0)`` elsewhere (every other query uses
  threshold 1);
* the v1 engine's layer: a constant threshold, no threshold map.
"""
from __future__ import annotations

import dataclasses

import torch

from ethzasl_brisk_tpu_torch.kernels.agast import oast9_16_score_map


def _shift(x: torch.Tensor, dy: int, dx: int, fill=0) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], ``fill`` outside."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(-dy, 0) : h + min(-dy, 0), max(-dx, 0) : w + min(-dx, 0)] = \
        x[..., max(dy, 0) : h + min(dy, 0), max(dx, 0) : w + min(dx, 0)]
    return out


def _region(h: int, w: int, border: int, device) -> torch.Tensor:
    inb = torch.zeros((h, w), dtype=torch.bool, device=device)
    inb[border : h - border, border : w - border] = True
    return inb


def threshold_map(img: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W) -> int32 threshold map (CalculateThresholdMap).
    int16 internals: values <= 255 and max - min <= 255 are exact."""
    p = img.to(torch.int16)
    h, w = img.shape[-2:]
    n3 = [_shift(p, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    max3 = n3[0]
    min3 = n3[0]
    for v in n3[1:]:
        max3 = torch.maximum(max3, v)
        min3 = torch.minimum(min3, v)
    corners = [_shift(p, -2, -2), _shift(p, -2, 2), _shift(p, 2, 2), _shift(p, 2, -2)]
    edges = ((-2, 0), (2, 0), (0, -2), (0, 2))
    cands_max = corners + [_shift(max3, dy, dx) for dy, dx in edges]
    cands_min = corners + [_shift(min3, dy, dx) for dy, dx in edges]
    mx = p
    mn = p
    for a, b in zip(cands_max, cands_min):
        mx = torch.maximum(mx, a)
        mn = torch.minimum(mn, b)
    valid = _region(h, w, 3, img.device)
    return torch.where(valid, (mx - mn).to(torch.int32), 0)


@dataclasses.dataclass(frozen=True)
class AstLayerMaps:
    """Every dense map of one pyramid layer the AST path needs, each
    (B, h, w)."""

    img: torch.Tensor     # uint8
    t_star: torch.Tensor  # int32 OAST 9/16 closed-form score (-1 border)
    thrmap: torch.Tensor  # int32
    corner: torch.Tensor  # bool detected-corner mask
    cache: torch.Tensor   # int32 effective score cache (threshold-1 view)
    scale: float
    offset: float

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.img.shape[-2:])


def build_ast_layer(
    img: torch.Tensor,
    threshold: int,
    upper: int = 230,
    lower: int = 10,
    scale: float = 1.0,
    offset: float = 0.0,
    v1: bool = False,
) -> AstLayerMaps:
    """The dense BriskLayer maps of a uint8 (B, h, w) layer.

    ``v1=True`` is the legacy engine (brisk-v1.cc:1684-1707): no adaptive
    threshold map, so detection is plain OAST 9/16 at ``threshold`` (its
    ``getAgastPoints`` sets the detector's threshold directly), and the
    score seeds are ``cornerScore`` at that threshold, which is t* at
    every detected corner."""
    t_star = oast9_16_score_map(img)
    h, w = img.shape[-2:]
    # detect() visits y in [3, rows-4] and x in [3, cols-4] (oast9-16.cc:50-84).
    detect_region = _region(h, w, 3, img.device)
    if v1:
        thr = torch.full(t_star.shape, int(threshold), dtype=torch.int32, device=img.device)
        corner = detect_region & (t_star >= int(threshold))
        cache = torch.clamp(t_star, min=0)
    else:
        thr = threshold_map(img)
        cmp_thr = (threshold * lower) // 100
        b2 = torch.div(torch.clamp(thr, lower, upper) * threshold, 100, rounding_mode="floor")
        corner = detect_region & (thr >= cmp_thr) & (t_star >= b2)
        cache = torch.where(corner, torch.maximum(t_star, thr), torch.clamp(t_star, min=0))
    return AstLayerMaps(img=img, t_star=t_star, thrmap=thr, corner=corner, cache=cache,
                        scale=scale, offset=offset)

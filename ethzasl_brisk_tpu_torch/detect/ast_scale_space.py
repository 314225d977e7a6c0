"""Classic BRISK (AST) scale-space detection (port of
``detect/ast_scale_space.py``).

Mirrors ``BriskScaleSpace`` + ``BriskFeatureDetector``
(``brisk/src/brisk-scale-space.cc``, ``brisk-feature-detector.cc``) on a
batch of uint8 frames ``(B, H, W)``; one image is B = 1:

* a pyramid of 2*octaves BriskLayers (octave / intra alternation) with
  dense OAST 9/16 corner and score maps and threshold maps
  (``detect/ast_layer.py``);
* IsMax2D with the smoothed tie-break (brisk-scale-space.cc:430-531), whose
  raw tie reads depend on the reference's lazy score cache: modelled
  ``emulated`` (two passes), ``cache``, ``corner``, or sequentially
  ``exact`` (``detect/ast_exact.py``);
* cross-layer 3-D refinement: the GetScoreMaxAbove/Below patch scans with
  early drop-threshold rejection (:757-1099), the 1-D scale parabolas
  Refine1D/_1/_2 (:1101-1228) and the integer-coefficient Subpixel2D
  (:1230-1364);
* the layer-0 "virtual below" from AGAST 5/8 (:556-593).

Candidates are every layer's corners in row-major order, cut at a static
per-layer capacity (``AstDiagnostics`` certifies it held); the
per-candidate work is gathers over ``(B, K, ...)`` tensors.

Floats follow the reference's C semantics. Each float32 op is its own
torch op and rounds on its own (no contraction into fused multiply-adds).
The sites where the reference computes in double (``max /= 3072.0``
:1140, the ``/ 6.0`` scan coordinates :777, ``/ 18.0`` in Subpixel2D
:1253, ...) compute in float64 and round to float32 once (``_dbl``,
``_dbl_div``): the reference's double, and the JAX package's result under
``jax.enable_x64(True)``. Without x64 the JAX package computes them in
float32, which moves x and y by up to 2 ULP. Divisions by a constant that
is not a power of two divide by a tensor: on the card, dividing by a
Python number multiplies by its reciprocal, which rounds differently.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.core.selectors import check_raw_cache_model
# ast_layer._shift(x, dy, dx, fill) serves the JAX package's _shift_bool and
# _shift_i32 as well.
from ethzasl_brisk_tpu_torch.detect.ast_layer import AstLayerMaps, _shift, build_ast_layer
from ethzasl_brisk_tpu_torch.detect.scale_space import Mark, _no_mark
from ethzasl_brisk_tpu_torch.kernels.agast import agast5_8_score_map
from ethzasl_brisk_tpu_torch.kernels.downsample import (
    halfsample8_v1,
    pyramid_u8,
    twothirdsample8_v1,
)

f32 = torch.float32
f64 = torch.float64
i32 = torch.int32

K_MAX_THRESHOLD = 1     # brisk-scale-space.cc:47
K_DROP_THRESHOLD = 5    # :48
K_MIN_DROP = 15         # :49
K_BASIC_SIZE = 12.0     # :45
INT32_MAX = 2**31 - 1

def _trunc_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.trunc(x).to(i32)


def _div(v: torch.Tensor, c: float) -> torch.Tensor:
    """v / c rounded once, on either device (a tensor divisor)."""
    return v / torch.full((), c, dtype=v.dtype, device=v.device)


def _dbl(x: torch.Tensor) -> torch.Tensor:
    """A C++ double intermediate: the reference mixes double literals into
    float expressions at some sites, which compute in double and round to
    float once at the assignment."""
    return x.to(f64)


def _dbl_div(num_f32: torch.Tensor, denom: float) -> torch.Tensor:
    """float(x) / <double literal>: double division, float result."""
    return _div(_dbl(num_f32), denom).to(f32)


def _fmul(a, b):
    """A float32 product in its own op. The JAX package multiplies in
    float64 and rounds to float32 to keep XLA:CPU from contracting it into
    a fused multiply-add; that is bit for bit the float32 product."""
    return a * b


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=f32, device=like.device)


# ---------------------------------------------------------------------------
# The pyramid.
# ---------------------------------------------------------------------------
def _layer_geometry(i: int) -> tuple[float, float]:
    if i == 0:
        return 1.0, 0.0
    scale = 2.0 ** (i // 2) * (1.0 if i % 2 == 0 else 1.5)
    return scale, 0.5 * scale - 0.5


def pyramid_images(imgs: torch.Tensor, octaves: int, v1: bool = False) -> list[torch.Tensor]:
    """ConstructPyramid's images (brisk-scale-space.cc:64-90): the input,
    its two-thirds sample, then half samples of the layer two below. The v1
    engine has the same geometry (brisk-v1.cc:577-593) with its own
    resamplers, whose rounding differs on every derived layer."""
    n_layers = max(2 * octaves, 1)
    if not v1:
        # On the card kernel pyramid_u8, every layer in one launch.
        return pyramid_u8(imgs, n_layers)
    half, twothirds = halfsample8_v1, twothirdsample8_v1
    out = [imgs]
    if n_layers > 1:
        out.append(twothirds(imgs))
    for i in range(2, n_layers):
        out.append(half(out[i - 2]))
    return out


def build_ast_pyramid(
    imgs: torch.Tensor,
    octaves: int,
    threshold: int,
    lower: int = 10,
    upper: int = 230,
    v1: bool = False,
    mark: Mark = _no_mark,
) -> list[AstLayerMaps]:
    """The layers of ConstructPyramid with their dense maps (``v1``: the
    legacy engine's resamplers and layers)."""
    images = pyramid_images(imgs, octaves, v1)
    mark("pyramid")
    layers = []
    for i, im in enumerate(images):
        scale, offset = _layer_geometry(i)
        layers.append(build_ast_layer(im, threshold, upper, lower, scale, offset, v1=v1))
    return layers


# ---------------------------------------------------------------------------
# Subpixel2D, the integer-coefficient AST variant (brisk-scale-space.cc:1230).
# Patch convention: s[..., a, b] = Score(x + a - 1, y + b - 1): the FIRST
# index moves x. Returns (delta_x, delta_y, refined_max).
# ---------------------------------------------------------------------------
def ast_subpixel2d(s: torch.Tensor):
    s = s.to(i32)
    s_0_0, s_0_1, s_0_2 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    s_1_0, s_1_1, s_1_2 = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
    s_2_0, s_2_1, s_2_2 = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]

    tmp1 = s_0_0 + s_0_2 - 2 * s_1_1 + s_2_0 + s_2_2
    coeff1 = 3 * (tmp1 + s_0_1 - ((s_1_0 + s_1_2) << 1) + s_2_1)
    coeff2 = 3 * (tmp1 - ((s_0_1 + s_2_1) << 1) + s_1_0 + s_1_2)
    tmp2 = s_0_2 - s_2_0
    tmp3 = s_0_0 + tmp2 - s_2_2
    tmp4 = tmp3 - 2 * tmp2
    coeff3 = -3 * (tmp3 + s_0_1 - s_2_1)
    coeff4 = -3 * (tmp4 + s_1_0 - s_1_2)
    coeff5 = (s_0_0 - s_0_2 - s_2_0 + s_2_2) << 2
    # C: -(X) << 1  ==  (-X) * 2.
    coeff6 = (
        -(s_0_0 + s_0_2 - ((s_1_0 + s_0_1 + s_1_2 + s_2_1) << 1) - 5 * s_1_1 + s_2_0 + s_2_2)
    ) << 1

    h_det = 4 * coeff1 * coeff2 - coeff5 * coeff5

    c1f, c2f, c3f = coeff1.to(f32), coeff2.to(f32), coeff3.to(f32)
    c4f, c5f, c6f = coeff4.to(f32), coeff5.to(f32), coeff6.to(f32)

    # Corner maximum; argmax keeps the first maximum, the reference's
    # strict '>' scan.
    corner_vals = torch.stack(
        [coeff3 + coeff4 + coeff5, -coeff3 + coeff4 - coeff5,
         coeff3 - coeff4 - coeff5, -coeff3 - coeff4 + coeff5],
        dim=-1,
    )
    corner_dx = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=f32, device=s.device)
    corner_dy = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=f32, device=s.device)
    ci = torch.argmax(corner_vals, dim=-1)
    b_max_i = torch.gather(corner_vals, -1, ci[..., None])[..., 0]
    b_dx = corner_dx[ci]
    b_dy = corner_dy[ci]
    # C++: static_cast<float>(int sum) / 18.0, a double division (:1288).
    b_val = _dbl_div((b_max_i + coeff1 + coeff2 + coeff6).to(f32), 18.0)

    # Interior.
    safe_det = torch.where(h_det == 0, 1, h_det).to(f32)
    dx0 = (2 * coeff2 * coeff3 - coeff4 * coeff5).to(f32) / (-safe_det)
    dy0 = (2 * coeff1 * coeff4 - coeff3 * coeff5).to(f32) / (-safe_det)

    tx = dx0 > 1.0
    tx_ = dx0 < -1.0
    ty = dy0 > 1.0
    ty_ = dy0 < -1.0
    oob = tx | tx_ | ty | ty_

    safe_c1 = torch.where(coeff1 == 0, 1, 2 * coeff1).to(f32)
    safe_c2 = torch.where(coeff2 == 0, 1, 2 * coeff2).to(f32)
    zero = torch.zeros_like(dx0)

    delta_x1 = torch.where(tx, 1.0, torch.where(tx_, -1.0, zero))
    delta_y1 = torch.where(
        tx, -(c4f + c5f) / safe_c2, torch.where(tx_, -(c4f - c5f) / safe_c2, zero)
    )
    delta_y1 = torch.clamp(delta_y1, -1.0, 1.0)
    delta_y2 = torch.where(ty, 1.0, torch.where(ty_, -1.0, zero))
    delta_x2 = torch.where(
        ty, -(c3f + c5f) / safe_c1, torch.where(ty_, -(c3f - c5f) / safe_c1, zero)
    )
    delta_x2 = torch.clamp(delta_x2, -1.0, 1.0)

    def quad(dx, dy):
        # The numerator in float (C++ int*float products), / 18.0 in
        # double (:1344-1348, :1360-1363).
        return _dbl_div(
            _fmul(_fmul(c1f, dx), dx) + _fmul(_fmul(c2f, dy), dy)
            + _fmul(c3f, dx) + _fmul(c4f, dy)
            + _fmul(_fmul(c5f, dx), dy) + c6f,
            18.0,
        )

    max1 = quad(delta_x1, delta_y1)
    max2 = quad(delta_x2, delta_y2)
    pick1 = max1 > max2
    # The reference's quirk: delta_y takes delta_x{1,2} (:1352-1358).
    bnd_dx = torch.where(pick1, delta_x1, delta_x2)
    bnd_dy = bnd_dx
    bnd_val = torch.where(pick1, max1, max2)

    c_dx = torch.where(oob, bnd_dx, dx0)
    c_dy = torch.where(oob, bnd_dy, dy0)
    c_val = torch.where(oob, bnd_val, quad(dx0, dy0))

    is_zero = h_det == 0
    is_corner = ~((h_det > 0) & (coeff1 < 0))
    delta_x = torch.where(is_zero, zero, torch.where(is_corner, b_dx, c_dx))
    delta_y = torch.where(is_zero, zero, torch.where(is_corner, b_dy, c_dy))
    val = torch.where(is_zero, _dbl_div(c6f, 18.0), torch.where(is_corner, b_val, c_val))
    return delta_x, delta_y, val


# ---------------------------------------------------------------------------
# Refine1D variants (brisk-scale-space.cc:1101-1228).
# ---------------------------------------------------------------------------
def _refine1d(s_05, s0, s05, coeffs, lo, hi, lo_scale, hi_scale, div, div_is_double=True):
    """The shared 1-D parabola refinement. Returns (scale, max)."""
    (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = coeffs
    # C++ `int(1024.0 * s + 0.5)` is double arithmetic (:1103).
    i_05 = _trunc_i32(_dbl(s_05) * 1024.0 + 0.5)
    i0 = _trunc_i32(_dbl(s0) * 1024.0 + 0.5)
    i05 = _trunc_i32(_dbl(s05) * 1024.0 + 0.5)

    a = a0 * i_05 + a1 * i0 + a2 * i05
    b = b0 * i_05 + b1 * i0 + b2 * i05
    c = c0 * i_05 + c1 * i0 + c2 * i05

    # Degenerate: the plain maximum (the order of the checks matters).
    mid = (s0 >= s_05) & (s0 >= s05)
    low = (s_05 >= s0) & (s_05 >= s05)
    deg_scale = torch.where(mid, _f32(1.0, s0),
                            torch.where(low, _f32(lo_scale, s0), _f32(hi_scale, s0)))
    deg_max = torch.where(mid, s0, torch.where(low, s_05, s05))

    safe_a = torch.where(a == 0, 1, 2 * a).to(f32)
    ret = -b.to(f32) / safe_a
    ret = torch.clamp(ret, lo, hi)
    af, bf = a.to(f32), b.to(f32)
    mx_num = c.to(f32) + _fmul(_fmul(af, ret), ret) + _fmul(bf, ret)
    if div_is_double:
        # `max /= 3072.0` / `2048.0` are double divisions (:1140, :1184).
        mx = _dbl_div(mx_num, div)
    else:
        # Refine1D_2's `max /= 1024` divides by an int, in float (:1227).
        mx = _div(mx_num, div)

    degenerate = a >= 0
    return torch.where(degenerate, deg_scale, ret), torch.where(degenerate, deg_max, mx)


def refine1d(s_05, s0, s05):
    """Octave layers > 0: anchors 0.75 / 1.0 / 1.5 (:1101-1142)."""
    return _refine1d(s_05, s0, s05, ((16, -24, 8), (-40, 54, -14), (24, -27, 6)),
                     0.75, 1.5, 0.75, 1.5, 3072.0)


def refine1d_1(s_05, s0, s05):
    """Intra layers: anchors 2/3 / 1.0 / 4/3 (:1144-1186)."""
    return _refine1d(s_05, s0, s05, ((9, -18, 9), (-21, 36, -15), (12, -16, 6)),
                     2.0 / 3.0, 4.0 / 3.0, 2.0 / 3.0, 4.0 / 3.0, 2048.0)


def refine1d_2(s_05, s0, s05):
    """Layer 0 with the virtual 5/8 below: anchors 0.7 / 1.0 / 1.5
    (:1188-1228)."""
    return _refine1d(s_05, s0, s05, ((2, -4, 2), (-5, 8, -3), (3, -3, 1)),
                     0.7, 1.5, 0.7, 1.5, 1024.0, div_is_double=False)


# ---------------------------------------------------------------------------
# Score accessors over the dense maps. Maps are (B, h, w); coordinates are
# (B, ...) int tensors (broadcast together).
# ---------------------------------------------------------------------------
def _gather(map3d: torch.Tensor, ys, xs) -> torch.Tensor:
    """map3d[b, clip(ys), clip(xs)]."""
    b, h, w = map3d.shape
    idx = torch.clamp(ys, 0, h - 1).to(torch.int64) * w + torch.clamp(xs, 0, w - 1)
    return torch.gather(map3d.reshape(b, -1), 1, idx.reshape(b, -1)).reshape(idx.shape)


def _inside(xs, ys, h: int, w: int, border: int):
    return (xs >= border) & (ys >= border) & (xs < w - border) & (ys < h - border)


def _int_score(layer: AstLayerMaps, xs, ys, center):
    """GetAgastScore(int x, int y, threshold=center) (brisk-layer.cc:118):
    a detected corner returns its seeded cache value, another pixel t* if
    t* >= center else 0; 0 outside [3, n-4]. ``is_max_2d`` computes the
    same from its prefetched 5x5 windows."""
    h, w = layer.shape
    inb = _inside(xs, ys, h, w, 3)
    is_corner = _gather(layer.corner, ys, xs)
    cache = _gather(layer.cache, ys, xs)
    t_star = _gather(layer.t_star, ys, xs)
    fresh = torch.where(t_star >= center, t_star, 0)
    return torch.where(inb, torch.where(is_corner, cache, fresh), 0)


def _cache_score(layer: AstLayerMaps, xs, ys):
    """GetAgastScore(x, y, 1): the threshold-1 view, the dense cache map."""
    h, w = layer.shape
    return torch.where(_inside(xs, ys, h, w, 3), _gather(layer.cache, ys, xs), 0)


def _bilinear_from(score_fn, xf, yf):
    """GetAgastScore(float xf, float yf, 1, scale=1) (brisk-layer.cc:179-):
    the float32 bilinear of the 4 int scores of ``score_fn(x, y)``,
    truncated as the reference's uint8 result."""
    x = _trunc_i32(xf)
    y = _trunc_i32(yf)
    rx1 = xf - x.to(f32)
    rx = 1.0 - rx1
    ry1 = yf - y.to(f32)
    ry = 1.0 - ry1
    v00 = score_fn(x, y).to(f32)
    v10 = score_fn(x + 1, y).to(f32)
    v01 = score_fn(x, y + 1).to(f32)
    v11 = score_fn(x + 1, y + 1).to(f32)
    out = (
        _fmul(_fmul(rx, ry), v00) + _fmul(_fmul(rx1, ry), v10)
        + _fmul(_fmul(rx, ry1), v01) + _fmul(_fmul(rx1, ry1), v11)
    )
    return _trunc_i32(out).to(f32)


def _bilinear_score(layer: AstLayerMaps, xf, yf):
    return _bilinear_from(lambda x, y: _cache_score(layer, x, y), xf, yf)


def _agast58_score(t58: torch.Tensor, xs, ys):
    """GetAgastScore_5_8(x, y, 1) (brisk-layer.cc:134-145)."""
    h, w = t58.shape[-2:]
    t = _gather(t58, ys, xs)
    return torch.where(_inside(xs, ys, h, w, 2) & (t >= 1), t, 0)


def _patch33(score_fn, xs, ys):
    """(B, K, 3, 3) patch, patch[..., a, b] = score(x + a - 1, y + b - 1)."""
    d = torch.arange(-1, 2, device=xs.device, dtype=xs.dtype)
    xg = xs[..., None, None] + d[:, None]   # the a axis moves x
    yg = ys[..., None, None] + d[None, :]   # the b axis moves y
    return score_fn(xg, yg)


# ---------------------------------------------------------------------------
# IsMax2D (brisk-scale-space.cc:430-531).
# ---------------------------------------------------------------------------
_NEIGH8 = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, 1), (1, 1), (1, -1), (-1, -1))
# The tie-scan order of the reference's delta list (:482-513).
_TIE_ORDER = ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def _row_major(layer: AstLayerMaps) -> torch.Tensor:
    h, w = layer.shape
    dev = layer.img.device
    return (torch.arange(h, dtype=i32, device=dev)[:, None] * w
            + torch.arange(w, dtype=i32, device=dev)[None, :])


def earliest_toucher_map(layer: AstLayerMaps) -> torch.Tensor:
    """Per pixel q: the least row-major index of an adjacent corner whose
    IsMax2D neighbour query would seed q's lazy score cache with t*(q),
    i.e. an adjacent corner c with center(c) <= t*(q); INT32_MAX if none.

    Models the reference's order-dependent ``scores_`` fill
    (brisk-layer.cc:118-132 writes on every GetAgastScore miss; corners are
    processed row-major, each querying its 8 neighbours)."""
    rm = _row_major(layer).expand_as(layer.cache)
    best = torch.full_like(layer.cache, INT32_MAX)
    for dx, dy in _NEIGH8:
        c_corner = _shift(layer.corner, dy, dx, False)
        c_center = _shift(layer.cache, dy, dx)
        c_rm = _shift(rm, dy, dx, INT32_MAX)
        ok = c_corner & (c_center <= layer.t_star)
        best = torch.minimum(best, torch.where(ok, c_rm, INT32_MAX))
    return best


def is_max_2d(
    layer: AstLayerMaps,
    xs: torch.Tensor,
    ys: torch.Tensor,
    raw_model: str = "emulated",
    e_query: Optional[torch.Tensor] = None,
    e_patch: Optional[torch.Tensor] = None,
    prefill: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """IsMax2D of (B, K) candidates (brisk-scale-space.cc:430-531).

    The tie path reads raw ``scores_`` memory, whose content depends on the
    candidate order. ``raw_model``:

    * ``emulated``: the earliest-toucher model of the lazy cache fill:
      ``e_query(q)``, the least row-major index of an adjacent corner whose
      IsMax2D query seeds q with t* (center <= t*, t* > 2); ``e_patch(q)``,
      the least row-major index of an adjacent accepted candidate whose
      Refine3D 3x3 patch seeds q at threshold 1 (t* >= 1); ``prefill(q)``,
      where an earlier layer's cross-layer probes seeded q at threshold 1;
    * ``cache``: the dense threshold-1 view (an upper bound);
    * ``corner``: corners only (a lower bound).
    """
    if raw_model not in ("emulated", "cache", "corner"):
        raise ValueError(f"raw_model={raw_model!r}: expected emulated, cache or corner")
    # One (B, K, 5, 5) gather per map: every neighbour and raw read lies in
    # the 5x5 window, and the clipped gather gives the same values.
    h_l, w = layer.shape
    d2 = torch.arange(-2, 3, device=xs.device, dtype=xs.dtype)
    yy = ys[..., None, None] + d2[:, None]   # (B, K, 5oy, 1)
    xx = xs[..., None, None] + d2[None, :]   # (B, K, 1, 5ox)
    p_corner = _gather(layer.corner, yy, xx)
    p_cache = _gather(layer.cache, yy, xx)
    p_t = _gather(layer.t_star, yy, xx)
    inb_p = _inside(xx, yy, h_l, w, 3)

    center = p_cache[..., 2, 2]  # candidates are corners
    cand_rm = ys * w + xs

    def int_score(ox, oy):
        cnr = p_corner[..., 2 + oy, 2 + ox]
        cch = p_cache[..., 2 + oy, 2 + ox]
        ts = p_t[..., 2 + oy, 2 + ox]
        fresh = torch.where(ts >= center, ts, 0)
        return torch.where(inb_p[..., 2 + oy, 2 + ox], torch.where(cnr, cch, fresh), 0)

    neigh = {(dx, dy): int_score(dx, dy) for dx, dy in _NEIGH8}
    reject = torch.zeros_like(xs, dtype=torch.bool)
    for v in neigh.values():
        reject |= v > center

    # The smoothed tie-break.
    s_10, s10 = neigh[(-1, 0)], neigh[(1, 0)]
    s0_1, s01 = neigh[(0, -1)], neigh[(0, 1)]
    s_1_1, s1_1 = neigh[(-1, -1)], neigh[(1, -1)]
    s_11, s11 = neigh[(-1, 1)], neigh[(1, 1)]
    smoothed_center = 4 * center + 2 * (s_10 + s10 + s0_1 + s01) + s_1_1 + s1_1 + s_11 + s11

    if raw_model == "emulated" and e_query is None:
        e_query = earliest_toucher_map(layer)
    p_early = _gather(e_query, yy, xx) if raw_model == "emulated" else None
    p_epatch = _gather(e_patch, yy, xx) if e_patch is not None else None
    p_prefill = _gather(prefill, yy, xx) if prefill is not None else None

    def raw(ox, oy):
        """The raw scores_ read at candidate offset (ox, oy), |ox|, |oy| <= 2."""
        q_corner = p_corner[..., 2 + oy, 2 + ox]
        q_cache = p_cache[..., 2 + oy, 2 + ox]
        q_t = p_t[..., 2 + oy, 2 + ox]
        if raw_model == "corner":
            return torch.where(q_corner, q_cache, 0)
        if raw_model == "cache":
            return torch.where(inb_p[..., 2 + oy, 2 + ox], q_cache, 0)
        touched_q = p_early[..., 2 + oy, 2 + ox] < cand_rm
        if abs(ox) <= 1 and abs(oy) <= 1:  # q adjacent to the candidate itself
            touched_q = touched_q | (center <= q_t)
        thr1 = torch.zeros_like(touched_q)
        if p_epatch is not None:
            thr1 = thr1 | (p_epatch[..., 2 + oy, 2 + ox] < cand_rm)
        if p_prefill is not None:
            thr1 = thr1 | p_prefill[..., 2 + oy, 2 + ox]
        val = torch.where(thr1 & (q_t >= 1), q_t, torch.where(touched_q & (q_t > 2), q_t, 0))
        return torch.where(q_corner, q_cache, val)

    for dx, dy in _TIE_ORDER:
        tied = neigh[(dx, dy)] == center
        other = (
            raw(dx - 1, dy - 1) + 2 * raw(dx, dy - 1) + raw(dx + 1, dy - 1)
            + 2 * raw(dx + 1, dy) + 4 * raw(dx, dy) + 2 * raw(dx - 1, dy)
            + raw(dx - 1, dy + 1) + 2 * raw(dx, dy + 1) + raw(dx + 1, dy + 1)
        )
        reject |= tied & (other > smoothed_center)
    return ~reject


# ---------------------------------------------------------------------------
# GetScoreMaxAbove / GetScoreMaxBelow (brisk-scale-space.cc:757-1099).
# ---------------------------------------------------------------------------
def scan_window(xs: torch.Tensor, ys: torch.Tensor, mode: str):
    """The scan window's float corners (x_1, x1, y_1, y1) in the neighbour
    layer. Literal types per reference site: above-octave `/ 6.0` double
    (:777), above-intra `/ 8.0f` float (:783), below-octave `/ 6.0` double
    (:933), below-intra `/ 4.0` double (:940); the double sites round to
    float once, after the division."""
    xsf, ysf = xs.to(f32), ys.to(f32)
    if mode == "above_octave":
        return (_dbl_div((4 * xs - 3).to(f32), 6.0), _dbl_div((4 * xs + 1).to(f32), 6.0),
                _dbl_div((4 * ys - 3).to(f32), 6.0), _dbl_div((4 * ys + 1).to(f32), 6.0))
    if mode == "above_intra":
        return ((_fmul(6.0, xsf) - 4) / 8.0, (_fmul(6.0, xsf) + 2) / 8.0,
                (_fmul(6.0, ysf) - 4) / 8.0, (_fmul(6.0, ysf) + 2) / 8.0)
    if mode == "below_octave":
        return (_dbl_div((8 * xs - 3).to(f32), 6.0), _dbl_div((8 * xs + 5).to(f32), 6.0),
                _dbl_div((8 * ys - 3).to(f32), 6.0), _dbl_div((8 * ys + 5).to(f32), 6.0))
    if mode == "below_intra":
        return (_dbl_div((6 * xs - 2).to(f32), 4.0), _dbl_div((6 * xs + 4).to(f32), 4.0),
                _dbl_div((6 * ys - 2).to(f32), 4.0), _dbl_div((6 * ys + 4).to(f32), 4.0))
    raise ValueError(mode)


def _score_patch_max(
    neighbor: AstLayerMaps,
    xs: torch.Tensor,
    ys: torch.Tensor,
    thr: torch.Tensor,
    mode: str,
    drop: int = K_DROP_THRESHOLD,
):
    """The ordered probe scan over the neighbour layer's patch.

    Returns (ismax, score, dx, dy) per candidate: the reference's scan
    order, its first-strict-maximum rule, the below-scan smoothing
    tie-break, the missing threshold check on the bottom row, and the final
    Subpixel2D and saturation. ``drop`` is the v2 engine's
    kDropThreshold_ (a probe above thr + drop rejects); the v1 engine
    compares with the center score itself (brisk-v1.cc:1113-1120): 0.
    """
    threshold = (thr + drop).to(f32)
    xsf, ysf = xs.to(f32), ys.to(f32)
    x_1, x1, y_1, y1 = scan_window(xs, ys, mode)
    n_int = 1 if mode.startswith("above") else 2
    tie_break = mode.startswith("below")

    ix_first = _trunc_i32(x_1 + 1)
    ix_last = _trunc_i32(x1)
    iy_first = _trunc_i32(y_1 + 1)
    iy_last = _trunc_i32(y1)

    # Every read of the scan (integer probes, the bilinear taps of the
    # float probes, the tie-break 3x3 sums, the final 3x3) lies in a 7x7
    # window anchored 2 before (ix_first, iy_first): one gather, then picks.
    # _cache_score's zero border is in the window, so picks equal it.
    x0 = ix_first - 2
    y0 = iy_first - 2
    d7 = torch.arange(7, device=xs.device, dtype=xs.dtype)
    yy7 = y0[..., None, None] + d7[:, None]
    xx7 = x0[..., None, None] + d7[None, :]
    h_n, w_n = neighbor.shape
    win = torch.where(_inside(xx7, yy7, h_n, w_n, 3), _gather(neighbor.cache, yy7, xx7), 0)
    win49 = win.reshape(win.shape[:-2] + (49,))

    def cache_pick(ax, ay):
        """_cache_score(neighbor, ax, ay) from the window; 0 outside it."""
        extra = ax.dim() - x0.dim()
        x0e = x0.reshape(x0.shape + (1,) * extra)
        y0e = y0.reshape(y0.shape + (1,) * extra)
        idx = (ay - y0e) * 7 + (ax - x0e)
        shape = torch.broadcast_shapes(idx.shape, ay.shape)
        idx = idx.expand(shape)
        flat = idx.reshape(idx.shape[: x0.dim()] + (-1,))
        ok = (flat >= 0) & (flat < 49)
        got = torch.gather(win49, -1, torch.clamp(flat, 0, 48).to(torch.int64))
        return torch.where(ok, got, 0).reshape(shape)

    # Column and row specs: (kind, coordinate, exists).
    cols = [("f", x_1, None)]
    for k in range(n_int):
        xi = ix_first + k
        cols.append(("i", xi, xi <= ix_last))
    cols.append(("f", x1, None))
    rows = [("f", y_1, None, True)]
    for k in range(n_int):
        yi = iy_first + k
        rows.append(("i", yi, yi <= iy_last, True))
    rows.append(("f", y1, None, False))  # the bottom row: no threshold check

    def probe(ckind, cval, rkind, rval):
        if ckind == "i" and rkind == "i":
            return cache_pick(cval, rval).to(f32)
        xf = cval.to(f32) if ckind == "i" else cval
        yf = rval.to(f32) if rkind == "i" else rval
        return _bilinear_from(cache_pick, xf, yf)

    def smoothed(ax, ay):
        return (
            2 * (cache_pick(ax - 1, ay) + cache_pick(ax + 1, ay)
                 + cache_pick(ax, ay + 1) + cache_pick(ax, ay - 1))
            + cache_pick(ax + 1, ay + 1) + cache_pick(ax - 1, ay + 1)
            + cache_pick(ax + 1, ay - 1) + cache_pick(ax - 1, ay - 1)
        )

    exceeded = torch.zeros_like(xs, dtype=torch.bool)
    mx, my = ix_first, iy_first
    best = None
    for ri, (rkind, rval, rexists, rcheck) in enumerate(rows):
        for ci, (ckind, cval, cexists) in enumerate(cols):
            exists = torch.ones_like(exceeded)
            if cexists is not None:
                exists = exists & cexists
            if rexists is not None:
                exists = exists & rexists
            v = probe(ckind, cval, rkind, rval)
            # The position this probe would assign.
            px = cval if ckind == "i" else (ix_first if ci == 0 else _trunc_i32(cval))
            py = rval if rkind == "i" else (iy_first if ri == 0 else _trunc_i32(rval))
            if best is None:
                best = v
                if rcheck:
                    exceeded = exceeded | (v > threshold)
                continue
            if rcheck:
                exceeded = exceeded | (exists & (v > threshold))
            if tie_break and ckind == "i" and rkind == "i":
                # GetScoreMaxBelow's middle tie-break (:1004-1028): on
                # equality, compare smoothed 3x3 sums (threshold-1 scores).
                tie = exists & (v == best)
                move = tie & (smoothed(cval, rval) > smoothed(mx, my))
                mx = torch.where(move, cval, mx)
                my = torch.where(move, rval, my)
            upd = exists & (v > best)
            best = torch.where(upd, v, best)
            mx = torch.where(upd, px, mx)
            my = torch.where(upd, py, my)

    # Subpixel on the 3x3 around (mx, my), a scan position: its +-1 reads
    # stay in the window.
    patch = _patch33(cache_pick, mx, my)
    dx1, dy1, refined = ast_subpixel2d(patch)
    real_x = mx.to(f32) + dx1
    real_y = my.to(f32) + dy1

    # Back-conversion literal types: above-octave all float `6.0f .. 4.0f`
    # (:884), above-intra double `* 8.0 + 1.0) / 6.0` (:887), below-octave
    # double (:1067), below-intra double (:1070). At the double sites the
    # chain including `- x_layer` is double, rounded to float once.
    if mode == "above_octave":
        dx = (_fmul(real_x, 6.0) + 1.0) / 4.0 - xsf
        dy = (_fmul(real_y, 6.0) + 1.0) / 4.0 - ysf
    elif mode == "above_intra":
        dx = (_div(_dbl(real_x) * 8.0 + 1.0, 6.0) - _dbl(xsf)).to(f32)
        dy = (_div(_dbl(real_y) * 8.0 + 1.0, 6.0) - _dbl(ysf)).to(f32)
    elif mode == "below_octave":
        dx = ((_dbl(real_x) * 6.0 + 1.0) / 8.0 - _dbl(xsf)).to(f32)
        dy = ((_dbl(real_y) * 6.0 + 1.0) / 8.0 - _dbl(ysf)).to(f32)
    else:
        dx = (_div(_dbl(real_x) * 4.0 - 1.0, 6.0) - _dbl(xsf)).to(f32)
        dy = (_div(_dbl(real_y) * 4.0 - 1.0, 6.0) - _dbl(ysf)).to(f32)

    unrefined = (dx > 1.0) | (dx < -1.0) | (dy > 1.0) | (dy < -1.0)
    dx = torch.clamp(dx, -1.0, 1.0)
    dy = torch.clamp(dy, -1.0, 1.0)
    score = torch.where(unrefined, best, torch.maximum(refined, best))
    ismax = ~exceeded
    score = torch.where(ismax, score, 0.0)
    return ismax, score, dx, dy


# ---------------------------------------------------------------------------
# Refine3D (brisk-scale-space.cc:534-754).
# ---------------------------------------------------------------------------
def _weak_edge(s_1_1, max_above, max_below_f, v1: bool):
    """(no_refine, discard) of the scale-axis tests (:612-630); v1 has none."""
    if v1:
        return torch.zeros_like(max_above, dtype=torch.bool), torch.zeros_like(
            max_above, dtype=torch.bool)
    weak = ((s_1_1 - K_MAX_THRESHOLD).to(f32) < max_above) | (
        (s_1_1 - K_MAX_THRESHOLD).to(f32) < max_below_f)
    edge = ((s_1_1 - K_MIN_DROP).to(f32) > max_above) | (
        (s_1_1 - K_MIN_DROP).to(f32) > max_below_f)
    return weak & edge, weak & ~edge


def _drop(v1: bool) -> int:
    return 0 if v1 else K_DROP_THRESHOLD


def refine3d(layers: list[AstLayerMaps], i: int, xs, ys, t58_layer0: Optional[torch.Tensor],
             v1: bool = False):
    """Refine3D of the candidates of layer i (not the last layer).

    Returns (ismax, score, x, y, scale_total, ismax_above, ismax_below) in
    the original image's coordinates. ``v1``: the legacy engine
    (brisk-v1.cc:942-1110) has no scale-axis weak/edge gates (it always
    refines the scale) and scans with drop 0."""
    this = layers[i]
    center = _cache_score(this, xs, ys)
    drop = _drop(v1)
    is_octave = i % 2 == 0
    above_mode = "above_octave" if is_octave else "above_intra"
    ismax_a, max_above, dxa, dya = _score_patch_max(layers[i + 1], xs, ys, center, above_mode,
                                                    drop=drop)

    patch = _patch33(lambda xg, yg: _cache_score(this, xg, yg), xs, ys)
    dxl, dyl, max_layer = ast_subpixel2d(patch)
    s_1_1 = patch[..., 1, 1]
    max_layer_or_center = torch.maximum(center.to(f32), max_layer)
    xsf, ysf = xs.to(f32), ys.to(f32)
    ls = _f32(this.scale, xs)
    lo = _f32(this.offset, xs)

    if is_octave:
        if i == 0:
            # The virtual below from AGAST 5/8 (brisk-scale-space.cc:556-593).
            p58 = _patch33(lambda xg, yg: _agast58_score(t58_layer0, xg, yg), xs, ys)
            max_below_f = p58.reshape(p58.shape[:-2] + (9,)).amax(dim=-1).to(f32)
            dxb, dyb, _ = ast_subpixel2d(p58)
            ismax_b = torch.ones_like(ismax_a)
            # Scale-axis tests (:612-630); v1 has none (brisk-v1.cc:1012).
            if v1:
                no_refine = discard = torch.zeros_like(ismax_a)
            else:
                no_refine = (s_1_1 - K_MAX_THRESHOLD) <= _trunc_i32(max_above)
                discard = torch.zeros_like(no_refine)
            r_scale, r_max = refine1d_2(max_below_f, max_layer_or_center, max_above)
        else:
            ismax_b, max_below_f, dxb, dyb = _score_patch_max(
                layers[i - 1], xs, ys, center, "below_octave", drop=drop)
            no_refine, discard = _weak_edge(s_1_1, max_above, max_below_f, v1)
            r_scale, r_max = refine1d(max_below_f, max_layer_or_center, max_above)
        scale = torch.where(no_refine, _f32(1.0, xs), r_scale)
        mx = torch.where(no_refine, max_layer, r_max)

        # Position interpolation (:655-684).
        r0_up = (1.5 - scale) / 0.5
        r1_up = 1.0 - r0_up
        x_up = _fmul(r0_up, dxl) + _fmul(r1_up, dxa) + xsf
        y_up = _fmul(r0_up, dyl) + _fmul(r1_up, dya) + ysf
        r0_dn = (scale - (0.5 if i == 0 else 0.75)) / (0.5 if i == 0 else 0.25)
        r1_dn = 1.0 - r0_dn
        x_dn = _fmul(r0_dn, dxl) + _fmul(r1_dn, dxb) + xsf
        y_dn = _fmul(r0_dn, dyl) + _fmul(r1_dn, dyb) + ysf
        up = scale > 1.0
        if i == 0:
            # Layer 0: the up branch multiplies by scale 1 and adds offset
            # 0; the down branch omits the transform (:662-668).
            x_out = torch.where(up, x_up, x_dn)
            y_out = torch.where(up, y_up, y_dn)
        else:
            x_out = torch.where(up, _fmul(x_up, ls) + lo, _fmul(x_dn, ls) + lo)
            y_out = torch.where(up, _fmul(y_up, ls) + lo, _fmul(y_dn, ls) + lo)
    else:
        ismax_b, max_below_f, dxb, dyb = _score_patch_max(
            layers[i - 1], xs, ys, center, "below_intra", drop=drop)
        no_refine, discard = _weak_edge(s_1_1, max_above, max_below_f, v1)
        r_scale, r_max = refine1d_1(max_below_f, max_layer_or_center, max_above)
        scale = torch.where(no_refine, _f32(1.0, xs), r_scale)
        mx = torch.where(no_refine, max_layer, r_max)
        # C++ `4.0 - scale * 3.0` and `scale * 3.0 - 2.0` are double chains
        # rounded once to float (:731, :739).
        r0_up = (4.0 - _dbl(scale) * 3.0).to(f32)
        r1_up = 1.0 - r0_up
        r0_dn = (_dbl(scale) * 3.0 - 2.0).to(f32)
        r1_dn = 1.0 - r0_dn
        x_up = _fmul(_fmul(r0_up, dxl) + _fmul(r1_up, dxa) + xsf, ls) + lo
        y_up = _fmul(_fmul(r0_up, dyl) + _fmul(r1_up, dya) + ysf, ls) + lo
        x_dn = _fmul(_fmul(r0_dn, dxl) + _fmul(r1_dn, dxb) + xsf, ls) + lo
        y_dn = _fmul(_fmul(r0_dn, dyl) + _fmul(r1_dn, dyb) + ysf, ls) + lo
        up = scale > 1.0
        x_out = torch.where(up, x_up, x_dn)
        y_out = torch.where(up, y_up, y_dn)

    ismax = ismax_a & ismax_b & ~discard
    scale_total = scale * ls
    return ismax, mx, x_out, y_out, scale_total, ismax_a, ismax_b


# ---------------------------------------------------------------------------
# Detection (BriskFeatureDetector::detectImpl + GetKeypoints).
# ---------------------------------------------------------------------------
def _process_layer(layers, i, xs, ys, t58, e_query, e_patch, prefill, is2d_override=None,
                   v1=False):
    """One layer's maxima pipeline: (is2d, accepted, (x, y, size, score,
    octave), ismax_above, ismax_below)."""
    layer = layers[i]
    n_layers = len(layers)
    if is2d_override is not None:
        is2d = is2d_override
    else:
        is2d = is_max_2d(layer, xs, ys, raw_model="emulated",
                         e_query=e_query, e_patch=e_patch, prefill=prefill)
    ls = _f32(layer.scale, xs)
    lo = _f32(layer.offset, xs)
    ones = torch.ones_like(is2d)
    if n_layers == 1:
        patch = _patch33(lambda xg, yg: _cache_score(layer, xg, yg), xs, ys)
        dxl, dyl, score = ast_subpixel2d(patch)
        x_out = xs.to(f32) + dxl
        y_out = ys.to(f32) + dyl
        size = torch.full_like(x_out, K_BASIC_SIZE)
        accepted = is2d
        ismax_a = ismax_b = ones
    elif i == n_layers - 1:
        center = _cache_score(layer, xs, ys)
        below_mode = "below_octave" if i % 2 == 0 else "below_intra"
        ismax_b, _, _, _ = _score_patch_max(layers[i - 1], xs, ys, center, below_mode,
                                            drop=_drop(v1))
        patch = _patch33(lambda xg, yg: _cache_score(layer, xg, yg), xs, ys)
        dxl, dyl, score = ast_subpixel2d(patch)
        x_out = _fmul(xs.to(f32) + dxl, ls) + lo
        y_out = _fmul(ys.to(f32) + dyl, ls) + lo
        size = torch.full_like(x_out, K_BASIC_SIZE * layer.scale)
        accepted = is2d & ismax_b
        ismax_a = ones
    else:
        ismax, score, x_out, y_out, scale_total, ismax_a, ismax_b = refine3d(
            layers, i, xs, ys, t58, v1)
        size = K_BASIC_SIZE * scale_total
        accepted = is2d & ismax
    return is2d, accepted, (x_out, y_out, size, score, i), ismax_a, ismax_b


def _scatter_true(shape, ys, xs, mask) -> torch.Tensor:
    """A (B, h, w) bool map, True where some masked (y, x) lands: only True
    is written, so duplicate indices cannot race."""
    b, h, w = shape
    flat = ys.to(torch.int64) * w + xs
    flat = torch.where(mask, flat, h * w).reshape(b, -1)
    out = torch.zeros((b, h * w + 1), dtype=torch.bool, device=mask.device)
    out.scatter_(1, flat, True)
    return out[:, : h * w].reshape(b, h, w)


def _min_over_shifts(acc, rm, offs, sign):
    """min over offsets of the row-major index of an acc-marked pixel at
    q + sign*(dx, dy), INT32_MAX if none."""
    best = torch.full(acc.shape, INT32_MAX, dtype=i32, device=acc.device)
    for dx, dy in offs:
        a = _shift(acc, sign * dy, sign * dx, False)
        r = _shift(rm, sign * dy, sign * dx, INT32_MAX)
        best = torch.minimum(best, torch.where(a, r, INT32_MAX))
    return best


def _aux_maps(layers, cand, pass1):
    """(e_query, e_patch, prefill) per layer from the pass-1 estimate.

    ``pass1[i]`` holds is2d, patch_touched and above_ok of layer i.
    e_patch: own-layer 3x3 patch touches (threshold 1) of earlier
    candidates whose Refine3D reached the patch gather. prefill: layer
    i-1's GetScoreMaxAbove probe taps on layer i, the whole probe window
    when the scan completed (above_ok), the first probe's 2x2 taps when it
    exited early.
    """
    n_layers = len(layers)
    aux = []
    for i, layer in enumerate(layers):
        h, w = layer.shape
        shape = layer.cache.shape
        xs, ys, valid = cand[i]
        acc = _scatter_true(shape, ys, xs, valid & pass1[i]["patch_touched"])
        rm = _row_major(layer).expand(shape)
        if i == n_layers - 1:
            # The last layer: the float-coordinate patch gather touches a
            # 4x4 block, and the GetScoreMaxBelow threshold argument seeds
            # the own 2x2 after IsMax2D alone (ast_exact's float_patch;
            # brisk-scale-space.cc:227-241). q is touched by the candidate
            # at q - (dx, dy): the negated offsets.
            e_patch = _min_over_shifts(
                acc, rm, [(dx, dy) for dy in (-1, 0, 1, 2) for dx in (-1, 0, 1, 2)], -1)
            acc2 = _scatter_true(shape, ys, xs, valid & pass1[i]["is2d"])
            e_patch = torch.minimum(
                e_patch, _min_over_shifts(acc2, rm, ((0, 0), (1, 0), (0, 1), (1, 1)), -1))
        else:
            e_patch = _min_over_shifts(acc, rm, _NEIGH8, 1)

        prefill = torch.zeros(shape, dtype=torch.bool, device=layer.cache.device)
        if i >= 1:
            pxs, pys, pvalid = cand[i - 1]
            is2d_prev = pvalid & pass1[i - 1]["is2d"]
            above_ok = pass1[i - 1]["above_ok"]
            xf, yf = pxs.to(f32), pys.to(f32)
            if (i - 1) % 2 == 0:
                lo_x = _trunc_i32(_div(4.0 * xf - 3, 6.0))
                hi_x = _trunc_i32(_div(4.0 * xf + 1, 6.0)) + 1
                lo_y = _trunc_i32(_div(4.0 * yf - 3, 6.0))
                hi_y = _trunc_i32(_div(4.0 * yf + 1, 6.0)) + 1
            else:
                lo_x = _trunc_i32((6.0 * xf - 4) / 8.0)
                hi_x = _trunc_i32((6.0 * xf + 2) / 8.0) + 1
                lo_y = _trunc_i32((6.0 * yf - 4) / 8.0)
                hi_y = _trunc_i32((6.0 * yf + 2) / 8.0) + 1
            # Early exit: only the first probe's bilinear taps (2x2 at lo).
            hi_x_eff = torch.where(above_ok, hi_x, lo_x + 1)
            hi_y_eff = torch.where(above_ok, hi_y, lo_y + 1)
            qs, ms = [], []
            for kx in range(3):
                for ky in range(3):
                    qs.append((torch.clamp(lo_y + ky, 0, h - 1), torch.clamp(lo_x + kx, 0, w - 1)))
                    ms.append(is2d_prev & (lo_x + kx <= hi_x_eff) & (lo_y + ky <= hi_y_eff))
            prefill = _scatter_true(
                shape, torch.stack([q[0] for q in qs], -1), torch.stack([q[1] for q in qs], -1),
                torch.stack(ms, -1))
        aux.append((earliest_toucher_map(layer), e_patch, prefill))
    return aux


class AstDiagnostics(NamedTuple):
    """Certificate that the per-layer candidate capacities did not truncate
    on these frames (overflow drops corners without a trace). Fields have
    a leading batch axis (none for a single image, as in the JAX package);
    assert ``ok`` when tuning capacities."""

    ok: torch.Tensor             # (B,) bool
    corner_counts: torch.Tensor  # (B, L) int32: AGAST corners per layer
    cand_caps: torch.Tensor      # (L,) int32: the static per-layer caps

    def frame(self, i: int) -> "AstDiagnostics":
        """The certificate of frame ``i`` alone (no batch axis)."""
        return AstDiagnostics(self.ok[i], self.corner_counts[i], self.cand_caps)


def _layer_caps(max_candidates_per_layer, n_layers: int) -> tuple:
    caps = (max_candidates_per_layer if isinstance(max_candidates_per_layer, tuple)
            else (max_candidates_per_layer,) * n_layers)
    if len(caps) < n_layers:
        raise ValueError(f"{len(caps)} candidate caps for {n_layers} layers")
    return caps[:n_layers]


def _corner_counts(layers) -> torch.Tensor:
    return torch.stack([la.corner.sum(dim=(-2, -1), dtype=i32) for la in layers], dim=-1)


def ast_capacity_diagnostics(
    imgs: torch.Tensor,
    threshold: int,
    octaves: int,
    max_candidates_per_layer: "int | tuple",
    lower_threshold: int = 10,
    v1: bool = False,
) -> AstDiagnostics:
    """The pyramid-only capacity certificate of (B, H, W) frames: per-layer
    AGAST corner counts against the candidate caps, and (as in the JAX
    package, whose dense engine extracts corners by a per-2048-block top-256)
    no 2048-pixel block of a layer holding more than 256 corners."""
    layers = build_ast_pyramid(imgs, octaves, threshold, lower=lower_threshold, v1=v1)
    caps = _layer_caps(max_candidates_per_layer, len(layers))
    counts = _corner_counts(layers)
    caps_arr = torch.tensor(caps, dtype=i32, device=imgs.device)
    block_ok = torch.ones(imgs.shape[0], dtype=torch.bool, device=imgs.device)
    for la in layers:
        cm = la.corner.reshape(imgs.shape[0], -1).to(i32)
        pad = (-cm.shape[1]) % 2048
        if pad:
            cm = torch.nn.functional.pad(cm, (0, pad))
        block_ok &= cm.reshape(cm.shape[0], -1, 2048).sum(dim=2).amax(dim=1) <= 256
    return AstDiagnostics(ok=(counts <= caps_arr).all(dim=1) & block_ok,
                          corner_counts=counts, cand_caps=caps_arr)


def layer_candidates(corner: torch.Tensor, cap: int):
    """The first ``cap`` corners of each frame in row-major order, as
    ``jnp.nonzero(corner, size=cap, fill_value=0)``: (xs, ys, valid), each
    (B, cap), unused slots at (0, 0). A prefix sum places each corner; only
    kept corners land in distinct slots (the rest go to a dropped column)."""
    b, h, w = corner.shape
    flat = corner.reshape(b, -1)
    pos = torch.cumsum(flat, dim=1) - 1
    slot = torch.where(flat & (pos < cap), pos, cap)
    idx = torch.zeros((b, cap + 1), dtype=torch.int64, device=corner.device)
    idx.scatter_(1, slot, torch.arange(h * w, device=corner.device).expand(b, -1))
    idx = idx[:, :cap]  # slots past the corner count keep their 0
    n = flat.sum(dim=1, dtype=i32)
    valid = torch.arange(cap, device=corner.device)[None, :] < n[:, None]
    return (idx % w).to(i32), torch.div(idx, w, rounding_mode="floor").to(i32), valid


def detect_ast_keypoints(
    imgs: torch.Tensor,
    threshold: int = 70,
    octaves: int = 3,
    max_candidates_per_layer: "int | tuple" = 2048,
    raw_cache_model: str = "emulated",
    suppress_scale_nonmaxima: bool = True,
    passed_keypoints: KeyPoints | None = None,
    lower_threshold: int = 10,
    v1: bool = False,
    with_diagnostics: bool = False,
    mark: Mark = _no_mark,
):
    """BRISK-AST detection on uint8 frames (B, H, W). Returns KeyPoints with
    (B, C) fields, C the sum of the per-layer slots, and with
    ``with_diagnostics`` an :class:`AstDiagnostics`.

    ``max_candidates_per_layer`` may be a per-layer tuple; overflow drops
    corners (``AstDiagnostics.ok`` certifies it did not happen).

    ``raw_cache_model``: ``emulated`` runs two passes: pass 1 estimates
    the per-layer decisions with query-only cache emulation, pass 2 reruns
    with the patch and cross-layer cache-fill maps built from pass 1
    (``is_max_2d``); ``exact`` emulates the cache sequentially per layer
    (``detect/ast_exact.py``); ``cache`` and ``corner`` are the bounds.

    ``suppress_scale_nonmaxima=False`` is the reference's non-suppressed
    mode (brisk-scale-space.cc:133-170): per-layer 2-D maxima with
    sub-pixel refinement only, in layer coordinates.

    ``passed_keypoints`` (fields (B, N)) is the usePassedKeypoints mode
    (:103-124): every keypoint is mapped into every layer (x/scale -
    offset, a float bounds check at 3..dim-3, then C truncation to int),
    the 2-D maximum check is skipped, and the refinement and 3-D
    suppression run on those candidates.

    ``mark(stage)`` is called after each stage: pyramid, layers,
    candidates, pass1 and aux (``emulated`` only), pass2.
    """
    check_raw_cache_model(raw_cache_model)
    if imgs.dim() != 3 or imgs.dtype != torch.uint8:
        raise ValueError(f"expected uint8 frames (B, H, W), got {imgs.dtype} {tuple(imgs.shape)}")
    dev = imgs.device
    bsz = imgs.shape[0]
    layers = build_ast_pyramid(imgs, octaves, threshold, lower=lower_threshold, v1=v1, mark=mark)
    n_layers = len(layers)
    t58 = agast5_8_score_map(layers[0].img) if n_layers > 1 else None
    mark("layers")

    cand = []
    diag = AstDiagnostics(
        ok=torch.ones(bsz, dtype=torch.bool, device=dev),
        corner_counts=torch.zeros((bsz, n_layers), dtype=i32, device=dev),
        cand_caps=torch.zeros(n_layers, dtype=i32, device=dev),
    )
    if passed_keypoints is not None:
        for layer in layers:
            h, w = layer.shape
            lx = passed_keypoints.x / _f32(layer.scale, imgs) - _f32(layer.offset, imgs)
            ly = passed_keypoints.y / _f32(layer.scale, imgs) - _f32(layer.offset, imgs)
            ok = (passed_keypoints.valid & (lx >= 3) & (ly >= 3)
                  & (lx <= w - 3) & (ly <= h - 3))
            cand.append((_trunc_i32(lx), _trunc_i32(ly), ok))
    else:
        caps = _layer_caps(max_candidates_per_layer, n_layers)
        for layer, cap in zip(layers, caps):
            cand.append(layer_candidates(layer.corner, cap))
        counts = _corner_counts(layers)
        caps_arr = torch.tensor(caps, dtype=i32, device=dev)
        diag = AstDiagnostics(ok=(counts <= caps_arr).all(dim=1), corner_counts=counts,
                              cand_caps=caps_arr)
    mark("candidates")

    if not suppress_scale_nonmaxima:
        per_layer = []
        for layer, (xs, ys, valid) in zip(layers, cand):
            if passed_keypoints is not None:
                is2d = torch.ones_like(valid)  # perform_2d_nonMax=false
            else:
                is2d = is_max_2d(layer, xs, ys, raw_model="emulated")
            patch = _patch33(lambda xg, yg, la=layer: _cache_score(la, xg, yg), xs, ys)
            dxl, dyl, mx = ast_subpixel2d(patch)
            # Layer-local coordinates and the scaled size
            # (brisk-scale-space.cc:154-166).
            per_layer.append(KeyPoints(
                x=xs.to(f32) + dxl, y=ys.to(f32) + dyl,
                size=torch.full_like(dxl, K_BASIC_SIZE * layer.scale),
                angle=torch.full_like(dxl, -1.0), response=mx,
                octave=torch.zeros(dxl.shape, dtype=i32, device=dev), valid=valid & is2d,
            ))
        kps = KeyPoints.concatenate(per_layer)
        mark("pass2")
        return (kps, diag) if with_diagnostics else kps

    aux = [(None, None, None)] * n_layers
    exact_is2d: list = [None] * n_layers
    model = raw_cache_model
    if passed_keypoints is not None:
        # usePassedKeypoints skips IsMax2D: no cache-order model is needed.
        exact_is2d = [torch.ones_like(c[2]) for c in cand]
        model = "exact"
    elif model == "emulated":
        pass1 = []
        for i in range(n_layers):
            xs, ys, valid = cand[i]
            is2d, _, _, ismax_a, ismax_b = _process_layer(layers, i, xs, ys, t58,
                                                          None, None, None, v1=v1)
            pass1.append(dict(is2d=is2d, patch_touched=is2d & ismax_a & ismax_b,
                              above_ok=ismax_a))
        mark("pass1")
        aux = _aux_maps(layers, cand, pass1)
        mark("aux")
    elif model == "exact":
        from ethzasl_brisk_tpu_torch.detect.ast_exact import exact_is2d_layers

        exact_is2d = exact_is2d_layers(layers, cand, drop=_drop(v1))

    per_layer = []
    for i in range(n_layers):
        xs, ys, valid = cand[i]
        e_q, e_p, pre = aux[i]
        if model == "exact":
            _, accepted, fields, _, _ = _process_layer(
                layers, i, xs, ys, t58, None, None, None, is2d_override=exact_is2d[i], v1=v1)
        elif model != "emulated":
            is2d = is_max_2d(layers[i], xs, ys, raw_model=model)
            _, accepted, fields, _, _ = _process_layer(layers, i, xs, ys, t58, None, None, None,
                                                       v1=v1)
            accepted = accepted & is2d
        else:
            _, accepted, fields, _, _ = _process_layer(layers, i, xs, ys, t58, e_q, e_p, pre,
                                                       v1=v1)
        x_out, y_out, size, score, octave_idx = fields
        per_layer.append(KeyPoints(
            x=x_out, y=y_out, size=size, angle=torch.full_like(x_out, -1.0),
            response=score.to(f32),
            octave=torch.full(x_out.shape, octave_idx, dtype=i32, device=dev),
            valid=valid & accepted,
        ))
    kps = KeyPoints.concatenate(per_layer)
    mark("pass2")
    return (kps, diag) if with_diagnostics else kps

"""BRISK sampling-pattern lookup tables (port of ``core/pattern.py``).

Host-side NumPy, identical arithmetic to the JAX package's module so the
tables come out bit-equal. v2: 66 base points read from
``brisk_v2_pattern.npz`` (a copy of the JAX package's table), expanded to
64 scales x 1024 rotations with float32 storage and float64 trig, per-point
Gaussian sigmas, short/long pair lists and integer long-pair gradient
weights (brisk-descriptor-extractor.cc:180-291). ``pattern_from_file``
expands the points of a ``.ptn`` file the same way; ``brisk_v1_pattern``
is the v1 engine's ring pattern with its own float chains.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

SCALES = 64          # brisk-descriptor-extractor.cc:58
SCALERANGE = 30.0    # brisk-descriptor-extractor.cc:60
N_ROT = 1024         # brisk-descriptor-extractor.cc:62
BASIC_SIZE = 12.0    # brisk-descriptor-extractor.cc:57
SIGMA_SCALE = np.float32(1.3)

_PATTERN_NPZ = os.path.join(os.path.dirname(__file__), "brisk_v2_pattern.npz")


@dataclasses.dataclass(frozen=True)
class BriskPattern:
    """Host-side pattern tables.

    lut_x, lut_y: (SCALES, N_ROT, P) f32 rotated/scaled point offsets;
    lut_sigma: (SCALES, P) f32; scale_list: (SCALES,) f32; size_list:
    (SCALES,) i32 border sizes; short_pairs/long_pairs: (S, 2)/(L, 2) i32;
    long_weights: (L, 2) i32 fixed-point gradient weights.
    """

    lut_x: np.ndarray
    lut_y: np.ndarray
    lut_sigma: np.ndarray
    scale_list: np.ndarray
    size_list: np.ndarray
    short_pairs: np.ndarray
    long_pairs: np.ndarray
    long_weights: np.ndarray

    @property
    def lut_scaling(self) -> np.ndarray:
        """(S, P) i32: int(4194304.0 / area), area = 4*sigma^2 in f32 (:412)."""
        area = np.float32(4.0) * self.lut_sigma * self.lut_sigma
        return np.trunc(4194304.0 / area.astype(np.float64)).astype(np.int32)

    @property
    def lut_scaling2(self) -> np.ndarray:
        """(S, P) i32: int(float(scaling) * area / 1024.0) (:413)."""
        area = np.float32(4.0) * self.lut_sigma * self.lut_sigma
        prod = (self.lut_scaling.astype(np.float32) * area).astype(np.float32)
        return np.trunc(prod.astype(np.float64) / 1024.0).astype(np.int32)

    @property
    def descriptor_bits(self) -> int:
        return int(self.short_pairs.shape[0])

    @property
    def descriptor_words(self) -> int:
        # strings_ = ceil(bits / 128) * 16 bytes (:283)
        return int(np.ceil(self.descriptor_bits / 128.0)) * 4


def _scale_list() -> np.ndarray:
    lb_scale = np.float32(np.log(SCALERANGE) / np.log(2.0))
    lb_scale_step = np.float32(lb_scale / np.float32(SCALES))
    exps = (np.arange(SCALES, dtype=np.float32) * lb_scale_step).astype(np.float64)
    return np.power(2.0, exps).astype(np.float32)


def _expand(u_x, u_y, u_sigma):
    """Expand base points to the (scales, rots) LUT with reference fp semantics."""
    scale_list = _scale_list()
    theta = np.arange(N_ROT, dtype=np.float64) * 2.0 * np.pi / float(N_ROT)
    cos_t = np.cos(theta)[None, :, None]
    sin_t = np.sin(theta)[None, :, None]
    sl = scale_list.astype(np.float64)[:, None, None]
    ux = u_x.astype(np.float64)[None, None, :]
    uy = u_y.astype(np.float64)[None, None, :]
    lut_x = (sl * (ux * cos_t - uy * sin_t)).astype(np.float32)
    lut_y = (sl * (ux * sin_t + uy * cos_t)).astype(np.float32)
    lut_sigma = ((SIGMA_SCALE * scale_list)[:, None] * u_sigma[None, :]).astype(
        np.float32
    )
    radius = np.sqrt(lut_x.astype(np.float64) ** 2 + lut_y.astype(np.float64) ** 2)
    size = np.ceil(radius + lut_sigma[:, None, :].astype(np.float64)) + 1
    size_list = size.reshape(SCALES, -1).max(axis=1).astype(np.int32)
    return lut_x, lut_y, lut_sigma, scale_list, size_list


def _long_pair_weights(u_x, u_y, long_pairs) -> np.ndarray:
    # weighted = int(d/|d|^2 * 2048 + 0.5), truncating (:273-280).
    i, j = long_pairs[:, 0], long_pairs[:, 1]
    dx = (u_x[j] - u_x[i]).astype(np.float32)
    dy = (u_y[j] - u_y[i]).astype(np.float32)
    norm_sq = (dx * dx + dy * dy).astype(np.float32).astype(np.float64)
    wdx = np.trunc(dx.astype(np.float64) / norm_sq * 2048.0 + 0.5).astype(np.int32)
    wdy = np.trunc(dy.astype(np.float64) / norm_sq * 2048.0 + 0.5).astype(np.int32)
    return np.stack([wdx, wdy], axis=1)


def _pattern(u_x, u_y, u_sigma, short_pairs, long_pairs) -> BriskPattern:
    lut_x, lut_y, lut_sigma, scale_list, size_list = _expand(u_x, u_y, u_sigma)
    return BriskPattern(
        lut_x=lut_x,
        lut_y=lut_y,
        lut_sigma=lut_sigma,
        scale_list=scale_list,
        size_list=size_list,
        short_pairs=short_pairs,
        long_pairs=long_pairs,
        long_weights=_long_pair_weights(u_x, u_y, long_pairs),
    )


@functools.lru_cache(maxsize=4)
def brisk_v2_pattern(pattern_scale: float = 1.0) -> BriskPattern:
    """The default BRISK v2 pattern: 66 points, 384 short / 856 long pairs."""
    with np.load(_PATTERN_NPZ) as data:
        pts = data["points"]
        short_pairs = data["short_pairs"].astype(np.int32)
        long_pairs = data["long_pairs"].astype(np.int32)
    ps = np.float32(pattern_scale)
    u_x = (pts[:, 0].astype(np.float32) * ps).astype(np.float32)
    u_y = (pts[:, 1].astype(np.float32) * ps).astype(np.float32)
    u_sigma = (pts[:, 2].astype(np.float32) * ps).astype(np.float32)
    return _pattern(u_x, u_y, u_sigma, short_pairs, long_pairs)


@functools.lru_cache(maxsize=4)
def pattern_from_file(path: str, pattern_scale: float = 1.0) -> BriskPattern:
    """A runtime ``.ptn`` pattern file (the reference's file ctor and
    ``InitFromStream``, brisk-descriptor-extractor.cc:357-367, 180-291).

    Whitespace-separated tokens: the point count, (x, y, sigma) per point
    (each multiplied by ``pattern_scale`` on read), the short-pair count and
    pairs, the long-pair count and pairs. The long-pair weights come from
    the scaled base points, as ``InitFromStream`` computes them.
    """
    with open(path) as f:
        tok = iter(f.read().split())

    def nxt() -> float:
        return float(next(tok))

    n = int(nxt())
    pts = np.array([[nxt(), nxt(), nxt()] for _ in range(n)], dtype=np.float64)
    ps = np.float32(pattern_scale)
    u_x = (pts[:, 0].astype(np.float32) * ps).astype(np.float32)
    u_y = (pts[:, 1].astype(np.float32) * ps).astype(np.float32)
    u_sigma = (pts[:, 2].astype(np.float32) * ps).astype(np.float32)
    n_short = int(nxt())
    short_pairs = np.array([[int(nxt()), int(nxt())] for _ in range(n_short)], dtype=np.int32)
    n_long = int(nxt())
    long_pairs = np.array([[int(nxt()), int(nxt())] for _ in range(n_long)], dtype=np.int32)
    return _pattern(u_x, u_y, u_sigma, short_pairs.reshape(-1, 2), long_pairs.reshape(-1, 2))


@functools.lru_cache(maxsize=4)
def brisk_v1_pattern(pattern_scale: float = 1.0) -> BriskPattern:
    """The BRISK 1.0 ring pattern (``generateKernel``, brisk-v1.cc:76-205):
    rings of radius 0.85 * pattern_scale * {0, 2.9, 4.9, 7.4, 10.8} with
    {1, 10, 14, 15, 20} points (60 in all); short pairs |d| < 5.85 *
    pattern_scale (512), long pairs |d| > 8.2 * pattern_scale (870), so a
    descriptor is 16 words.

    v1 builds the whole table with its own float chains, not v2's
    ``_expand`` (the JAX package's ``brisk_v1_pattern`` gives each,
    checked against the compiled reference):
    * in brisk-v1.cc, ``log`` resolves to the float overload, so
      lb_scale = float(double(logf(30.f)) / log(2.0));
    * scaleList[s] = float(pow(2.0, double(float(s * lb_scale_step))));
    * x = float(double(float(scale * radius)) * cos(alpha + theta)), alpha
      and theta in double;
    * the sigma of ring 0 is float(double(float(1.3f * scale)) * 0.5), of
      the other rings float(double(float(1.3f * scale)) * double(radius) *
      sin(pi / n)).
    """
    f32, f64 = np.float32, np.float64
    fac = f64(0.85) * pattern_scale
    radius_list = np.array([f32(fac * c) for c in (0.0, 2.9, 4.9, 7.4, 10.8)], f32)
    number_list = [1, 10, 14, 15, 20]
    d_max = f32(f64(5.85) * pattern_scale)
    d_min = f32(f64(8.2) * pattern_scale)

    lb_scale = f32(np.log(f32(30.0)).astype(f64) / np.log(f64(2.0)))
    lb_step = f32(lb_scale / f32(SCALES))
    scale_list = np.power(
        2.0, (np.arange(SCALES).astype(f32) * lb_step).astype(f32).astype(f64)
    ).astype(f32)

    rings = np.repeat(np.arange(5), number_list)
    alpha = np.concatenate(
        [np.arange(n, dtype=f64) * 2.0 * np.pi / f64(n) for n in number_list])
    rad_pt = radius_list[rings]
    s13 = (f32(1.3) * scale_list).astype(f32)
    sinfac = np.array([0.0] + [np.sin(np.pi / f64(n)) for n in number_list[1:]])
    lut_sigma = np.where(
        rings[None, :] == 0,
        s13[:, None].astype(f64) * 0.5,
        (s13[:, None].astype(f64) * rad_pt[None, :].astype(f64)) * sinfac[rings][None, :],
    ).astype(f32)

    sr = (scale_list[:, None] * rad_pt[None, :]).astype(f32)
    theta = np.arange(N_ROT, dtype=f64)[:, None] * 2.0 * np.pi / f64(N_ROT)
    ang = alpha[None, :] + theta
    lut_x = (sr[:, None, :].astype(f64) * np.cos(ang)[None]).astype(f32)
    lut_y = (sr[:, None, :].astype(f64) * np.sin(ang)[None]).astype(f32)
    # size = ceil(float(scale * radius) + sigma) + 1, the largest over the
    # points (both terms are the same at every rotation).
    size_list = np.ceil((sr + lut_sigma).astype(f64)).max(axis=1).astype(np.int32) + 1

    # Pairs over i > j from the scale 0, rotation 0 points (brisk-v1.cc:181-205);
    # a pair is long first, else short (:196).
    u_x, u_y = lut_x[0, 0], lut_y[0, 0]
    ii, jj = np.tril_indices(len(u_x), k=-1)
    dx = (u_x[jj] - u_x[ii]).astype(f32)
    dy = (u_y[jj] - u_y[ii]).astype(f32)
    norm_sq = (dx * dx + dy * dy).astype(f32)
    long_mask = norm_sq > f32(d_min * d_min)
    short_mask = ~long_mask & (norm_sq < f32(d_max * d_max))
    short_pairs = np.stack([ii[short_mask], jj[short_mask]], 1).astype(np.int32)
    long_pairs = np.stack([ii[long_mask], jj[long_mask]], 1).astype(np.int32)
    return BriskPattern(
        lut_x=lut_x,
        lut_y=lut_y,
        lut_sigma=lut_sigma,
        scale_list=scale_list,
        size_list=size_list,
        short_pairs=short_pairs,
        long_pairs=long_pairs,
        long_weights=_long_pair_weights(u_x, u_y, long_pairs),
    )

"""BRISK v2 sampling-pattern lookup tables (port of ``core/pattern.py``).

Host-side NumPy, identical arithmetic to the JAX package's module so the
tables come out bit-equal: 66 base points read from
``brisk_v2_pattern.npz`` (a copy of the JAX package's table), expanded to
64 scales x 1024 rotations with float32 storage and float64 trig, per-point
Gaussian sigmas, short/long pair lists and integer long-pair gradient
weights (brisk-descriptor-extractor.cc:180-291).
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

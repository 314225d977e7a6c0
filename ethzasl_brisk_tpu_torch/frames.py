"""Synthetic VGA frames, the fallback frames of the benchmark.

Reproduces ``bench.py:bench_frames`` when the reference images are absent:
uniform noise from ``numpy.random.default_rng(7)``, smoothed by a 5x5 box
filter with ``mode="nearest"``, clipped and cast to uint8.
"""
from __future__ import annotations

import numpy as np

H, W = 480, 640


def bench_frames(batch: int, h: int = H, w: int = W, seed: int = 7) -> np.ndarray:
    """(batch, h, w) uint8 smoothed-noise frames."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (batch, h, w)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((1, 5, 5)) / 25.0, mode="nearest")
    return np.clip(sm, 0, 255).astype(np.uint8)

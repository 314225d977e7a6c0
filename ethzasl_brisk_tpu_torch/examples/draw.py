"""Headless match/keypoint visualization (the reference visualizer's
drawing, livedemo.cc:224-296 / cv::drawMatches, without a GUI); numpy
only, a copy of the JAX package's ``examples/draw.py``. Pass host
keypoints, for example ``kps.map(lambda a: a.cpu().numpy())``."""
from __future__ import annotations

import numpy as np


def _circle(img, cx, cy, r, val):
    h, w = img.shape
    n = max(int(2 * np.pi * r), 8)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    xs = np.clip((cx + r * np.cos(ang)).astype(int), 0, w - 1)
    ys = np.clip((cy + r * np.sin(ang)).astype(int), 0, h - 1)
    img[ys, xs] = val


def _line(img, x0, y0, x1, y1, val):
    h, w = img.shape
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.clip(np.linspace(x0, x1, n).astype(int), 0, w - 1)
    ys = np.clip(np.linspace(y0, y1, n).astype(int), 0, h - 1)
    img[ys, xs] = val


def draw_keypoints(frame: np.ndarray, x, y, size, valid) -> np.ndarray:
    """Keypoint circles (radius = size/2) on a copy of the frame."""
    img = frame.copy()
    for xi, yi, si in zip(x[valid], y[valid], size[valid]):
        _circle(img, float(xi), float(yi), max(float(si) / 2, 2.0), 255)
    return img


def draw_matches(
    frame_a: np.ndarray,
    frame_b: np.ndarray,
    kps,                     # host KeyPoints (numpy fields), batched (B, K)
    pair_idx: int,           # match pair (a=pair_idx, b=pair_idx+1)
    midx: np.ndarray,        # (K,) best train index per query keypoint
    mdist: np.ndarray,       # (K,) distances
    max_dist: int = 90,
) -> np.ndarray:
    """Side-by-side pair with keypoint circles and match lines
    (query = frame b, train = frame a, FramePipeline convention)."""
    h, w = frame_a.shape
    canvas = np.zeros((h, 2 * w), np.uint8)
    a, b = pair_idx, pair_idx + 1
    canvas[:, :w] = draw_keypoints(
        frame_a, kps.x[a], kps.y[a], kps.size[a], kps.valid[a]
    )
    canvas[:, w:] = draw_keypoints(
        frame_b, kps.x[b], kps.y[b], kps.size[b], kps.valid[b]
    )
    good = kps.valid[b] & (mdist < max_dist)
    for q in np.flatnonzero(good):
        t = int(midx[q])
        if not kps.valid[a][t]:
            continue
        _line(
            canvas,
            float(kps.x[a][t]), float(kps.y[a][t]),
            float(kps.x[b][q]) + w, float(kps.y[b][q]),
            255,
        )
    return canvas

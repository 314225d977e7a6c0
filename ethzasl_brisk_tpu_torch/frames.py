"""Synthetic frames: the benchmark's fallback frames and the VO scene.

``bench_frames`` reproduces ``bench.py:bench_frames`` when the reference
images are absent: uniform noise from ``numpy.random.default_rng(7)``,
smoothed by a 5x5 box filter with ``mode="nearest"``, clipped and cast to
uint8. ``make_texture``, ``trajectory`` and ``render_scene`` are the
synthetic VO sequence of the JAX package's VO tests and tools
(``tests/test_vo.py:render_scene``, ``tools/synthetic_vo_bench.py``): a
textured two-depth scene rendered along a known camera path.
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


def make_texture(rng: np.random.Generator, h: int = 1024, w: int = 1024) -> np.ndarray:
    """(h, w) uint8 multi-octave noise, structure at several scales so
    BRISK finds corners at every pyramid level (the synthetic VO
    benchmark's texture)."""
    from scipy import ndimage

    tex = np.zeros((h, w))
    for sigma, amp in ((1.5, 1.0), (6.0, 1.0), (24.0, 0.8)):
        noise = ndimage.gaussian_filter(rng.uniform(-1, 1, (h, w)), sigma)
        tex += amp * noise / max(sigma / 8.0, 1.0)
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-9)
    return (tex * 255).astype(np.uint8)


def trajectory(n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """n camera-from-world poses (R, t) along a smooth arc: forward motion,
    gentle yaw and lateral sway."""
    poses = []
    for i in range(n):
        a = 0.004 * i
        yaw = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        t = np.array([0.05 * i + 0.01 * np.sin(0.08 * i), 0.004 * np.sin(0.05 * i), 0.012 * i])
        poses.append((yaw, t))
    return poses


def render_scene(texture: np.ndarray, cam, r: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(cam.height, cam.width) uint8 view of a two-depth scene (a far plane
    at z = 6 and a near slab at z = 3) from camera-from-world pose (r, t).
    A single plane is degenerate for the essential matrix; the slab adds
    the parallax a well-conditioned two-view geometry needs. ``cam`` is
    any pinhole camera with fu, fv, cu, cv, width and height."""
    from scipy import ndimage

    h, w = cam.height, cam.width
    ys, xs = np.mgrid[0:h, 0:w]
    xn = (xs - float(cam.cu)) / float(cam.fu)
    yn = (ys - float(cam.cv)) / float(cam.fv)
    rays = np.stack([xn, yn, np.ones_like(xn)], -1)  # posed-camera rays

    def backproject(z0):
        # p_c = lam * ray; p_w = r.T (p_c - t); p_w.z = z0.
        rinv = r.T
        d = rays @ rinv.T          # direction of p_w per unit lam
        o = -(rinv @ t)            # p_w at lam = 0
        lam = (z0 - o[2]) / d[..., 2]
        return o + d * lam[..., None]

    def tex_at(pw):
        u = pw[..., 0] / pw[..., 2] * float(cam.fu) + float(cam.cu)
        v = pw[..., 1] / pw[..., 2] * float(cam.fv) + float(cam.cv)
        return ndimage.map_coordinates(texture.astype(np.float32), [v, u], order=1, mode="nearest")

    pw_near = backproject(3.0)
    pw_far = backproject(6.0)
    near_mask = (np.abs(pw_near[..., 0]) < 1.1) & (np.abs(pw_near[..., 1]) < 0.85)
    img = np.where(near_mask, tex_at(pw_near), tex_at(pw_far))
    return img.astype(np.uint8)

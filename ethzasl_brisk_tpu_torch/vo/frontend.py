"""Monocular visual-odometry front-end on BRISK tracks (port of
``vo/frontend.py``).

Composition, per frame pair:

  detect+describe (``pipeline.BriskFeature``: K1 once, K2 twice) ->
  ratio+cross-check matching (``match.matcher``) -> unprojection through
  the camera (``geometry.cameras``) -> batched-hypothesis essential RANSAC
  + cheirality decomposition + Gauss-Newton refinement
  (``geometry.ransac``) -> relative pose (R, t_unit).

Monocular scale is unobservable; translation is left at unit norm
(callers integrate scale from an external prior, e.g. ground-truth step
norms for a benchmark's ATE, or the BA layer).

The front-end runs on its feature's device (the card unless the feature
was built with ``device="cpu"``), but for the matches' rays and the
8-point hypotheses' SVD, which run on the host on every device so that the
card takes the CPU's hypotheses (``relative_pose``). Where the JAX methods
take a PRNG key, these take a ``torch.Generator`` on that device; an
optional ``draw(n_hyp, k, weights) -> samples`` callable replaces the
RANSAC draw.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.geometry.cameras import PinholeCamera
from ethzasl_brisk_tpu_torch.geometry.ransac import (
    decompose_essential,
    draw_samples,
    ransac_essential,
    refine_relative_pose,
)
from ethzasl_brisk_tpu_torch.match.matcher import match_with_ratio_and_crosscheck
from ethzasl_brisk_tpu_torch.pipeline import BriskFeature

Draw = Callable[[int, int, torch.Tensor], torch.Tensor]


def _no_mark(stage: str) -> None:
    pass


@dataclasses.dataclass(frozen=True)
class VoConfig:
    max_hamming: int = 80
    ratio_num: int = 8
    ratio_den: int = 10
    ransac_threshold: float = 2e-5   # Sampson, normalized coords
    ransac_hypotheses: int = 512
    min_inliers: int = 30
    refine_iterations: int = 10      # GN Sampson refinement (0 = off)
    # Per-frame affine photometric normalization before detection:
    # exposure drift (gain/bias) shifts Harris responses across the
    # absolute threshold, destabilizing the detected keypoint set even
    # though BRISK's intensity-comparison bits are order-invariant.
    normalize_exposure: bool = False
    norm_target_mean: float = 128.0
    norm_target_std: float = 48.0
    # Minimum spatial spread of the RANSAC inlier consensus, as the
    # inlier bounding-box area fraction of the frame. A consensus
    # concentrated in a small region is the signature of a coherently-
    # moving foreground object winning the vote; its epipolar geometry
    # describes the object's motion, not the camera's. 0 disables.
    min_inlier_spread: float = 0.0


def normalize_exposure_u8(img: torch.Tensor, target_mean: float = 128.0,
                          target_std: float = 48.0) -> torch.Tensor:
    """Affine-normalize a uint8/uint16 frame to a fixed mean/std (u8 out).

    Inverse-gain/bias correction: order-preserving, so descriptor
    comparison bits are unchanged up to requantization; detection
    thresholds see a stationary intensity distribution. The std has no
    Bessel correction (``jnp.std``'s); rounding is half to even in both.
    """
    f = img.to(torch.float32)
    m = torch.mean(f)
    s = torch.std(f, correction=0) + 1e-6
    out = (f - m) * (target_std / s) + target_mean
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class VoFrontend:
    """Frame-to-frame monocular VO."""

    camera: PinholeCamera
    feature: BriskFeature
    config: VoConfig = VoConfig()

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def process_frame(self, img: torch.Tensor):
        """One (H, W) frame (host or device) -> (keypoints, descriptors) on
        the front-end's device."""
        img = img.to(self.device)
        if self.config.normalize_exposure:
            img = normalize_exposure_u8(
                img, self.config.norm_target_mean, self.config.norm_target_std
            )
        return self.feature.detect_and_compute(img)

    def relative_pose(
        self,
        generator: torch.Generator | None,
        kp_a: KeyPoints,
        desc_a: torch.Tensor,
        kp_b: KeyPoints,
        desc_b: torch.Tensor,
        draw: Draw | None = None,
        mark: Callable[[str], None] = _no_mark,
        dtype: torch.dtype = torch.float32,
    ):
        """Relative pose b->a: returns (R, t_unit, n_inliers, ok, inliers),
        five values as the JAX method's (its docstring names four).

        The RANSAC samples come from ``draw(n_hyp, 8, matched)`` when given,
        else from ``generator``. ``dtype`` is the float width of the rays,
        RANSAC and the refinement (the JAX package's follows its x64 flag).
        ``mark(stage)`` is called after the match, the RANSAC +
        decomposition and the refinement.
        """
        cfg = self.config
        best, matched = match_with_ratio_and_crosscheck(
            desc_a, desc_b, kp_a.valid, kp_b.valid,
            max_distance=cfg.max_hamming, ratio_num=cfg.ratio_num, ratio_den=cfg.ratio_den,
        )
        best = best.to(torch.int64)
        pa = torch.stack([kp_a.x, kp_a.y], dim=-1)
        pb = torch.stack([kp_b.x[best], kp_b.y[best]], dim=-1)
        # The rays on the host on every device: the card's vector norm rounds
        # otherwise than the CPU's in the last bit, and on a weak pair that
        # bit picks another RANSAC hypothesis (geometry/ransac.py's docstring).
        dev = pa.device
        ra3 = self.camera.unproject(pa.to(dtype).cpu()).to(dev)
        rb3 = self.camera.unproject(pb.to(dtype).cpu()).to(dev)
        ra = ra3[..., :2] / ra3[..., 2:3]
        rb = rb3[..., :2] / rb3[..., 2:3]
        mark("match")

        if draw is None:
            samples = draw_samples(generator, cfg.ransac_hypotheses, 8, matched)
        else:
            samples = draw(cfg.ransac_hypotheses, 8, matched)
        e, inl, n_inl = ransac_essential(
            None, ra, rb, matched, threshold=cfg.ransac_threshold,
            n_hypotheses=cfg.ransac_hypotheses, samples=samples, dtype=ra.dtype,
        )
        r, t, _ = decompose_essential(e, ra, rb, inl)
        mark("ransac")
        if cfg.refine_iterations > 0:
            r, t, _ = refine_relative_pose(
                r, t, ra, rb, inl.to(ra.dtype), iterations=cfg.refine_iterations,
            )
        ok = n_inl >= cfg.min_inliers
        if cfg.min_inlier_spread > 0.0:
            big = 1e9
            x, y = pa[..., 0], pa[..., 1]
            ix = torch.where(inl, x, big).min()
            iy = torch.where(inl, y, big).min()
            jx = torch.where(inl, x, -big).max()
            jy = torch.where(inl, y, -big).max()
            area = torch.clamp(jx - ix, min=0.0) * torch.clamp(jy - iy, min=0.0)
            # The bound in float32, as JAX multiplies the Python fraction
            # into its float32 frame area.
            frame_area = np.float32(float(self.camera.width) * float(self.camera.height))
            ok = ok & (area >= float(np.float32(cfg.min_inlier_spread) * frame_area))
        mark("refine")
        return r, t, n_inl, ok, inl

    def run_sequence(self, frames, generator: torch.Generator | None = None,
                     scale_norms=None, draw: Draw | None = None):
        """Host loop: integrate frame-to-frame poses over a sequence.

        frames: iterable of (H, W) uint8 numpy arrays or tensors.
        scale_norms: optional per-step translation magnitudes (monocular
        scale prior); defaults to 1. ``generator`` defaults to one on the
        front-end's device seeded with 0.
        Returns list of 4x4 world-from-camera poses (first = identity).
        """
        if generator is None and draw is None:
            generator = torch.Generator(self.device).manual_seed(0)
        poses = [np.eye(4)]
        prev = None
        for i, frame in enumerate(frames):
            cur = self.process_frame(torch.as_tensor(frame))
            if prev is not None:
                r, t, _, ok, _ = self.relative_pose(
                    generator, prev[0], prev[1], cur[0], cur[1], draw=draw
                )
                s = 1.0 if scale_norms is None else float(scale_norms[i - 1])
                poses.append(integrate(poses[-1], r, t, s, ok))
            prev = cur
        return poses


def integrate(pose: np.ndarray, r: torch.Tensor, t: torch.Tensor, scale: float,
              ok: torch.Tensor) -> np.ndarray:
    """The next world-from-camera pose from a relative pose (points_b = R
    points_a + t, camera b seen from a, inverted for world integration);
    a lost pair (``ok`` false) holds the pose."""
    r = r.cpu().numpy()
    t = t.cpu().numpy()
    t_ab = np.eye(4)
    t_ab[:3, :3] = r.T
    t_ab[:3, 3] = -r.T @ (t * scale)
    return pose @ t_ab if bool(ok) else pose.copy()

"""Detect + describe facade (port of ``pipeline.py``'s ``BriskFeature``).

``BriskFeature`` = ``ScaleSpaceFeatureDetector<HarrisScoreCalculator>`` +
``BriskDescriptorExtractor`` (brisk-feature.h:54-114), working on batches
of uint8 frames ``(B, H, W)``. It is an ``nn.Module`` whose buffers are the
pattern tables, so ``.to(device)`` moves them.

Ported knobs: octaves, uniformity_radius, absolute_threshold, max_num_kpt,
max_candidates, max_keypoints, refine_capacity, uniformity_block and
describe_capacity; descriptors are rotation- and scale-invariant v2. The
JAX package's TPU backend selectors (sampler, patch sizes, top-k
backend, fused mask) have no counterpart: the CUDA kernels need none.
"""
from __future__ import annotations

import torch
from torch import nn

from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.core.pattern import brisk_v2_pattern
from ethzasl_brisk_tpu_torch.describe.extractor import (
    PATTERN_FIELDS,
    DevicePattern,
    extract_descriptors_compact,
)
from ethzasl_brisk_tpu_torch.detect.scale_space import (
    DetectorConfig,
    Mark,
    _no_mark,
    detect_keypoints,
)


class BriskFeature(nn.Module):
    """Composite detector + extractor with the reference's knobs."""

    def __init__(
        self,
        octaves: int = 0,
        uniformity_radius: float = 30.0,
        absolute_threshold: float = 0.0,
        max_num_kpt: int = 2**31 - 1,
        max_candidates: "int | tuple" = 4096,
        max_keypoints: int = 4096,
        refine_capacity: "int | tuple | None" = None,
        uniformity_block: int = 256,
        describe_capacity: int = 0,
        pattern: DevicePattern | None = None,
    ):
        super().__init__()
        self.config = DetectorConfig(
            octaves=octaves,
            uniformity_radius=uniformity_radius,
            absolute_threshold=absolute_threshold,
            max_num_kpt=max_num_kpt,
            max_candidates=max_candidates,
            max_keypoints=max_keypoints,
            refine_capacity=refine_capacity,
            uniformity_block=uniformity_block,
        )
        self.max_keypoints = max_keypoints
        # Per-frame budget of describable keypoints (0 = describe every slot).
        self.describe_capacity = describe_capacity
        if pattern is None:
            pattern = DevicePattern.from_host(brisk_v2_pattern())
        for name in PATTERN_FIELDS:
            self.register_buffer(name, getattr(pattern, name))

    @property
    def pattern(self) -> DevicePattern:
        return DevicePattern(**{name: getattr(self, name) for name in PATTERN_FIELDS})

    def detect(self, imgs: torch.Tensor, with_diagnostics: bool = False,
               mark: Mark = _no_mark):
        """(B, H, W) uint8 -> KeyPoints (B, C) [+ DetectDiagnostics]."""
        out = detect_keypoints(imgs, self.config, with_diagnostics, mark=mark)
        kps, diag = out if with_diagnostics else (out, None)
        if kps.capacity > self.max_keypoints:
            kps = kps.top_k(self.max_keypoints)
        return (kps, diag) if with_diagnostics else kps

    def describe(self, imgs: torch.Tensor, kps: KeyPoints, with_diagnostics: bool = False):
        """Orientation + descriptors: (KeyPoints, (B, K, 12) int32 words)
        [+ the batch's describable count]."""
        b = imgs.shape[0]
        cap = self.describe_capacity * b if self.describe_capacity else b * kps.capacity
        return extract_descriptors_compact(
            self.pattern, imgs, kps, capacity=cap, with_diagnostics=with_diagnostics
        )

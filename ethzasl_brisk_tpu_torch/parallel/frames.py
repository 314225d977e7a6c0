"""Batched detect + describe + match step (port of ``parallel/frames.py``).

On one GPU the JAX package's (data, model) mesh has no counterpart: the
batch of frames is one tensor, and ``step`` detects and describes every
frame, then matches each frame against the one before it, the building
block of the VO front-end and of the throughput benchmark.
"""
from __future__ import annotations

import dataclasses

import torch

from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.detect.scale_space import Mark, _no_mark
from ethzasl_brisk_tpu_torch.match.matcher import match_adjacent
from ethzasl_brisk_tpu_torch.pipeline import BriskFeature


@dataclasses.dataclass
class FramePipeline:
    """The step on ``device``: the card unless ``device="cpu"``. The
    feature must live there too (build it with the same ``device``)."""

    feature: BriskFeature
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.feature.device != self.device:
            raise ValueError(
                f"the feature runs on {self.feature.device}, the pipeline on {self.device}: "
                "build both with the same device"
            )

    def step(self, frames: torch.Tensor, with_diagnostics: bool = False,
             mark: Mark = _no_mark):
        """frames: (B, H, W) uint8 (uint16 raises: the batched describe is
        uint8 only), moved to the pipeline's device.

        Returns, on that device, (keypoints (B, K), descriptors (B, K, 12)
        int32 words, match_idx (B-1, K) int32, match_dist (B-1, K) int32),
        and with ``with_diagnostics`` a dict holding the DetectDiagnostics
        (``detect``) and the batch's describable count (``describable``).
        ``mark(stage)`` is called after each stage.
        """
        frames = frames.to(self.device)
        kps, diag = self.feature.detect(frames, with_diagnostics=True, mark=mark)
        kps, desc, n_desc = self.feature.describe(frames, kps, with_diagnostics=True)
        mark("describe")
        midx, mdist = match_adjacent(desc, kps.valid)
        mark("match")
        if with_diagnostics:
            return kps, desc, midx, mdist, {"detect": diag, "describable": n_desc}
        return kps, desc, midx, mdist

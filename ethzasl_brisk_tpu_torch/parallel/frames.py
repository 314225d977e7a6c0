"""Batched detect + describe + match step (port of ``parallel/frames.py``).

On one GPU the JAX package's (data, model) mesh has no counterpart: the
batch of frames is one tensor, and ``step`` detects and describes every
frame, then matches each frame against the one before it, the building
block of the VO front-end and of the throughput benchmark.
``AstFramePipeline`` is the same step around the classic AGAST/OAST
detector (``BriskFeatureDetector``), bench.py's ``BENCH_PIPELINE=ast``.
"""
from __future__ import annotations

import dataclasses

import torch

from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.core.selectors import check_extractor_selectors
from ethzasl_brisk_tpu_torch.describe.extractor import (
    check_u8_batch,
    extract_descriptors_compact,
)
from ethzasl_brisk_tpu_torch.detect.scale_space import Mark, _no_mark
from ethzasl_brisk_tpu_torch.match.matcher import match_adjacent
from ethzasl_brisk_tpu_torch.pipeline import BriskFeature, BriskFeatureDetector


def _same_device(module, device) -> torch.device:
    dev = resolve_device(device)
    if module.device != dev:
        raise ValueError(
            f"the {type(module).__name__} runs on {module.device}, the pipeline on {dev}: "
            "build both with the same device"
        )
    return dev


@dataclasses.dataclass
class FramePipeline:
    """The step on ``device``: the card unless ``device="cpu"``. The
    feature must live there too (build it with the same ``device``)."""

    feature: BriskFeature
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = _same_device(self.feature, self.device)

    def step(self, frames: torch.Tensor, with_diagnostics: bool = False,
             mark: Mark = _no_mark):
        """frames: (B, H, W) uint8 (uint16 raises: the batched describe is
        uint8 only), moved to the pipeline's device.

        Returns, on that device, (keypoints (B, K), descriptors (B, K, W)
        int32 words, match_idx (B-1, K) int32, match_dist (B-1, K) int32),
        and with ``with_diagnostics`` a dict holding the DetectDiagnostics
        (``detect``) and the batch's describable count (``describable``).
        ``mark(stage)`` is called after each stage. As the JAX step
        (``_pipeline_step``), the match counts the first 384 bits with
        sentinel 385 whatever W, and the describe rounds as v2.
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


@dataclasses.dataclass
class AstFramePipeline:
    """The classic-BRISK (AGAST/OAST) batched detect + describe + match
    step on ``device``, the card unless ``device="cpu"``; the detector must
    live there too.

    ``describe_capacity`` is the budget of describable keypoints per frame
    (0 describes every slot): the batch's first ``describe_capacity * B``
    describable keypoints in flat order are described, the rest dropped
    (``extract_descriptors_compact``). ``sampler``, ``patch_h`` and
    ``patch_w`` are the JAX package's sampler selectors, checked no-ops:
    kernel K2 serves every describe.
    """

    detector: BriskFeatureDetector
    device: str | torch.device = "cuda"
    sampler: str = "patch_pallas"
    patch_h: int = 256
    patch_w: int = 256
    describe_capacity: int = 640

    def __post_init__(self):
        check_extractor_selectors(self.sampler, self.patch_h, self.patch_w)
        self.device = _same_device(self.detector, self.device)

    def step(self, frames: torch.Tensor, with_diagnostics: bool = False,
             mark: Mark = _no_mark):
        """frames: (B, H, W) uint8, moved to the pipeline's device.

        Returns (keypoints (B, K), descriptors (B, K, W) int32 words,
        match_idx (B-1, K) int32, match_dist (B-1, K) int32), and with
        ``with_diagnostics`` a dict holding the AstDiagnostics (``detect``)
        and the batch's describable count (``describable``). ``mark(stage)``
        is called after each stage: pyramid, layers, candidates, pass1, aux,
        pass2, describe, match.

        As the JAX step (``_ast_pipeline_step``): the match runs over all
        ``W * 32`` bits of the descriptors (512 for v1) with sentinel
        ``W * 32 + 1``, and the describe does not pass ``v1_rounding`` on,
        so a v1 detector describes with the v1 pattern and v2 rounding (the
        facade's ``detect_and_compute`` rounds as v1).
        """
        frames = frames.to(self.device)
        check_u8_batch(frames)
        det = self.detector
        kps, diag = det.detect(frames, with_diagnostics=True, mark=mark)
        b = frames.shape[0]
        cap = self.describe_capacity * b if self.describe_capacity else b * kps.capacity
        kps, desc, n_desc = extract_descriptors_compact(
            det.pattern, frames, kps, capacity=cap,
            rotation_invariant=det.rotation_invariant, scale_invariant=det.scale_invariant,
            with_diagnostics=True,
        )
        mark("describe")
        midx, mdist = match_adjacent(desc, kps.valid, n_bits=desc.shape[-1] * 32)
        mark("match")
        if with_diagnostics:
            return kps, desc, midx, mdist, {"detect": diag, "describable": n_desc}
        return kps, desc, midx, mdist

"""Detect + describe facades (port of ``pipeline.py``).

``BriskFeature`` = ``ScaleSpaceFeatureDetector<HarrisScoreCalculator>`` +
``BriskDescriptorExtractor`` (brisk-feature.h:54-114). It is an
``nn.Module`` whose extractor holds the pattern tables as buffers.

Both facades run on ``device``, the card unless the caller passes
``device="cpu"``: each call moves its image(s) there and returns its
outputs there.

``BriskFeature`` takes every keyword of the JAX ``BriskFeature``, so
bench.py's config dict builds one as it is. Ported knobs: octaves,
uniformity_radius, absolute_threshold, max_num_kpt, rotation_invariant,
scale_invariant, max_candidates, max_keypoints, refine_capacity,
uniformity_block (the CPU's blocked uniformity; the card's kernel
takes none), fused_mask (kernel K3 for the scores and 2-D maxima),
describe_capacity, refine_dtype ("float64" refines in double),
angle_exact (the host's double atan2) and version (``"v1"``: the v1 ring
pattern, 16-word descriptors and K2's v1 rounding on the Harris
detections). The JAX package's sampler, patch-size,
top-k and eager-detection selectors pick among formulations with equal
outputs; here kernel K2 serves every describe, a stable sort every top-k
and every float op rounds on its own, so they are checked no-ops
(``core/selectors.py``).

Single image or batch: ``detect``, ``detect_with_diagnostics``, ``compute``
and ``detect_and_compute`` dispatch on ``img.dim()``. An (H, W) uint8 or
uint16 image gives unbatched outputs, as the JAX methods do: KeyPoints
(K,), a DetectDiagnostics without batch axis, (K, 12) int32 descriptor
words, and ``compute`` describes every slot (``describe_capacity`` does not
apply). uint16 takes the 16-bit pipeline (float Harris scores, warps and
sampler). A (B, H, W) uint8 batch gives the same with a leading batch axis;
a uint16 batch raises, since the JAX package's batched describe is uint8
only. ``describe`` is the batched describe over the ``describe_capacity``
budget that ``FramePipeline`` runs.

``BriskFeatureDetector`` is the classic AGAST/OAST detector
(brisk-feature-detector.h:56-57) paired with ``BriskExtractor``, the
reference's AST golden run and match test; ``compute_scale`` re-detects
given keypoints through its scale space. It takes every keyword of the JAX
facade, so bench.py's AST keywords build one as they are. Detection runs
the candidates engine (``detect/ast_scale_space.py``) for every
``raw_cache_model`` and for ``detect_impl="dense"``, the JAX package's
whole-map engine, which is bitwise equal to it. ``version="v1"`` runs the
v1 engine end to end: its resamplers, plain OAST detection without the
threshold map, no scale-axis weak/edge gates, drop threshold 0
(brisk-v1.cc:595-1110) and the v1 extractor.
"""
from __future__ import annotations

import torch
from torch import nn

from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.core.selectors import (
    check_ast_selectors,
    check_detector_selectors,
)
from ethzasl_brisk_tpu_torch.describe.extractor import (
    BriskExtractor,
    DevicePattern,
    check_u8_batch,
    describe_budget,
    extract_descriptors_compact,
)
from ethzasl_brisk_tpu_torch.detect.ast_scale_space import detect_ast_keypoints
from ethzasl_brisk_tpu_torch.detect.scale_space import (
    DetectorConfig,
    Mark,
    _no_mark,
    detect_keypoints,
)


def _detect(config: DetectorConfig, max_keypoints: int, img: torch.Tensor,
            with_diagnostics: bool, mark: Mark):
    single = img.dim() == 2
    if not single:
        check_u8_batch(img)
    out = detect_keypoints(img[None] if single else img, config, with_diagnostics, mark=mark)
    kps, diag = out if with_diagnostics else (out, None)
    if kps.capacity > max_keypoints:
        kps = kps.top_k(max_keypoints)
    if single:
        kps = kps.map(lambda a: a[0])
        if diag is not None:
            diag = diag.frame(0)
    return (kps, diag) if with_diagnostics else kps


class BriskFeature(nn.Module):
    """Composite detector + extractor with the reference's knobs."""

    def __init__(
        self,
        octaves: int = 0,
        uniformity_radius: float = 30.0,
        absolute_threshold: float = 0.0,
        max_num_kpt: int = 2**31 - 1,
        rotation_invariant: bool = True,
        scale_invariant: bool = True,
        max_candidates: "int | tuple" = 4096,
        max_keypoints: int = 4096,
        refine_capacity: "int | tuple | None" = None,
        uniformity_block: int = 256,
        fused_mask: bool = False,
        describe_capacity: int = 0,
        pattern: DevicePattern | None = None,
        device: str | torch.device = "cuda",
        *,
        version: str = "v2",
        refine_dtype: str = "float32",
        angle_exact: bool = False,
        sampler: str = "gather",
        patch_h: int = 192,
        patch_w: int = 192,
        topk_impl: str = "sort",
        topk_block_size: int = 2048,
        topk_block_r: int = 256,
        eager_exact: bool = False,
    ):
        super().__init__()
        check_detector_selectors(topk_impl, topk_block_size, topk_block_r, eager_exact)
        self.config = DetectorConfig(
            octaves=octaves,
            uniformity_radius=uniformity_radius,
            absolute_threshold=absolute_threshold,
            max_num_kpt=max_num_kpt,
            max_candidates=max_candidates,
            max_keypoints=max_keypoints,
            refine_capacity=refine_capacity,
            uniformity_block=uniformity_block,
            fused_mask=fused_mask,
            refine_dtype=refine_dtype,
        )
        self.max_keypoints = max_keypoints
        # Per-frame budget of describable keypoints (0 = describe every slot).
        self.describe_capacity = describe_capacity
        self.extractor = BriskExtractor(
            rotation_invariant, scale_invariant, pattern=pattern, device=device,
            version=version, sampler=sampler, patch_h=patch_h, patch_w=patch_w,
            angle_exact=angle_exact,
        )

    @property
    def device(self) -> torch.device:
        return self.extractor.device

    @property
    def pattern(self) -> DevicePattern:
        return self.extractor.pattern

    @property
    def descriptor_bytes(self) -> int:
        """Bytes of one descriptor (48; 64 for v1)."""
        return self.extractor.descriptor_bytes

    def detect(self, img: torch.Tensor, with_diagnostics: bool = False,
               mark: Mark = _no_mark):
        """(H, W) uint8 or uint16, or (B, H, W) uint8 -> KeyPoints (K,) or
        (B, K) [+ DetectDiagnostics]. ``mark(stage)`` is called after each
        stage."""
        return _detect(self.config, self.max_keypoints, img.to(self.device), with_diagnostics,
                       mark)

    def detect_with_diagnostics(self, img: torch.Tensor):
        """detect() + a DetectDiagnostics certifying that no capacity
        truncated on this input; assert ``diag.ok`` on new data."""
        return self.detect(img, with_diagnostics=True)

    def compute(self, img: torch.Tensor, keypoints: KeyPoints):
        """Orientation + descriptors of every keypoint slot: (KeyPoints,
        (..., K, 12) int32 words)."""
        return self.extractor(img, keypoints)

    def detect_and_compute(self, img: torch.Tensor):
        """Detect, then compute, on one (H, W) image or a (B, H, W) batch."""
        img = img.to(self.device)
        return self.compute(img, self.detect(img))

    def describe(self, imgs: torch.Tensor, kps: KeyPoints, with_diagnostics: bool = False):
        """Batched describe over the describe budget: (KeyPoints, (B, K, W)
        int32 words) [+ the batch's describable count]. As the JAX step's
        describe, it does not pass ``v1_rounding`` on: a v1 feature describes
        a batch with the v1 pattern and v2 rounding."""
        dev = self.device
        cap = describe_budget(self.describe_capacity, imgs.shape[0], kps.capacity)
        return extract_descriptors_compact(
            self.pattern, imgs.to(dev), kps.map(lambda a: a.to(dev)), capacity=cap,
            rotation_invariant=self.extractor.rotation_invariant,
            scale_invariant=self.extractor.scale_invariant,
            with_diagnostics=with_diagnostics,
        )


class HarrisFeatureDetector:
    """Standalone single-scale Harris detector.

    Mirrors ``brisk::HarrisFeatureDetector(threshold, radius, maxKpts)``
    (harris-feature-detector.h:54-80) as the JAX package realises it: the
    octaves=0 ``BriskFeature`` detection, with max_keypoints = max_candidates.
    It runs on ``device`` (the card unless ``device="cpu"``).
    """

    def __init__(
        self,
        threshold: float = 0.0,
        uniformity_radius: float = 30.0,
        max_num_kpt: int = 2**31 - 1,
        max_candidates: int = 4096,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = DetectorConfig(
            octaves=0,
            uniformity_radius=uniformity_radius,
            absolute_threshold=threshold,
            max_num_kpt=max_num_kpt,
            max_candidates=max_candidates,
            max_keypoints=max_candidates,
        )

    def detect(self, img: torch.Tensor) -> KeyPoints:
        """(H, W) uint8 or uint16, or (B, H, W) uint8 -> KeyPoints (K,) or
        (B, K)."""
        return _detect(self.config, self.config.max_keypoints, img.to(self.device), False,
                       _no_mark)


class BriskFeatureDetector(nn.Module):
    """The classic AGAST/OAST detection facade with BRISK description.

    Mirrors ``brisk::BriskFeatureDetector(thresh, octaves,
    suppressScaleNonmaxima)`` (brisk-feature-detector.h:56-57) with a
    ``BriskDescriptorExtractor``, as in the reference's AST golden run
    (test-binary-equal.cc:322-331) and match test (test-match.cc).

    ``max_candidates_per_layer`` is an int or a per-layer tuple (overflow
    drops corners; ``detect_with_diagnostics`` certifies it did not).
    ``raw_cache_model`` picks the model of the reference's lazy score cache
    in the IsMax2D tie path: ``emulated`` (two vectorized passes),
    ``exact`` (a sequential loop over the candidates, bit for bit the
    reference; slow), ``cache`` or ``corner``. ``detect_impl`` and
    ``eager_exact`` are checked no-ops (``core/selectors.py``).
    ``version="v1"`` is the v1 engine end to end (the module docstring).
    It runs on ``device``, the card unless ``device="cpu"``.

    ``detect``, ``detect_with_diagnostics``, ``compute`` and
    ``detect_and_compute`` take one (H, W) uint8 image (unbatched outputs,
    as the JAX methods give) or a (B, H, W) batch.
    """

    def __init__(
        self,
        threshold: int = 70,
        octaves: int = 3,
        suppress_scale_nonmaxima: bool = True,
        rotation_invariant: bool = True,
        scale_invariant: bool = True,
        version: str = "v2",
        max_candidates_per_layer: "int | tuple" = 2048,
        raw_cache_model: str = "emulated",
        eager_exact: bool = False,
        angle_exact: bool = False,
        detect_impl: str = "candidates",
        *,
        pattern: DevicePattern | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        check_ast_selectors(detect_impl, raw_cache_model, suppress_scale_nonmaxima, eager_exact)
        self.threshold = threshold
        self.v1 = version == "v1"
        self.octaves = octaves
        self.suppress_scale_nonmaxima = suppress_scale_nonmaxima
        self.max_candidates_per_layer = max_candidates_per_layer
        self.raw_cache_model = raw_cache_model
        self.extractor = BriskExtractor(
            rotation_invariant, scale_invariant, pattern=pattern, device=device,
            version=version, angle_exact=angle_exact,
        )

    @property
    def device(self) -> torch.device:
        return self.extractor.device

    @property
    def pattern(self) -> DevicePattern:
        return self.extractor.pattern

    @property
    def descriptor_bytes(self) -> int:
        """Bytes of one descriptor (48; 64 for v1)."""
        return self.extractor.descriptor_bytes

    @property
    def rotation_invariant(self) -> bool:
        return self.extractor.rotation_invariant

    @property
    def scale_invariant(self) -> bool:
        return self.extractor.scale_invariant

    def _run(self, img: torch.Tensor, with_diagnostics: bool, mark: Mark, **kw):
        img = img.to(self.device)
        single = img.dim() == 2
        out = detect_ast_keypoints(
            img[None] if single else img, threshold=self.threshold, octaves=self.octaves,
            max_candidates_per_layer=self.max_candidates_per_layer,
            suppress_scale_nonmaxima=self.suppress_scale_nonmaxima,
            with_diagnostics=with_diagnostics, mark=mark, **kw,
        )
        kps, diag = out if with_diagnostics else (out, None)
        if single:
            kps = kps.map(lambda a: a[0])
            diag = diag.frame(0) if diag is not None else None
        return (kps, diag) if with_diagnostics else kps

    def detect(self, img: torch.Tensor, with_diagnostics: bool = False,
               mark: Mark = _no_mark):
        """(H, W) or (B, H, W) uint8 -> KeyPoints (K,) or (B, K) [+
        AstDiagnostics]. ``mark(stage)`` is called after each stage."""
        return self._run(img, with_diagnostics, mark, raw_cache_model=self.raw_cache_model,
                         v1=self.v1)

    def detect_with_diagnostics(self, img: torch.Tensor):
        """detect() + an AstDiagnostics certifying that the per-layer
        candidate capacities did not truncate on this input."""
        return self.detect(img, with_diagnostics=True)

    def compute(self, img: torch.Tensor, keypoints: KeyPoints):
        """Orientation + descriptors of every keypoint slot."""
        return self.extractor(img, keypoints)

    def detect_and_compute(self, img: torch.Tensor):
        """Detect, then compute, on one (H, W) image or a (B, H, W) batch."""
        img = img.to(self.device)
        return self.compute(img, self.detect(img))


def compute_scale(detector: BriskFeatureDetector, img: torch.Tensor,
                  keypoints: KeyPoints) -> KeyPoints:
    """Re-detect given keypoints through the AST scale space.

    ``BriskFeatureDetector::ComputeScale`` (brisk-feature-detector.cc:
    87-92): GetKeypoints in usePassedKeypoints mode (brisk-scale-space.cc:
    103-124) with overwrite_lower_thres=0. Every keypoint is mapped into
    every layer, the 2-D maximum check is skipped and the sub-pixel and 3-D
    refinement emit the refined keypoints, one slot per (keypoint, layer).
    ``img`` is (H, W) with (K,) keypoints or (B, H, W) with (B, K); both
    move to the detector's device. As the JAX function, it runs the v2
    engine whatever the detector's version.
    """
    kps = keypoints.map(lambda a: a.to(detector.device))
    if img.dim() == 2:
        kps = kps.map(lambda a: a[None])
    return detector._run(img, False, _no_mark, passed_keypoints=kps, lower_threshold=0)

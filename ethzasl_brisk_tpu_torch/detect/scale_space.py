"""BRISK v2 scale-space detection, Harris path (port of ``detect/scale_space.py``).

Mirrors ``ScaleSpaceFeatureDetector<HarrisScoreCalculator>``
(scale-space-feature-detector.h:62-136, scale-space-layer-inl.h:60-428)
over a batch of frames ``(B, H, W)``, uint8 or uint16:

* pyramid: layer 0 = input, layer 1 = two-thirds sample, layer i >= 2 =
  half-sample of layer i-2: on uint8 ``kernels/downsample.py``'s
  ``pyramid_u8``, on the card kernel ``pyramid_u8``, every layer in one
  launch; the 16-bit samplers' torch ops on uint16;
* Harris scores per layer (kernel K1 on the card), or with ``fused_mask``
  the scores and their 2-D maxima in one pass (kernel K3); on uint16 the
  float scores of ``harris_score_f32`` (torch ops; ``fused_mask`` does not
  apply, as in the JAX package);
* 2-D maxima, then the 3-D checks against the neighbour layers: the
  reference's bilinear ScoreAbove/ScoreBelow at affine-mapped coordinates
  are exact rationals, so ``center * D^2`` is compared with the
  integer-weighted bilinear sum in int64 (the JAX package splits the same
  sum into two int32 words because the TPU has no int64; the result is
  bit-equal): ``kernels/masks.py``, on the card kernel ``score_masks``,
  every layer in one launch; the float scores compare with a float
  bilinear warp (``warp_scores_f32``, torch ops), as in the JAX package;
* score-descending candidates per layer (ties go to the lower flat
  index, as ``lax.top_k``) and the masks' counts: ``kernels/candidates.py``,
  on the card kernel ``layer_candidates``, every layer in one launch;
* greedy uniformity (``detect/uniformity.py``);
* accepted-prefix compaction, sub-pixel refinement and coordinate
  un-mapping ``x = scale*((x+dx)+offset)``, in float32 or, with
  ``refine_dtype="float64"``, in float64 rounded once to float32 (the
  reference refines in double), packed layer-major, and the accepted
  counts: ``detect/refine.py``, on the card kernel ``refine_keypoints``,
  every layer in one launch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ethzasl_brisk_tpu_torch.detect.refine import refine_keypoints
from ethzasl_brisk_tpu_torch.detect.uniformity import bucket_keypoints, enforce_uniformity_layers
from ethzasl_brisk_tpu_torch.kernels.downsample import (
    halfsample16,
    pyramid_u8,
    twothirdsample16,
)
from ethzasl_brisk_tpu_torch.kernels.harris import (
    harris_score_f32,
    harris_score_i32_layers,
    harris_score_mask_layers,
)
from ethzasl_brisk_tpu_torch.kernels.candidates import layer_candidates
from ethzasl_brisk_tpu_torch.kernels.masks import score_masks
from ethzasl_brisk_tpu_torch.kernels.nms import max3x3_zero_fill as _max3x3_zero_fill
from ethzasl_brisk_tpu_torch.kernels.nms import maxima2d_mask, warp_taps

INT32_MAX = 2**31 - 1
REFINE_DTYPES = {"float32": torch.float32, "float64": torch.float64}

Mark = Callable[[str], None]


def _no_mark(name: str) -> None:
    pass


@dataclasses.dataclass(frozen=True)
class LayerGeometry:
    """Static geometry of one pyramid layer."""

    index: int
    is_octave: bool
    scale: float
    offset: float

    # Exact-rational affine map u -> (A*u + B) / D into the neighbour layer
    # (scale-space-layer-inl.h:143-156).
    @property
    def above_map(self) -> tuple[int, int, int]:
        return (4, -1, 6) if self.is_octave else (6, -1, 8)

    @property
    def below_map(self) -> tuple[int, int, int]:
        return (12, 2, 9) if self.is_octave else (24, 3, 16)


def layer_geometry(index: int) -> LayerGeometry:
    is_octave = index % 2 == 0
    scale = float(2 ** (index // 2)) * (1.0 if is_octave else 1.5)
    return LayerGeometry(index, is_octave, scale, scale * 0.5 - 0.5)


def build_pyramid(imgs: torch.Tensor, n_layers: int) -> list[torch.Tensor]:
    """Layer images: [img, 2/3(img), 1/2(img), 1/2(layer1), ...], with the
    8- or 16-bit samplers by dtype (scale-space-layer-inl.h:445-470); uint8
    through ``pyramid_u8`` (on the card kernel ``pyramid_u8``, every layer
    in one launch), uint16 by the 16-bit samplers' torch ops."""
    if imgs.dtype != torch.uint16:
        return pyramid_u8(imgs, n_layers)
    half, twothirds = halfsample16, twothirdsample16
    layers = [imgs]
    if n_layers > 1:
        layers.append(twothirds(imgs))
    for i in range(2, n_layers):
        layers.append(half(layers[i - 2]))
    return layers


def warp_scores_f32(
    src: torch.Tensor, affine: tuple[int, int, int], dst_shape: tuple[int, int]
) -> torch.Tensor:
    """Float bilinear sample of a neighbour layer's float scores, float32.

    The 16-bit pipeline's counterpart of ``kernels/masks.py``'s ``warp_scores``
    (HarrisScoreCalculatorFloat::Score, harris-score-calculator-float.h:
    57-74): the same taps, the fractions ``frac / D`` in float32 and the
    JAX package's order of operations.
    """
    d = affine[2]
    (p00, p01, p10, p11), fu, fv, valid = warp_taps(src, affine, dst_shape)
    fu_t = torch.as_tensor(fu.astype(np.float32) / float(d), device=src.device)[None, :]
    fv_t = torch.as_tensor(fv.astype(np.float32) / float(d), device=src.device)[:, None]
    out = (1.0 - fv_t) * ((1.0 - fu_t) * p00 + fu_t * p01) + fv_t * (
        (1.0 - fu_t) * p10 + fu_t * p11
    )
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=src.device))


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Mirrors the ScaleSpaceFeatureDetector ctor arguments
    (scale-space-feature-detector.h:69-77) plus the static capacities.

    ``max_candidates`` and ``refine_capacity`` may be per-layer tuples;
    overflow drops the lowest-priority entries, which
    :class:`DetectDiagnostics` reports.
    """

    octaves: int = 0
    uniformity_radius: float = 30.0
    absolute_threshold: float = 0.0
    max_num_kpt: int = 2**31 - 1
    max_candidates: "int | tuple" = 4096
    max_keypoints: int = 4096
    refine_capacity: "int | tuple | None" = None
    # The blocked uniformity form's block (the CPU route); kernel
    # enforce_uniformity on the card takes no block. Equal masks either way.
    uniformity_block: int = 256
    # Scores and 2-D maxima masks from one kernel (K3) instead of K1 then
    # maxima2d_mask; bit-identical either way. uint8 only.
    fused_mask: bool = False
    # The sub-pixel refine's float type: "float64" refines in double, as
    # the reference does (Subpixel2D takes doubles,
    # scale-space-layer-inl.h:560), and rounds x, y once to float32.
    refine_dtype: str = "float32"

    def __post_init__(self):
        if self.refine_dtype not in REFINE_DTYPES:
            raise ValueError(
                f"refine_dtype {self.refine_dtype!r}: the port refines in "
                f"{' or '.join(REFINE_DTYPES)}"
            )

    @property
    def n_layers(self) -> int:
        return max(self.octaves * 2, 1)

    def layer_cap(self, i: int) -> int:
        mc = self.max_candidates
        return mc[i] if isinstance(mc, tuple) else mc

    def refine_cap(self, i: int) -> "int | None":
        rc = self.refine_capacity
        if rc is None:
            return None
        return rc[i] if isinstance(rc, tuple) else rc


def layer_score_masks(
    pyramid: list[torch.Tensor], config: DetectorConfig, mark: Mark = _no_mark
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-layer (scores, candidate masks), each (B, h, w), for a pyramid.

    With ``config.fused_mask`` the ``harris`` stage also yields the 2-D
    maxima masks (kernel K3); otherwise they are computed in ``masks``.
    A uint16 pyramid takes the float scores and warps and ignores
    ``fused_mask``, as the JAX package does.
    """
    n_layers = len(pyramid)
    geoms = [layer_geometry(i) for i in range(n_layers)]
    is_float = pyramid[0].dtype == torch.uint16
    # The threshold truncates to int on the integer scores and rounds to
    # float32 on the float ones, as in the JAX package.
    thr = (float(np.float32(config.absolute_threshold)) if is_float
           else int(config.absolute_threshold))
    base_masks = None
    if is_float:
        scores = [harris_score_f32(im) for im in pyramid]
    elif config.fused_mask:
        pairs = harris_score_mask_layers(pyramid, thr)
        scores = [p[0] for p in pairs]
        base_masks = [p[1] for p in pairs]
    else:
        scores = harris_score_i32_layers(pyramid)
    mark("harris")
    if not is_float:
        # Kernel score_masks on the card (one launch for every layer), the
        # plain dense chain on the CPU.
        masks = score_masks(scores, thr, [(g.above_map, g.below_map) for g in geoms],
                            base_masks)
        mark("masks")
        return scores, masks
    masks = []
    for i in range(n_layers):
        sc = scores[i]
        h, w = sc.shape[-2:]
        mask = maxima2d_mask(sc, thr)
        if i + 1 < n_layers:
            above = warp_scores_f32(scores[i + 1], geoms[i].above_map, (h, w))
            mask &= sc >= _max3x3_zero_fill(above)
        if i > 0:
            mask &= sc >= warp_scores_f32(scores[i - 1], geoms[i].below_map, (h, w))
        masks.append(mask)
    mark("masks")
    return scores, masks


class DetectDiagnostics(NamedTuple):
    """Exactness certificate for the static capacities, per frame.

    ``ok`` holds when no per-layer candidate cap and no refine cap
    truncated on that frame. Fields have a leading batch axis (none for a
    single image, as in the JAX package). ``topk_exact`` keeps the JAX
    certificate's field: its block top-k can lose candidates, the port's
    candidate lists never do, so it is all True.
    """

    ok: torch.Tensor               # (B,) bool
    cand_counts: torch.Tensor      # (B, L) int32: 2d/3d maxima per layer
    cand_caps: torch.Tensor        # (L,) int32
    topk_exact: torch.Tensor       # (B, L) bool: candidate top-k exact
    accepted_counts: torch.Tensor  # (B, L) int32: uniformity-accepted
    refine_caps: torch.Tensor      # (L,) int32 (INT32_MAX = uncapped)

    def frame(self, i: int) -> "DetectDiagnostics":
        """The certificate of frame ``i`` alone (no batch axis)."""
        return DetectDiagnostics(
            ok=self.ok[i], cand_counts=self.cand_counts[i], cand_caps=self.cand_caps,
            topk_exact=self.topk_exact[i], accepted_counts=self.accepted_counts[i],
            refine_caps=self.refine_caps,
        )


def _layer_accepts(cands, config: DetectorConfig, shapes=None) -> list[torch.Tensor]:
    """The accept mask of every layer's candidates: greedy uniformity (one
    kernel launch for all layers on the card, each layer's (rows, cols) in
    ``shapes`` choosing its route there) or, at radius 0, the
    single-bucket cap."""
    caps = [min(config.max_num_kpt, c[0].shape[1]) for c in cands]
    if config.uniformity_radius > 0.0:
        return enforce_uniformity_layers(
            [(*c, cap) for c, cap in zip(cands, caps)],
            radius=float(config.uniformity_radius),
            block=config.uniformity_block,
            shapes=shapes,
        )
    return [bucket_keypoints(c[3], cap) for c, cap in zip(cands, caps)]


def _layer_accept(cand, config: DetectorConfig, shape=None) -> torch.Tensor:
    """One layer's accept mask (``_layer_accepts`` of that layer alone)."""
    return _layer_accepts([cand], config, [shape])[0]


def detect_keypoints(
    imgs: torch.Tensor,
    config: DetectorConfig,
    with_diagnostics: bool = False,
    mark: Mark = _no_mark,
):
    """Scale-space detection on a batch of uint8 or uint16 frames (B, H, W).

    Returns KeyPoints with (B, C) fields, C the sum of the per-layer
    compacted capacities, and with ``with_diagnostics`` a
    :class:`DetectDiagnostics`. ``mark(stage)`` is called after each stage
    (the per-stage timers hook in there).
    """
    n_layers = config.n_layers
    pyramid = build_pyramid(imgs, n_layers)
    mark("pyramid")
    scores, masks = layer_score_masks(pyramid, config, mark)
    # Kernel layer_candidates on the card (one launch for every layer), the
    # stable full-map sort on the CPU.
    cands, counts = layer_candidates(scores, masks,
                                     [config.layer_cap(i) for i in range(n_layers)])
    mark("candidates")
    accepts = _layer_accepts(cands, config, [tuple(sc.shape[-2:]) for sc in scores])
    mark("uniformity")
    # Kernel refine_keypoints on the card (one launch for every layer).
    caps = []
    for i, c in enumerate(cands):
        k = c[0].shape[1]
        rcap = config.refine_cap(i)
        caps.append(min(k, config.max_num_kpt, k if rcap is None else rcap))
    kps, acc_counts = refine_keypoints(scores, cands, accepts, caps,
                                       [layer_geometry(i) for i in range(n_layers)],
                                       REFINE_DTYPES[config.refine_dtype])
    mark("refine")
    if not with_diagnostics:
        return kps

    dev = imgs.device
    # Candidate-cap overflow is value-neutral when uniformity is off and
    # the cap covers the output budget (both keep score-order prefixes).
    eff_kpt = min(config.max_num_kpt, config.max_keypoints)
    cand_caps = torch.tensor(
        [
            INT32_MAX
            if config.uniformity_radius == 0.0 and config.layer_cap(i) >= eff_kpt
            else min(config.layer_cap(i), scores[i][0].numel())
            for i in range(n_layers)
        ],
        dtype=torch.int32, device=dev,
    )
    rcaps = torch.tensor(
        [INT32_MAX if config.refine_cap(i) is None else config.refine_cap(i)
         for i in range(n_layers)],
        dtype=torch.int32, device=dev,
    )
    exact = torch.ones_like(counts, dtype=torch.bool)
    diag = DetectDiagnostics(
        ok=(
            (counts <= cand_caps).all(dim=1) & exact.all(dim=1)
            & (acc_counts <= rcaps).all(dim=1)
        ),
        cand_counts=counts,
        cand_caps=cand_caps,
        topk_exact=exact,
        accepted_counts=acc_counts,
        refine_caps=rcaps,
    )
    return kps, diag

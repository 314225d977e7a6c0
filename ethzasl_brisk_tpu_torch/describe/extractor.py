"""BRISK descriptor extraction (port of ``describe/extractor.py``).

Mirrors ``BriskDescriptorExtractor`` (brisk-descriptor-extractor.cc):
per-keypoint scale index from size (:629-658), border filtering against
the size list (RoiPredicate, :532-536), smoothed-intensity sampling
(kernel K2), orientation from the long pairs with C-truncating division
(:714-740), and 384 short-pair comparisons packed LSB-first into 12
words (:538-564). The words are the JAX package's uint32 descriptors
stored as int32 bit patterns.

Entry points: :class:`BriskExtractor` (one image or a batch, every slot),
``extract_descriptors`` (one image), ``extract_descriptors_batch`` (a
batch, every slot) and ``extract_descriptors_compact`` (a batch over a
budget of describable keypoints, what ``FramePipeline`` runs). Only the
v2 pattern is ported; uint8 images only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints
from ethzasl_brisk_tpu_torch.core.pattern import (
    BASIC_SIZE,
    N_ROT,
    SCALERANGE,
    SCALES,
    BriskPattern,
    brisk_v2_pattern,
)
from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity_fused
from ethzasl_brisk_tpu_torch.kernels.integral import integral_image_i32

PATTERN_FIELDS = (
    "lut_x", "lut_y", "lut_sigma", "lut_scaling", "lut_scaling2", "scale_list",
    "size_list", "short_i", "short_j", "long_i", "long_j", "long_wdx", "long_wdy",
)


def _trunc_div(val: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(val, d, rounding_mode="trunc")


@dataclasses.dataclass(frozen=True)
class DevicePattern:
    """The pattern tables as tensors (the JAX ``DevicePattern`` fields)."""

    lut_x: torch.Tensor       # (S, R, P) f32
    lut_y: torch.Tensor       # (S, R, P) f32
    lut_sigma: torch.Tensor   # (S, P) f32
    lut_scaling: torch.Tensor   # (S, P) i32 box-weight scale
    lut_scaling2: torch.Tensor  # (S, P) i32 output divisor
    scale_list: torch.Tensor  # (S,) f32
    size_list: torch.Tensor   # (S,) i32
    short_i: torch.Tensor     # (Sh,) i64 (index tensors)
    short_j: torch.Tensor
    long_i: torch.Tensor      # (L,) i64
    long_j: torch.Tensor
    long_wdx: torch.Tensor    # (L,) i32
    long_wdy: torch.Tensor

    @property
    def descriptor_words(self) -> int:
        return -(-self.short_i.shape[0] // 128) * 4

    @staticmethod
    def from_host(p: BriskPattern) -> "DevicePattern":
        return pattern_from_numpy(
            dict(
                lut_x=p.lut_x, lut_y=p.lut_y, lut_sigma=p.lut_sigma,
                lut_scaling=p.lut_scaling, lut_scaling2=p.lut_scaling2,
                scale_list=p.scale_list, size_list=p.size_list,
                short_i=p.short_pairs[:, 0], short_j=p.short_pairs[:, 1],
                long_i=p.long_pairs[:, 0], long_j=p.long_pairs[:, 1],
                long_wdx=p.long_weights[:, 0], long_wdy=p.long_weights[:, 1],
            )
        )


def pattern_from_numpy(arrays: dict) -> DevicePattern:
    """Carry pattern tables across as numpy arrays, keyed by the JAX
    ``DevicePattern`` field names (``np.asarray`` of each JAX field)."""
    out = {}
    for name in PATTERN_FIELDS:
        a = np.ascontiguousarray(arrays[name])
        t = torch.from_numpy(a.copy())
        if name in ("short_i", "short_j", "long_i", "long_j"):
            t = t.to(torch.int64)
        out[name] = t
    return DevicePattern(**out)


def scale_index(size: torch.Tensor, scale_invariant: bool = True) -> torch.Tensor:
    """Keypoint size -> pattern scale index (:629-658); without scale
    invariance every keypoint takes the index of size 1.45 * BASIC_SIZE."""
    log2 = np.float32(0.693147180559945)
    lb_scalerange = np.float32(np.log(SCALERANGE) / log2)
    basic_size06 = np.float32(BASIC_SIZE * 0.6)
    if not scale_invariant:
        basic = max(int(
            np.float32(SCALES) / lb_scalerange
            * (np.log(np.float32(1.45 * BASIC_SIZE) / basic_size06) / log2)
            + 0.5
        ), 0)
        return torch.full(size.shape, basic, dtype=torch.int64, device=size.device)
    coef = float(np.float32(SCALES) / lb_scalerange)
    val = coef * (torch.log(size / float(basic_size06)) / float(log2)) + 0.5
    return torch.clamp(torch.trunc(val).to(torch.int64), 0, SCALES - 1)


def _describable_mask(
    pat: DevicePattern, h: int, w: int, kp: KeyPoints, scale_invariant: bool = True
) -> torch.Tensor:
    """Valid AND inside the pattern border (RoiPredicate, :532-536)."""
    bf = pat.size_list[scale_index(kp.size, scale_invariant)].to(torch.float32)
    return kp.valid & (kp.x >= bf) & (kp.x < w - bf) & (kp.y >= bf) & (kp.y < h - bf)


def describable_count(
    pat: DevicePattern, imgs: torch.Tensor, keypoints: KeyPoints, *,
    scale_invariant: bool = True,
) -> torch.Tensor:
    """Batch-total describable keypoints: what the describe capacity must cover."""
    _, h, w = imgs.shape
    return _describable_mask(pat, h, w, keypoints, scale_invariant).sum(dtype=torch.int32)


def _stack_frames(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 -> (B*(H+1), W+1) int32 row-stacked integrals; frame
    b's integral starts at row ``b*(H+1)``."""
    b, h, w = imgs.shape
    return integral_image_i32(imgs).reshape(b * (h + 1), w + 1)


def _check_u8(img: torch.Tensor) -> None:
    if img.dtype != torch.uint8:
        raise ValueError(f"only uint8 images are described, got {img.dtype}")


def extract_descriptors(
    pat: DevicePattern,
    img: torch.Tensor,
    keypoints: KeyPoints,
    *,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
):
    """Describe every slot of (K,) keypoints on one (H, W) uint8 image.

    Returns (keypoints with angle set and border-filtered valid, (K, 12)
    int32 descriptor words).
    """
    _check_u8(img)
    h, w = img.shape
    row_base = torch.zeros(keypoints.capacity, dtype=torch.int32, device=img.device)
    return _describe_core(
        pat, integral_image_i32(img), h, w, keypoints, row_base,
        rotation_invariant=rotation_invariant, scale_invariant=scale_invariant,
    )


def extract_descriptors_batch(
    pat: DevicePattern,
    imgs: torch.Tensor,
    keypoints: KeyPoints,
    *,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
):
    """Describe every slot of (B, K) keypoints on (B, H, W) frames in one
    flat call: (keypoints (B, K), descriptors (B, K, 12) int32 words)."""
    _check_u8(imgs)
    b, h, w = imgs.shape
    k = keypoints.capacity
    row_base = torch.arange(b, dtype=torch.int32, device=imgs.device) * (h + 1)
    out_kp, desc = _describe_core(
        pat, _stack_frames(imgs), h, w, keypoints.map(lambda a: a.reshape(b * k)),
        row_base.repeat_interleave(k),
        rotation_invariant=rotation_invariant, scale_invariant=scale_invariant,
    )
    return out_kp.map(lambda a: a.reshape(b, k)), desc.reshape(b, k, -1)


def extract_descriptors_compact(
    pat: DevicePattern,
    imgs: torch.Tensor,
    keypoints: KeyPoints,
    *,
    capacity: int,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
    with_diagnostics: bool = False,
):
    """Describe a batch over a static budget of describable keypoints.

    The describable keypoints (valid and inside the pattern border) of the
    whole batch are compacted to the front in flat order, the first
    ``capacity`` of them are described in one call, and the results go
    back to the (B, K) layout. Overflow beyond ``capacity`` is dropped
    with valid=False; ``with_diagnostics`` also returns the batch's
    describable count, which certifies no overflow when <= capacity.
    """
    _check_u8(imgs)
    b, h, w = imgs.shape
    k = keypoints.capacity
    n = b * k
    capacity = min(capacity, n)
    integral = _stack_frames(imgs)

    flat_kp = keypoints.map(lambda a: a.reshape(n))
    describable = _describable_mask(pat, h, w, flat_kp, scale_invariant)
    order = torch.sort((~describable).to(torch.uint8), stable=True).indices
    sel = order[:capacity]
    comp_kp = flat_kp.map(lambda a: a[sel])
    row_base = (torch.div(sel, k, rounding_mode="floor") * (h + 1)).to(torch.int32)

    out_kp_c, desc_c = _describe_core(
        pat, integral, h, w, comp_kp, row_base,
        rotation_invariant=rotation_invariant, scale_invariant=scale_invariant,
    )

    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=order.device)
    described = (inv < capacity).reshape(b, k)

    def unpack(comp, fill):
        pad = torch.full((n - capacity,) + comp.shape[1:], fill, dtype=comp.dtype,
                         device=comp.device)
        return torch.cat([comp, pad], dim=0)[inv]

    def merged(field):
        u = unpack(getattr(out_kp_c, field), 0).reshape(b, k)
        return torch.where(described, u, getattr(keypoints, field))

    out_kp = KeyPoints(
        x=merged("x"),
        y=merged("y"),
        size=merged("size"),
        angle=merged("angle"),
        response=merged("response"),
        octave=merged("octave"),
        valid=unpack(out_kp_c.valid, False).reshape(b, k) & described,
    )
    desc = unpack(desc_c, 0).reshape(b, k, -1)
    if with_diagnostics:
        return out_kp, desc, describable.sum(dtype=torch.int32)
    return out_kp, desc


def _describe_core(
    pat: DevicePattern,
    integral: torch.Tensor,
    rows: int,
    cols: int,
    keypoints: KeyPoints,
    row_base: torch.Tensor,
    *,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
):
    """Orientation + descriptor for flat (K,) keypoints on stacked frames.

    Without rotation invariance the angle is kept and the pattern is not
    rotated (theta 0), so only the second sampling runs.
    """
    scale_idx = scale_index(keypoints.size, scale_invariant)
    bf = pat.size_list[scale_idx].to(torch.float32)
    inside = (
        (keypoints.x >= bf) & (keypoints.x < cols - bf)
        & (keypoints.y >= bf) & (keypoints.y < rows - bf)
    )
    valid = keypoints.valid & inside
    sigma = pat.lut_sigma[scale_idx].contiguous()
    scaling = pat.lut_scaling[scale_idx].contiguous()
    scaling2 = pat.lut_scaling2[scale_idx].contiguous()
    key_x, key_y = keypoints.x.contiguous(), keypoints.y.contiguous()

    def sample(px, py):
        return smoothed_intensity_fused(
            integral, key_x, key_y, px.contiguous(), py.contiguous(), sigma,
            scaling, scaling2, row_base, rows,
        )

    if rotation_invariant:
        angle, theta = _orientation(pat, keypoints, scale_idx, sample)
    else:
        angle, theta = keypoints.angle, torch.zeros_like(scale_idx)

    # Phase 2: rotated samples and the short-pair bits.
    vals = sample(pat.lut_x[scale_idx, theta], pat.lut_y[scale_idx, theta])
    return _pack_descriptor(pat, keypoints, angle, vals, valid)


def _orientation(pat, keypoints, scale_idx, sample):
    """Phase 1: angle (degrees) and rotation bin from the unrotated samples
    and the long pairs (:714-740)."""
    need_angle = keypoints.angle == -1.0
    vals0 = sample(pat.lut_x[scale_idx, 0], pat.lut_y[scale_idx, 0])
    delta_t = vals0[:, pat.long_i] - vals0[:, pat.long_j]  # (K, L)
    d0 = _trunc_div(delta_t * pat.long_wdx[None, :], 1024).sum(dim=1, dtype=torch.int32)
    d1 = _trunc_div(delta_t * pat.long_wdy[None, :], 1024).sum(dim=1, dtype=torch.int32)
    computed = (
        torch.atan2(d1.to(torch.float32), d0.to(torch.float32))
        / float(np.float32(np.pi))
        * 180.0
    )
    angle = torch.where(need_angle, computed, keypoints.angle)
    theta = torch.trunc(N_ROT * angle / 360.0 + 0.5).to(torch.int64)
    theta = torch.where(theta < 0, theta + N_ROT, theta)
    theta = torch.where(theta >= N_ROT, theta - N_ROT, theta)
    return angle, theta


def _pack_descriptor(pat, keypoints, angle, vals, valid):
    """384 short-pair comparisons -> 12 words LSB-first, as int32 bit
    patterns of the reference's uint32 words (setDescriptorBits, :538-564)."""
    bits = vals[:, pat.short_i] > vals[:, pat.short_j]  # (K, Sh)
    k, n_bits = bits.shape
    n_words = pat.descriptor_words
    padded = torch.zeros((k, n_words * 32), dtype=torch.int64, device=vals.device)
    padded[:, :n_bits] = bits.to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=vals.device),
        torch.arange(32, device=vals.device),
    )
    words = (padded.reshape(k, n_words, 32) * weights).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    desc = torch.where(valid[:, None], words, torch.zeros_like(words))
    return dataclasses.replace(keypoints, angle=angle, valid=valid), desc


class BriskExtractor(nn.Module):
    """BriskDescriptorExtractor (brisk-descriptor-extractor.h:62-96) with
    the v2 pattern; its buffers are the pattern tables.

    It runs on ``device`` (default the card; ``device="cpu"`` for the CPU):
    the buffers live there, and a call moves its image and keypoints there
    and returns its outputs there. ``pattern`` carries tables built
    elsewhere (``pattern_from_numpy``); otherwise they are built from
    ``pattern_scale``. Calling it on one (H, W) image with (K,) keypoints
    describes every slot, as the JAX extractor does; a (B, H, W) batch with
    (B, K) keypoints goes through ``extract_descriptors_batch``.
    """

    def __init__(
        self,
        rotation_invariant: bool = True,
        scale_invariant: bool = True,
        pattern_scale: float = 1.0,
        pattern: DevicePattern | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.rotation_invariant = rotation_invariant
        self.scale_invariant = scale_invariant
        if pattern is None:
            pattern = DevicePattern.from_host(brisk_v2_pattern(pattern_scale))
        for name in PATTERN_FIELDS:
            self.register_buffer(name, getattr(pattern, name).to(dev))

    @property
    def device(self) -> torch.device:
        """Where the pattern tables live, and so where calls run."""
        return self.lut_x.device

    @property
    def pattern(self) -> DevicePattern:
        return DevicePattern(**{name: getattr(self, name) for name in PATTERN_FIELDS})

    def forward(self, img: torch.Tensor, keypoints: KeyPoints):
        dev = self.device
        fn = extract_descriptors if img.dim() == 2 else extract_descriptors_batch
        return fn(
            self.pattern, img.to(dev), keypoints.map(lambda a: a.to(dev)),
            rotation_invariant=self.rotation_invariant,
            scale_invariant=self.scale_invariant,
        )

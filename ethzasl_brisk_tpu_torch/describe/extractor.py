"""BRISK descriptor extraction (port of ``describe/extractor.py``).

Mirrors ``BriskDescriptorExtractor`` (brisk-descriptor-extractor.cc):
per-keypoint scale index from size (:629-658), border filtering against
the size list (RoiPredicate, :532-536), smoothed-intensity sampling
(kernel K2), orientation from the long pairs with C-truncating division
(:714-740), and the short-pair comparisons packed LSB-first into words
(:538-564): 384 bits in 12 words for v2, 512 in 16 for the v1 ring
pattern. The words are the JAX package's uint32 descriptors stored as
int32 bit patterns. On uint8 frames the whole describe, both samplings
included, is ``describe/rotated.py``'s ``describe_rotated``: one launch of
kernel ``describe_rotated`` on the card.

Entry points: :class:`BriskExtractor` (one image or a batch, every slot),
``extract_descriptors`` (one image), ``extract_descriptors_batch`` (a
batch, every slot), ``extract_descriptors_compact`` (a batch over a
budget of describable keypoints, what ``FramePipeline`` runs) and
``extract_descriptors_views`` (flat keypoints, each in its own view of a
stacked set, what the camera-aware grid runs). ``v1_rounding`` selects
K2's v1 variant, the v1 engine's half-divisor rounding; the extractor
sets it for ``version="v1"`` without a pattern file, as the JAX one does.

One uint16 image takes the 16-bit pipeline, as in the JAX package: the
image scaled by 1/65536, its float integral and the float sampler
``smoothed_intensity_f32`` (torch ops), whatever sampler is configured.
The batched describes take uint8 only, as the JAX package's do (they
stack int32 integrals).

``angle_exact`` computes angle and theta on the host with a double
``atan2`` of the float-cast long-pair sums (``_exact_angle_host``), bit
for bit the reference's and the JAX package's ``angle_exact``; it syncs
with the host, so it is for parity runs. The default keeps the JAX
package's float32 chain (glibc's ``atan2f``) on the device, bit for bit
(``describe/orientation.py``).
"""
from __future__ import annotations

import dataclasses
import functools

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
    brisk_v1_pattern,
    brisk_v2_pattern,
    pattern_from_file,
)
from ethzasl_brisk_tpu_torch.core.selectors import check_extractor_selectors, check_version
from ethzasl_brisk_tpu_torch.describe.orientation import orientation
from ethzasl_brisk_tpu_torch.describe.rotated import (
    KernelTables,
    PatternLayout,
    describe_rotated,
    long_pair_gradient,
    pack_words,
)
from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity_fused
from ethzasl_brisk_tpu_torch.kernels.integral import integral_image_16_f32, integral_image_i32

PATTERN_FIELDS = (
    "lut_x", "lut_y", "lut_sigma", "lut_scaling", "lut_scaling2", "scale_list",
    "size_list", "short_i", "short_j", "long_i", "long_j", "long_wdx", "long_wdy",
)


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

    @functools.cached_property
    def kernel_layout(self) -> PatternLayout:
        """The tables' shapes checked against kernel ``describe_rotated``'s,
        once a pattern (``describe/rotated.py``)."""
        return PatternLayout.of(self)

    @functools.cached_property
    def kernel_tables(self) -> KernelTables:
        """The pair tables packed for kernel ``describe_rotated``, checked
        and packed once a pattern, on its device (``describe/rotated.py``)."""
        return KernelTables.of(self)

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


def describe_budget(per_frame: int, b: int, k: int) -> int:
    """The describe capacity of a batch of ``b`` frames of ``k`` slots:
    ``per_frame`` describables a frame, or every slot when it is 0."""
    return per_frame * b if per_frame else b * k


def _stack_frames(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 -> (B*(H+1), W+1) int32 row-stacked integrals; frame
    b's integral starts at row ``b*(H+1)``."""
    b, h, w = imgs.shape
    return integral_image_i32(imgs).reshape(b * (h + 1), w + 1)


def check_u8_batch(imgs: torch.Tensor) -> None:
    """Batches are uint8 only, as in the JAX package."""
    if imgs.dtype == torch.uint16:
        raise ValueError(
            "a (B, H, W) uint16 batch is not supported: the JAX package's batched and "
            "compacted describe is uint8 only (it stacks int32 integrals); pass uint16 "
            "images one at a time as (H, W)"
        )
    if imgs.dtype != torch.uint8:
        raise ValueError(f"batches are uint8 only, got {imgs.dtype}")


def smoothed_intensity_f32(
    img: torch.Tensor,
    integral: torch.Tensor,
    key_x: torch.Tensor,
    key_y: torch.Tensor,
    pat_x: torch.Tensor,
    pat_y: torch.Tensor,
    pat_sigma: torch.Tensor,
    pat_area: torch.Tensor,
) -> torch.Tensor:
    """16-bit smoothed intensities (JAX ``smoothed_intensity_f32``): int32
    (K, P) from the (H, W) float32 image scaled by 1/65536 and its
    (H+1, W+1) float32 integral.

    SmoothedIntensity<float, float> (brisk-descriptor-extractor.cc:368-530)
    with float weights and no truncation but the result's, scaled by 256
    (the JAX package's choice: it lands in the 8-bit path's range, and the
    bits and orientation are invariant to a positive scale). Every float op
    is a torch op in the JAX function's order, divisions by tensors, so the
    values equal the JAX function run eagerly bit for bit, on the card too.
    """
    rows, cols = img.shape
    flat_img, flat_int = img.reshape(-1), integral.reshape(-1)
    xf = pat_x + key_x[:, None]
    yf = pat_y + key_y[:, None]
    sigma_half = pat_sigma

    def at_img(y, x):
        y = torch.clamp(y, 0, rows - 1).to(torch.int64)
        return flat_img[y * cols + torch.clamp(x, 0, cols - 1)]

    def at_int(y, x):
        y = torch.clamp(y, 0, rows).to(torch.int64)
        return flat_int[y * (cols + 1) + torch.clamp(x, 0, cols)]

    def trunc_i32(v):
        return torch.trunc(v).to(torch.int32)

    # Small-sigma bilinear (:390-408): int ratios, float pixels.
    x_i, y_i = trunc_i32(xf), trunc_i32(yf)
    r_x = trunc_i32((xf - x_i.to(torch.float32)) * 1024).to(torch.float32)
    r_y = trunc_i32((yf - y_i.to(torch.float32)) * 1024).to(torch.float32)
    r_x_1b = 1024.0 - r_x
    r_y_1b = 1024.0 - r_y
    small_val = (
        r_x_1b * r_y_1b * at_img(y_i, x_i)
        + r_x * r_y_1b * at_img(y_i, x_i + 1)
        + r_x * r_y * at_img(y_i + 1, x_i + 1)
        + r_x_1b * r_y * at_img(y_i + 1, x_i)
    ) / 1024.0

    # Box path (:410-495) with float weights.
    scaling = torch.full_like(pat_area, 4194304.0) / pat_area
    scaling2 = scaling * pat_area / 1024.0
    x_1 = xf - sigma_half
    x1 = xf + sigma_half
    y_1 = yf - sigma_half
    y1 = yf + sigma_half
    x_left = trunc_i32(x_1 + 0.5)
    y_top = trunc_i32(y_1 + 0.5)
    x_right = trunc_i32(x1 + 0.5)
    y_bottom = trunc_i32(y1 + 0.5)

    r_x_1f = x_left.to(torch.float32) - x_1 + 0.5
    r_y_1f = y_top.to(torch.float32) - y_1 + 0.5
    r_x1f = x1 - x_right.to(torch.float32) + 0.5
    r_y1f = y1 - y_bottom.to(torch.float32) + 0.5
    w_a = r_x_1f * r_y_1f * scaling
    w_b = r_x1f * r_y_1f * scaling
    w_c = r_x1f * r_y1f * scaling
    w_d = r_x_1f * r_y1f * scaling
    r_x_1_i = r_x_1f * scaling
    r_y_1_i = r_y_1f * scaling
    r_x1_i = r_x1f * scaling
    r_y1_i = r_y1f * scaling

    big = (x_right - x_left - 1) + (y_bottom - y_top - 1) > 2
    cd_y = torch.where(big, y_bottom - 1, y_bottom)
    c_x = torch.where(big, x_right + 1, x_right)
    d_x = torch.where(big, x_left + 1, x_left)
    corners = (
        w_a * at_img(y_top, x_left)
        + w_b * at_img(y_top, x_right)
        + w_c * at_img(cd_y, c_x)
        + w_d * at_img(cd_y, d_x)
    )

    t1 = at_int(y_top, x_left + 1)
    t2 = at_int(y_top, x_right)
    t3 = at_int(y_top + 1, x_right)
    t4 = at_int(y_top + 1, x_right + 1)
    t5 = at_int(y_bottom, x_right + 1)
    t6 = at_int(y_bottom, x_right)
    t7 = at_int(y_bottom + 1, x_right)
    t8 = at_int(y_bottom + 1, x_left + 1)
    t9 = at_int(y_bottom, x_left + 1)
    t10 = at_int(y_bottom, x_left)
    t11 = at_int(y_top + 1, x_left)
    t12 = at_int(y_top + 1, x_left + 1)

    upper = (t3 - t2 + t1 - t12) * r_y_1_i
    middle = (t6 - t3 + t12 - t9) * scaling
    left = (t9 - t12 + t11 - t10) * r_x_1_i
    right = (t5 - t4 + t3 - t6) * r_x1_i
    bottom = (t7 - t6 + t9 - t8) * r_y1_i
    box = (corners + upper + middle + left + right + bottom) / scaling2

    val = torch.where(sigma_half < 0.5, small_val, box)
    return trunc_i32(256.0 * val)


def extract_descriptors(
    pat: DevicePattern,
    img: torch.Tensor,
    keypoints: KeyPoints,
    *,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
    angle_exact: bool = False,
    v1_rounding: bool = False,
):
    """Describe every slot of (K,) keypoints on one (H, W) uint8 or uint16
    image (uint16: the float 16-bit sampler, see the module docstring,
    which has no v1 rounding, as in the JAX package).

    Returns (keypoints with angle set and border-filtered valid, (K, W)
    int32 descriptor words).
    """
    h, w = img.shape
    kw = dict(rotation_invariant=rotation_invariant, scale_invariant=scale_invariant,
              angle_exact=angle_exact)
    if img.dtype == torch.uint16:
        return _describe_core(
            pat, integral_image_16_f32(img), h, w, keypoints, None,
            img_f32=img.to(torch.float32) / 65536.0, **kw,
        )
    kw["v1_rounding"] = v1_rounding
    if img.dtype != torch.uint8:
        raise ValueError(f"only uint8 and uint16 images are described, got {img.dtype}")
    row_base = torch.zeros(keypoints.capacity, dtype=torch.int32, device=img.device)
    return _describe_core(pat, integral_image_i32(img), h, w, keypoints, row_base, **kw)


def extract_descriptors_batch(
    pat: DevicePattern,
    imgs: torch.Tensor,
    keypoints: KeyPoints,
    *,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
    angle_exact: bool = False,
    v1_rounding: bool = False,
):
    """Describe every slot of (B, K) keypoints on (B, H, W) uint8 frames in
    one flat call: (keypoints (B, K), descriptors (B, K, W) int32 words).
    It honours ``angle_exact`` and ``v1_rounding``, as the JAX extractor
    run on each frame does (the JAX function of this name takes both and
    passes neither on)."""
    check_u8_batch(imgs)
    b, h, w = imgs.shape
    k = keypoints.capacity
    row_base = torch.arange(b, dtype=torch.int32, device=imgs.device) * (h + 1)
    out_kp, desc = _describe_core(
        pat, _stack_frames(imgs), h, w, keypoints.map(lambda a: a.reshape(b * k)),
        row_base.repeat_interleave(k),
        rotation_invariant=rotation_invariant, scale_invariant=scale_invariant,
        angle_exact=angle_exact, v1_rounding=v1_rounding,
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
    v1_rounding: bool = False,
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
    check_u8_batch(imgs)
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
        v1_rounding=v1_rounding,
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


def extract_descriptors_views(
    pat: DevicePattern,
    imgs: torch.Tensor,
    keypoints: KeyPoints,
    view_idx: torch.Tensor,
    *,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
    angle_exact: bool = False,
    v1_rounding: bool = False,
    view_cols: torch.Tensor | None = None,
    view_rows: torch.Tensor | None = None,
):
    """Describe flat (K,) keypoints, each in its own view of the stacked
    (V, H, W) uint8 views (the camera-aware grid's virtual views), in one
    call: frame ``view_idx`` of the row-stacked integrals, ``row_base =
    view_idx * (H + 1)``. ``view_cols``/``view_rows`` (V,) give each view's
    true size inside its padded frame: the border filter (RoiPredicate,
    brisk-descriptor-extractor.cc:532-536) then holds per view, while K2
    still clamps its taps to the padded frame. Returns (keypoints (K,),
    descriptors (K, W) int32 words).
    """
    check_u8_batch(imgs)
    _, h, w = imgs.shape
    view_idx = view_idx.to(torch.int64)
    return _describe_core(
        pat, _stack_frames(imgs), h, w, keypoints, (view_idx * (h + 1)).to(torch.int32),
        rotation_invariant=rotation_invariant, scale_invariant=scale_invariant,
        angle_exact=angle_exact, v1_rounding=v1_rounding,
        col_limit=None if view_cols is None else view_cols[view_idx],
        row_limit=None if view_rows is None else view_rows[view_idx],
    )


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
    angle_exact: bool = False,
    v1_rounding: bool = False,
    img_f32: torch.Tensor | None = None,
    col_limit: torch.Tensor | None = None,
    row_limit: torch.Tensor | None = None,
):
    """Orientation + descriptor for flat (K,) keypoints on stacked frames.

    ``col_limit``/``row_limit`` (K,) replace ``cols``/``rows`` in the border
    filter with each keypoint's own limits (a view's true size).

    Without rotation invariance the angle is kept and the pattern is not
    rotated (theta 0), so only the second sampling runs. On uint8 frames
    ``describe_rotated`` (``describe/rotated.py``, one launch of
    ``csrc/describe.cu`` on the card, its plain version on the CPU) does it
    all: both samplings, the gradient, the angle chain and the words. With
    ``img_f32`` (one scaled 16-bit image; ``integral`` its float integral)
    the float sampler serves both samplings, and with ``angle_exact`` K2
    does, around the orientation step (``_orientation``) and
    ``pack_words``.

    The ``angle`` of a slot that leaves invalid (outside the pattern
    border) lies outside parity with the JAX package: describe computes an
    angle for every slot whose angle is -1, and for a slot whose taps leave
    the frame the value depends on how each sampler clamps them. The JAX
    samplers themselves disagree there: on a 240 x 320 bench frame
    (octaves 2, radius 30, threshold 20, 256 keypoints: 203 detected, 105
    describable) ``patch`` and ``patch_ms`` equal ``gather`` on ``valid``
    and on every valid angle and differ from it on 94 of the 98
    non-describable angles, by up to 8.17 degrees. Every other field, and
    the angle of every valid slot, is held to the JAX package.
    """
    scale_idx = scale_index(keypoints.size, scale_invariant)
    bf = pat.size_list[scale_idx].to(torch.float32)
    w_lim = cols if col_limit is None else col_limit.to(torch.float32)
    h_lim = rows if row_limit is None else row_limit.to(torch.float32)
    inside = (
        (keypoints.x >= bf) & (keypoints.x < w_lim - bf)
        & (keypoints.y >= bf) & (keypoints.y < h_lim - bf)
    )
    valid = keypoints.valid & inside
    key_x, key_y = keypoints.x.contiguous(), keypoints.y.contiguous()

    if img_f32 is None and not angle_exact:
        angle, desc = describe_rotated(
            pat, integral, rows, rotation_invariant, scale_idx, valid,
            keypoints.angle.contiguous(), key_x, key_y, row_base, v1_rounding,
        )
        return dataclasses.replace(keypoints, angle=angle, valid=valid), desc

    sigma = pat.lut_sigma[scale_idx].contiguous()
    scaling = pat.lut_scaling[scale_idx].contiguous()
    scaling2 = pat.lut_scaling2[scale_idx].contiguous()
    if img_f32 is not None:
        area = 4.0 * sigma * sigma

        def sample(px, py):
            return smoothed_intensity_f32(img_f32, integral, key_x, key_y, px, py, sigma, area)
    else:
        def sample(px, py):
            return smoothed_intensity_fused(
                integral, key_x, key_y, px.contiguous(), py.contiguous(), sigma,
                scaling, scaling2, row_base, rows, v1_rounding,
            )

    if rotation_invariant:
        # The float sampler is held to JAX op by op, and so is its chain.
        angle, theta = _orientation(pat, keypoints, scale_idx, sample, angle_exact,
                                    op_by_op=img_f32 is not None)
    else:
        angle, theta = keypoints.angle, torch.zeros_like(scale_idx)

    # Phase 2: rotated samples and the short-pair bits.
    vals = sample(pat.lut_x[scale_idx, theta], pat.lut_y[scale_idx, theta])
    desc = pack_words(pat, vals, valid)
    return dataclasses.replace(keypoints, angle=angle, valid=valid), desc


def _exact_angle_host(d0: np.ndarray, d1: np.ndarray, given_angle: np.ndarray,
                      need: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Reference-exact angle and rotation bin on the host
    (brisk-descriptor-extractor.cc:732-739; the JAX package's
    ``_exact_angle_host``).

    ``atan2(float(direction1), float(direction0))`` resolves to the C
    double ``atan2`` of the float-cast sums; ``/ M_PI * 180.0`` stays in
    double and rounds once to the float angle; ``theta = int((n_rot *
    angle) / 360.0 + 0.5)`` takes a float32 product, a double division
    and add and a truncating cast, and negative thetas wrap by n_rot.
    """
    a = np.arctan2(
        np.asarray(d1).astype(np.float32).astype(np.float64),
        np.asarray(d0).astype(np.float32).astype(np.float64),
    )
    computed = (a / np.pi * 180.0).astype(np.float32)
    ang = np.where(np.asarray(need), computed, np.asarray(given_angle)).astype(np.float32)
    theta = np.trunc(
        (np.float32(N_ROT) * ang).astype(np.float64) / 360.0 + 0.5
    ).astype(np.int32)
    theta = np.where(theta < 0, theta + N_ROT, theta)
    theta = np.where(theta >= N_ROT, theta - N_ROT, theta)
    return ang, theta.astype(np.int32)


def _orientation(pat, keypoints, scale_idx, sample, angle_exact=False, op_by_op=False):
    """Phase 1: angle (degrees) and rotation bin from the unrotated samples
    and the long pairs (:714-740): the JAX package's float32 chain
    (``describe/orientation.py``, kernel ``brisk_orientation`` on the card;
    ``op_by_op`` for the 16-bit path), or with ``angle_exact`` on the host
    (``_exact_angle_host``)."""
    need_angle = keypoints.angle == -1.0
    d0, d1 = long_pair_gradient(pat, sample(pat.lut_x[scale_idx, 0], pat.lut_y[scale_idx, 0]))
    if angle_exact:
        ang, theta = _exact_angle_host(d0.cpu().numpy(), d1.cpu().numpy(),
                                       keypoints.angle.cpu().numpy(), need_angle.cpu().numpy())
        dev = d0.device
        return torch.from_numpy(ang).to(dev), torch.from_numpy(theta).to(dev, torch.int64)
    return orientation(d0.contiguous(), d1.contiguous(), keypoints.angle.contiguous(),
                       need_angle.contiguous(), op_by_op)


class BriskExtractor(nn.Module):
    """BriskDescriptorExtractor (brisk-descriptor-extractor.h:62-96); its
    buffers are the pattern tables. It takes the JAX extractor's keywords:
    ``version`` ("v2", or "v1": the ring pattern, 16-word descriptors and
    K2's v1 rounding), ``pattern_scale``, ``pattern_file`` (a ``.ptn``
    pattern, the reference's file ctor: it overrides ``version`` and turns
    v1 rounding off, brisk-descriptor-extractor.cc:357-367), ``angle_exact``
    and the sampler selectors ``sampler``, ``patch_h`` and ``patch_w``,
    checked no-ops (``core/selectors.py``): K2 gives every sampler's
    output.

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
        version: str = "v2",
        pattern_file: str | None = None,
        sampler: str = "gather",
        patch_h: int = 192,
        patch_w: int = 192,
        angle_exact: bool = False,
    ):
        super().__init__()
        check_version(version)
        check_extractor_selectors(sampler, patch_h, patch_w)
        dev = resolve_device(device)
        self.rotation_invariant = rotation_invariant
        self.scale_invariant = scale_invariant
        self.angle_exact = bool(angle_exact)
        self.v1_rounding = version == "v1" and pattern_file is None
        if pattern is None:
            if pattern_file is not None:
                host = pattern_from_file(str(pattern_file), pattern_scale)
            elif version == "v1":
                host = brisk_v1_pattern(pattern_scale)
            else:
                host = brisk_v2_pattern(pattern_scale)
            pattern = DevicePattern.from_host(host)
        for name in PATTERN_FIELDS:
            self.register_buffer(name, getattr(pattern, name).to(dev))

    @property
    def device(self) -> torch.device:
        """Where the pattern tables live, and so where calls run."""
        return self.lut_x.device

    @property
    def pattern(self) -> DevicePattern:
        """The buffers as a ``DevicePattern``, built once for the buffers the
        module holds (again after ``.to()`` or a reassigned buffer), so what
        it caches, the describe kernel's packed tables, is built once."""
        cached = self.__dict__.get("_pattern")
        if cached is None or any(getattr(cached, n) is not getattr(self, n)
                                 for n in PATTERN_FIELDS):
            cached = DevicePattern(**{name: getattr(self, name) for name in PATTERN_FIELDS})
            self.__dict__["_pattern"] = cached
        return cached

    @property
    def descriptor_bytes(self) -> int:
        """Bytes of one descriptor (48 for v2, 64 for v1)."""
        return self.pattern.descriptor_words * 4

    def forward(self, img: torch.Tensor, keypoints: KeyPoints):
        dev = self.device
        fn = extract_descriptors if img.dim() == 2 else extract_descriptors_batch
        return fn(
            self.pattern, img.to(dev), keypoints.map(lambda a: a.to(dev)),
            rotation_invariant=self.rotation_invariant,
            scale_invariant=self.scale_invariant,
            angle_exact=self.angle_exact,
            v1_rounding=self.v1_rounding,
        )

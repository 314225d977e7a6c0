"""BRISK's uint8 describe: both samplings, the long-pair gradient, the angle
chain and the descriptor words (the JAX package's ``_describe_core`` on the
Pallas route, ``describe/extractor.py:890-1081``, with its
``_pack_descriptor``).

From the row-stacked int32 integral and the keypoints, for each keypoint:

* the samples of the unrotated pattern, ``lut_x[scale_idx, 0]`` (phase 1),
  as kernel K2 samples them;
* the gradient ``d0``, ``d1`` of the long pairs (:1041-1046): int32
  differences and products that wrap, C's truncating division by 1024 and
  int32 sums (``long_pair_gradient``);
* the angle in degrees and the rotation bin theta, the JAX package's
  float32 chain (``describe/orientation.py``), the given angle kept where it
  is not -1;
* the pattern rotated by theta, ``lut_x[scale_idx, theta]``, sampled as K2
  samples it;
* the short-pair comparisons packed LSB first into int32 words, every word
  0 where the keypoint is not valid (``pack_words``).

Without rotation invariance (``rotate`` False) there is no phase 1: theta
is 0 and the given angle is kept.

``describe_rotated_plain`` is the plain version (the torch chain, op for
op: K2's plain version at theta 0, the gradient, the chain, K2's plain
version at theta, the pack); ``describe_rotated_cuda`` launches kernel
``describe_rotated`` (``csrc/describe.cu``) once, counted as
``describe_rotated`` or, with ``v1_rounding``, ``describe_rotated_v1``;
``describe_rotated`` picks by device. The pattern ``pat`` is the
extractor's ``DevicePattern``; the kernel takes its tables as
``kernel_tables`` packs them, checked and packed once a pattern (cached on
the ``DevicePattern``).
"""
from __future__ import annotations

import dataclasses

import torch

from ethzasl_brisk_tpu_torch import _kernels
from ethzasl_brisk_tpu_torch.core.pattern import N_ROT
from ethzasl_brisk_tpu_torch.describe.orientation import orientation_plain
from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity

WARPS = 4  # warps a CTA of csrc/describe.cu, and keypoints a tile at most (kWarps)
MAX_SMEM = 232448  # bytes of shared memory a block can opt in to on Hopper (kMaxSmem)
STATIC_SMEM = 1024  # bytes kept for the kernel's static shared arrays (kStaticSmem)
MAX_INDEX = 32767  # the packed tables hold int16 point indices


def long_pair_gradient(pat, vals0: torch.Tensor):
    """(K, P) int32 phase-1 values -> the (K,) int32 gradient sums d0, d1."""
    delta_t = vals0[:, pat.long_i] - vals0[:, pat.long_j]  # (K, L)
    d0 = torch.div(delta_t * pat.long_wdx[None, :], 1024, rounding_mode="trunc")
    d1 = torch.div(delta_t * pat.long_wdy[None, :], 1024, rounding_mode="trunc")
    return d0.sum(dim=1, dtype=torch.int32), d1.sum(dim=1, dtype=torch.int32)


def pack_words(pat, vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The short-pair comparisons of (K, P) values -> (K, W) int32 words,
    LSB first (384 bits in 12 words for v2, 512 in 16 for v1), the
    reference's uint32 words as int32 bit patterns (setDescriptorBits,
    brisk-descriptor-extractor.cc:538-564); 0 where ``valid`` is False."""
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
    return torch.where(valid[:, None], words, torch.zeros_like(words))


def plain_rotation(pat, vals0, scale_idx, angle):
    """The plain chain's (angle (K,) float32, theta (K,) int64): from the
    phase-1 values' gradient, the given angle kept where it is not -1;
    without phase-1 values, the given angle and theta 0."""
    if vals0 is None:
        return angle, torch.zeros_like(scale_idx)
    d0, d1 = long_pair_gradient(pat, vals0)
    return orientation_plain(d0, d1, angle, angle == -1.0)


def rotated_sampler_args(pat, integral, frame_rows: int, scale_idx, theta, key_x, key_y,
                         row_base, v1_rounding: bool = False) -> tuple:
    """Kernel K2's arguments for the pattern rotated by ``theta`` (a (K,)
    tensor or an int): ``lut_x[scale_idx, theta]`` and the per-point
    tables of each keypoint's scale."""
    return (integral, key_x, key_y, pat.lut_x[scale_idx, theta].contiguous(),
            pat.lut_y[scale_idx, theta].contiguous(), pat.lut_sigma[scale_idx],
            pat.lut_scaling[scale_idx], pat.lut_scaling2[scale_idx], row_base, frame_rows,
            v1_rounding)


def describe_rotated_plain(pat, integral, frame_rows: int, rotate: bool, scale_idx, valid, angle,
                           key_x, key_y, row_base, v1_rounding: bool = False):
    """Plain version of kernel ``describe_rotated``.

    ``integral`` (R, C+1) int32 row-stacked integrals, ``frame_rows`` the
    frame height; ``rotate`` the extractor's rotation invariance; (K,)
    ``scale_idx`` int64, ``valid`` bool, ``angle`` float32 (the given angle,
    -1 where it is to be computed), ``key_x``/``key_y`` float32,
    ``row_base`` int32. Returns (angle (K,) float32, words (K, W) int32).
    """
    vals0 = None
    if rotate:
        vals0 = smoothed_intensity(*rotated_sampler_args(pat, integral, frame_rows, scale_idx, 0,
                                                         key_x, key_y, row_base, v1_rounding))
    angle, theta = plain_rotation(pat, vals0, scale_idx, angle)
    vals = smoothed_intensity(*rotated_sampler_args(pat, integral, frame_rows, scale_idx, theta,
                                                    key_x, key_y, row_base, v1_rounding))
    return angle, pack_words(pat, vals, valid)


def table_ints(n_long: int, n_bits: int) -> int:
    """Ints of the packed pair tables, padded to 16 bytes (``table_ints``)."""
    return (3 * n_long + n_bits + 3) // 4 * 4


def dynamic_smem(tile: int, p: int, n_long: int, n_bits: int) -> int:
    """Dynamic shared memory of a CTA with a tile of ``tile`` keypoints
    (``dynamic_smem``): the packed tables and two tiles' values."""
    return 4 * (table_ints(n_long, n_bits) + 2 * tile * p)


@dataclasses.dataclass(frozen=True)
class PatternLayout:
    """A pattern's sizes, its tables' types and shapes checked against what
    kernel ``describe_rotated`` takes (shapes only: no value is read)."""

    p: int
    n_long: int
    n_bits: int
    n_words: int
    device: torch.device

    @staticmethod
    def of(pat) -> "PatternLayout":
        n_scales, n_rot, p = pat.lut_x.shape
        n_long, n_bits = pat.long_i.shape[0], pat.short_i.shape[0]
        dev = pat.lut_x.device
        spec = [
            ("lut_x", pat.lut_x, torch.float32, (n_scales, n_rot, p)),
            ("lut_y", pat.lut_y, torch.float32, (n_scales, n_rot, p)),
            ("lut_sigma", pat.lut_sigma, torch.float32, (n_scales, p)),
            ("lut_scaling", pat.lut_scaling, torch.int32, (n_scales, p)),
            ("lut_scaling2", pat.lut_scaling2, torch.int32, (n_scales, p)),
            ("long_i", pat.long_i, torch.int64, (n_long,)),
            ("long_j", pat.long_j, torch.int64, (n_long,)),
            ("long_wdx", pat.long_wdx, torch.int32, (n_long,)),
            ("long_wdy", pat.long_wdy, torch.int32, (n_long,)),
            ("short_i", pat.short_i, torch.int64, (n_bits,)),
            ("short_j", pat.short_j, torch.int64, (n_bits,)),
        ]
        _check(spec, dev)
        if n_rot != N_ROT:
            raise ValueError(f"the angle chain's constants take {N_ROT} rotations, got {n_rot}")
        smem = dynamic_smem(1, p, n_long, n_bits) + STATIC_SMEM
        if p > MAX_INDEX or smem > MAX_SMEM:
            raise ValueError(f"a pattern of {p} points, {n_long} long and {n_bits} short pairs "
                             f"needs {smem} bytes of shared memory a block; at most {MAX_SMEM} "
                             f"bytes and {MAX_INDEX} points fit")
        return PatternLayout(p, n_long, n_bits, pat.descriptor_words, dev)


def pack_tables(pat) -> torch.Tensor:
    """The pattern's pair tables as kernel ``describe_rotated`` stages them,
    one int32 tensor on the pattern's device: (wdx, wdy) of each long pair,
    then each long pair and each short pair as ``i | j << 16``, zeros to a
    multiple of 4 ints. Every index must lie in [0, P) and fit int16."""
    lay = PatternLayout.of(pat)
    for name in ("long_i", "long_j", "short_i", "short_j"):
        idx = getattr(pat, name)
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= min(lay.p, MAX_INDEX + 1)):
            raise ValueError(f"{name}: indices must lie in [0, {lay.p}) and fit int16 "
                             f"(at most {MAX_INDEX}), got [{int(idx.min())}, {int(idx.max())}]")
    out = torch.zeros(table_ints(lay.n_long, lay.n_bits), dtype=torch.int32, device=lay.device)
    n_long = lay.n_long
    out[:2 * n_long] = torch.stack([pat.long_wdx, pat.long_wdy], dim=1).reshape(-1)
    out[2 * n_long:3 * n_long] = (pat.long_i | (pat.long_j << 16)).to(torch.int32)
    out[3 * n_long:3 * n_long + lay.n_bits] = (pat.short_i | (pat.short_j << 16)).to(torch.int32)
    return out


@dataclasses.dataclass(frozen=True)
class KernelTables:
    """What kernel ``describe_rotated`` takes of a pattern, checked once:
    its layout, the packed pair tables and the launch arguments of both."""

    layout: PatternLayout
    packed: torch.Tensor
    args: tuple  # lut_x .. lut_scaling2, tables, L, n_bits

    @staticmethod
    def of(pat) -> "KernelTables":
        lay, packed = pat.kernel_layout, pack_tables(pat)
        if packed.data_ptr() % 16:
            raise ValueError("the packed tables must be 16-byte aligned for the bulk copy")
        args = (pat.lut_x.data_ptr(), pat.lut_y.data_ptr(), pat.lut_sigma.data_ptr(),
                pat.lut_scaling.data_ptr(), pat.lut_scaling2.data_ptr(), packed.data_ptr(),
                lay.n_long, lay.n_bits)
        return KernelTables(lay, packed, args)


def _check(spec, dev) -> None:
    for name, t, dt, shape in spec:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} on {dev}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def describe_rotated_cuda(pat, integral, frame_rows: int, rotate: bool, scale_idx, valid, angle,
                          key_x, key_y, row_base, v1_rounding: bool = False):
    """Kernel ``describe_rotated``: :func:`describe_rotated_plain` on the
    card, one launch. The per-call inputs and the pattern's layout are
    checked first, then that they lie on a card; the pattern's tables are
    checked and packed once (``pat.kernel_tables``)."""
    dev = integral.device
    k = scale_idx.shape[0]
    _check([
        ("integral", integral, torch.int32, None),
        ("scale_idx", scale_idx, torch.int64, (k,)),
        ("valid", valid, torch.bool, (k,)),
        ("angle", angle, torch.float32, (k,)),
        ("key_x", key_x, torch.float32, (k,)),
        ("key_y", key_y, torch.float32, (k,)),
        ("row_base", row_base, torch.int32, (k,)),
    ], dev)
    if integral.dim() != 2 or (frame_rows + 1) * integral.shape[1] >= 2**31:
        raise ValueError("integral: expected (R, C+1) with fewer than 2^31 ints a frame")
    lay = pat.kernel_layout
    if lay.device != dev:
        raise ValueError(f"the pattern's tables lie on {lay.device}, the inputs on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"describe_rotated_cuda needs CUDA tensors, got {dev}")
    tables = pat.kernel_tables
    out_angle = torch.empty((k,), dtype=torch.float32, device=dev)
    desc = torch.empty((k, lay.n_words), dtype=torch.int32, device=dev)
    if k == 0:
        return out_angle, desc
    args = (integral.data_ptr(), integral.shape[1] - 1, frame_rows, int(bool(rotate)),
            scale_idx.data_ptr(), valid.data_ptr(), angle.data_ptr(), key_x.data_ptr(),
            key_y.data_ptr(), row_base.data_ptr(), *tables.args, out_angle.data_ptr(),
            desc.data_ptr(), k, lay.p, N_ROT, lay.n_words)
    if v1_rounding:
        _kernels.launch("describe_rotated", "describe_rotated_v1", dev, *args, 1)
    else:
        _kernels.launch("describe_rotated", "describe_rotated", dev, *args, 0)
    return out_angle, desc


def describe_rotated(pat, integral, *args, **kwargs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if integral.device.type == "cpu":
        return describe_rotated_plain(pat, integral, *args, **kwargs)
    return describe_rotated_cuda(pat, integral, *args, **kwargs)

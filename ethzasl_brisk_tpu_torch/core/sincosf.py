"""The float32 ``sin`` and ``cos`` the JAX package takes, as plain torch ops.

``jnp.sin`` and ``jnp.cos`` in float32 on the CPU call the C library's
``sinf`` and ``cosf``: glibc's implementation in double precision
(``sysdeps/ieee754/flt-32/s_sinf.c``, ``s_cosf.c``, ``sincosf.h``,
``sincosf_data.c``). ``torch.sin`` and ``torch.cos`` differ from them on
about 5 % of float32 angles, which the camera grid's angle back-transform
carries into its angle. This module transcribes glibc's chain in float64
torch ops, one rounding each (no fused op), every branch on every lane:

* ``|x| < 2^-12``: ``x`` for sin, 1 for cos;
* ``|x| < pi/4`` (by the top 12 bits): the polynomials on ``x``;
* ``|x| < 120``: the quadrant ``n`` from ``x * 2/pi`` scaled by ``2^24``,
  ``x - n * pi/2``, the polynomials with the quadrant's signs;
* larger: the reduction by the 192-bit ``4/pi`` table (``reduce_large``),
  in int64 arithmetic that wraps as the C source's uint64 does;
* NaN for inf and NaN.

``sincosf_plain`` is the plain version; ``sincosf_cuda`` launches kernel
``sincosf_elementwise`` (``csrc/angle.cu``), the same chain as a device
function; ``sincosf`` picks by device.
"""
from __future__ import annotations

import torch

from ethzasl_brisk_tpu_torch import _kernels

f64 = torch.float64
_h = float.fromhex

HPI_INV_2_24 = _h("0x1.45f306dc9c883p+23")   # 2/pi * 2^24
HPI = _h("0x1.921fb54442d18p+0")             # pi/2
PI63 = _h("0x1.921fb54442d18p-62")           # pi * 2^-64, the large reduction's scale
COS = (1.0, _h("-0x1.ffffffd0c621cp-2"), _h("0x1.55553e1068f19p-5"),
       _h("-0x1.6c087e89a359dp-10"), _h("0x1.99343027bf8c3p-16"))    # c0 .. c4
SIN = (_h("-0x1.555545995a603p-3"), _h("0x1.1107605230bc4p-7"),
       _h("-0x1.994eb3774cf24p-13"))                                  # s1 .. s3
INV_PIO4 = (
    0xA2, 0xA2F9, 0xA2F983, 0xA2F9836E, 0xF9836E4E, 0x836E4E44, 0x6E4E4415, 0x4E441529,
    0x441529FC, 0x1529FC27, 0x29FC2757, 0xFC2757D1, 0x2757D1F5, 0x57D1F534, 0xD1F534DD,
    0xF534DDC0, 0x34DDC0DB, 0xDDC0DB62, 0xC0DB6295, 0xDB629599, 0x6295993C, 0x95993C43,
    0x993C4390, 0x3C439041,
)
_PIO4_TOP12 = 0x3F4      # abstop12(0x1.921fb6p-1f)
_TINY_TOP12 = 0x398      # abstop12(0x1p-12f)
_120_TOP12 = 0x42F       # abstop12(120.0f)
_INF_TOP12 = 0x7F8


def _poly(x, x2, cos_branch, neg):
    """``sinf_poly``: the sine polynomial on ``x`` or, where ``cos_branch``,
    the cosine polynomial, negated where ``neg`` (the second table)."""
    x3 = x * x2
    s1 = SIN[1] + x2 * SIN[2]
    x7 = x3 * x2
    s = x + x3 * SIN[0]
    sin_v = s + x7 * s1
    sg = torch.where(neg, -1.0, 1.0).to(f64)
    c0, c1, c2, c3, c4 = (sg * c for c in COS)
    x4 = x2 * x2
    cc2 = c3 + x2 * c4
    cc1 = c0 + x2 * c1
    x6 = x4 * x2
    c = cc1 + x4 * c2
    cos_v = c + x6 * cc2
    return torch.where(cos_branch, cos_v, sin_v)


def _reduce_large(bits):
    """``reduce_large``: (x mod pi/2 in double, quadrant n) for |x| >= 120,
    from the float's bits. Lanes below 120 give values nobody reads."""
    table = torch.tensor(INV_PIO4, dtype=torch.int64, device=bits.device)
    i = (bits >> 26) & 15
    shift = (bits >> 23) & 7
    xi = ((bits & 0xFFFFFF) | 0x800000) << shift
    res0 = (xi * table[i]) & 0xFFFFFFFF                 # uint32 product
    res1 = xi * table[i + 4]
    res2 = xi * table[i + 8]
    res0 = ((res2 >> 32) & 0xFFFFFFFF) | (res0 << 32)   # wraps as uint64 does
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.to(f64) * PI63, n


def sincosf_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """glibc's float32 ``sinf`` and ``cosf`` of a float32 tensor: ``jnp.sin``
    and ``jnp.cos`` on the CPU, bit for bit. Returns (sin, cos)."""
    if x.dtype != torch.float32:
        raise TypeError(f"sincosf takes float32, got {x.dtype}")
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    top = (bits >> 20) & 0x7FF
    sign = bits >> 31
    xd = x.to(f64)
    # |x| < 120: the quadrant from the scaled product, round half up.
    n_fast = ((xd * HPI_INV_2_24).to(torch.int32) + 0x800000) >> 24
    r_fast = xd - n_fast.to(f64) * HPI
    r_large, n_large = _reduce_large(bits)
    large = top >= _120_TOP12
    r = torch.where(large, r_large, r_fast)
    q = torch.where(large, n_large + sign, n_fast.to(torch.int64))  # quadrant of the signs
    n = torch.where(large, n_large, n_fast.to(torch.int64))          # quadrant of the branch
    s = torch.where(((q & 3) == 1) | ((q & 3) == 2), -1.0, 1.0).to(f64)
    neg = (q & 2) != 0
    rs, r2 = r * s, r * r
    sin_red = _poly(rs, r2, (n & 1) == 1, neg)
    cos_red = _poly(rs, r2, (n & 1) == 0, neg)
    no = torch.zeros_like(neg)
    x2 = xd * xd
    sin_small = _poly(xd, x2, no, no)
    cos_small = _poly(xd, x2, ~no, no)
    small, tiny = top < _PIO4_TOP12, top < _TINY_TOP12
    sin_v = torch.where(small, torch.where(tiny, xd, sin_small), sin_red).to(torch.float32)
    cos_v = torch.where(small, torch.where(tiny, 1.0, cos_small), cos_red).to(torch.float32)
    bad = top >= _INF_TOP12
    nan = torch.full_like(x, float("nan"))
    return torch.where(bad, nan, sin_v), torch.where(bad, nan, cos_v)


def sincosf_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel ``sincosf_elementwise``: :func:`sincosf_plain` on the card."""
    if x.dtype != torch.float32:
        raise TypeError(f"sincosf takes float32, got {x.dtype}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"sincosf_cuda needs a CUDA tensor, got {dev}")
    if not x.is_contiguous():
        x = x.contiguous()
    if x.numel() >= 2**31:
        raise ValueError("sincosf_elementwise takes fewer than 2^31 elements")
    sin_v, cos_v = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        _kernels.launch("sincosf_elementwise", "sincosf_elementwise", dev,
                        x.data_ptr(), sin_v.data_ptr(), cos_v.data_ptr(), x.numel())
    return sin_v, cos_v


def sincosf(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return sincosf_plain(x)
    return sincosf_cuda(x)

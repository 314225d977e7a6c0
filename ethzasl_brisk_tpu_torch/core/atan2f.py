"""The float32 ``atan2`` the JAX package takes, as plain torch ops.

``jnp.arctan2`` in float32 on the CPU lowers to ``llvm.atan2.f32``, which
calls the C library's ``atan2f``: glibc's fdlibm chain
(``sysdeps/ieee754/flt-32/e_atan2f.c`` and ``s_atanf.c``). ``torch.atan2``
is another chain and differs from it on about 17 % of integer pairs, which
moves BRISK's rotation bin wherever the angle sits at a bin edge. This
module transcribes the fdlibm chain:

* one IEEE rounding per torch op: no fused op (``addcmul``, ``addcdiv``,
  ``lerp``), and every division divides by a tensor on the operands' device
  (PyTorch's CUDA ``div`` turns a division by a host scalar into a multiply
  by its reciprocal);
* every branch is computed on every lane and picked with ``torch.where``,
  so a lane's bits never depend on its place in the tensor.

``atan2f_plain`` is the plain version; ``atan2f_cuda`` launches the same
chain as a device function (``csrc/angle.cu``, ``atan2f_elementwise``),
copying no input that is already contiguous and of one shape;
``atan2f`` picks by device. ``describe/orientation.py`` builds BRISK's
orientation step on the same chain.

Two details decide whether the bits match: ``aT[0]`` is ``0x3eaaaaab``, the
value of the source's decimal constant (its comment says ``0x3eaaaaaa``),
and ``atanf`` returns +-pi/2 from ``|x| >= 2^25`` (``0x4c000000``).
"""
from __future__ import annotations

import numpy as np
import torch

from ethzasl_brisk_tpu_torch import _kernels


def _f32(bits: int) -> float:
    """The float32 of a bit pattern, as a Python float (exactly)."""
    return float(np.array([bits], np.uint32).view(np.float32)[0])


PI_O_4 = _f32(0x3F490FDB)
PI_O_2 = _f32(0x3FC90FDB)
PI = _f32(0x40490FDB)
PI_LO = _f32(0xB3BBBD2E)
ATANHI = tuple(_f32(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA))
ATANLO = tuple(_f32(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168))
AT = tuple(_f32(b) for b in (
    0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
    0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7,
))
# Sums the C source forms in float32 from the constants above.
ATAN_INF = float(np.float32(ATANHI[3]) + np.float32(ATANLO[3]))      # atanhi[3]+atanlo[3]
PI_O_2_LO = float(np.float32(PI_O_2) + np.float32(0.5) * np.float32(PI_LO))
THREE_PI_O_4 = float(np.float32(3.0) * np.float32(PI_O_4))

_ABS = 0x7FFFFFFF
_INF = 0x7F800000


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``atanf`` (``s_atanf.c``), lane by lane."""
    if x.dtype != torch.float32:
        raise TypeError(f"atanf takes float32, got {x.dtype}")
    hx = _bits(x)
    ix = hx & _ABS
    ax = x.abs()
    one = torch.ones_like(x)
    # The argument reduction of every range, on every lane (7/16 <= |x|).
    r0 = (ax * 2.0 - 1.0) / (ax + 2.0)          # id 0: |x| < 11/16
    r1 = (ax - 1.0) / (ax + 1.0)                # id 1: |x| < 19/16
    r2 = (ax - 1.5) / (ax * 1.5 + 1.0)          # id 2: |x| < 39/16
    r3 = torch.neg(one) / ax                    # id 3: |x| < 2^25
    lt_7_16 = ix < 0x3EE00000
    ident = torch.where(lt_7_16, -1, torch.where(
        ix < 0x3F300000, 0, torch.where(ix < 0x3F980000, 1, torch.where(ix < 0x401C0000, 2, 3))))
    xr = torch.where(lt_7_16, x, torch.where(
        ident == 0, r0, torch.where(ident == 1, r1, torch.where(ident == 2, r2, r3))))
    z = xr * xr
    w = z * z
    s1 = z * (AT[0] + w * (AT[2] + w * (AT[4] + w * (AT[6] + w * (AT[8] + w * AT[10])))))
    s2 = w * (AT[1] + w * (AT[3] + w * (AT[5] + w * (AT[7] + w * AT[9]))))
    s = s1 + s2
    small = torch.where(ix < 0x31000000, x, xr - xr * s)    # |x| < 2^-29: x itself
    idc = ident.clamp(min=0)
    hi = torch.tensor(ATANHI, dtype=torch.float32, device=x.device)[idc]
    lo = torch.tensor(ATANLO, dtype=torch.float32, device=x.device)[idc]
    red = hi - ((xr * s - lo) - xr)
    red = torch.where(hx < 0, -red, red)
    out = torch.where(lt_7_16, small, red)
    big = torch.where(hx > 0, ATAN_INF, -ATAN_INF).to(torch.float32)
    out = torch.where(ix >= 0x4C000000, big, out)
    return torch.where(ix > _INF, x + x, out)                # NaN


def atan2f_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``atan2f`` (``e_atan2f.c``): ``jnp.arctan2`` on the
    CPU, bit for bit. ``y`` and ``x`` are float32 tensors."""
    _check(y, x)
    y, x = torch.broadcast_tensors(y, x)
    hx, hy = _bits(x), _bits(y)
    ix, iy = hx & _ABS, hy & _ABS
    sx, sy = hx < 0, hy < 0
    x_one = hx == 0x3F800000
    # One atanf serves both x == 1 (atanf(y)) and the general |y / x|.
    a = atanf(torch.where(x_one, y, (y / x).abs()))
    k = (iy - ix) >> 23
    z = torch.where(k > 60, PI_O_2_LO, torch.where(sx & (k < -60), 0.0, a)).to(torch.float32)
    pi = torch.full_like(x, PI)
    gen = torch.where(sx, torch.where(sy, (z - PI_LO) - pi, pi - (z - PI_LO)),
                      torch.where(sy, -z, z))
    # The special cases, innermost last in the C source's order.
    sign_pi = torch.where(sy, -PI, PI).to(torch.float32)
    sign_pi_o_2 = torch.where(sy, -PI_O_2, PI_O_2).to(torch.float32)
    both_inf = torch.where(sx, torch.where(sy, -THREE_PI_O_4, THREE_PI_O_4),
                           torch.where(sy, -PI_O_4, PI_O_4)).to(torch.float32)
    x_inf = torch.where(sx, sign_pi, torch.where(sy, -0.0, 0.0).to(torch.float32))
    out = torch.where(iy == _INF, sign_pi_o_2, gen)
    out = torch.where(ix == _INF, torch.where(iy == _INF, both_inf, x_inf), out)
    out = torch.where(ix == 0, sign_pi_o_2, out)
    out = torch.where(iy == 0, torch.where(sx, sign_pi, y), out)
    out = torch.where(x_one, a, out)
    return torch.where((ix > _INF) | (iy > _INF), x + y, out)


def _check(y: torch.Tensor, x: torch.Tensor) -> None:
    if y.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"atan2f takes float32, got {y.dtype} and {x.dtype}")


def atan2f_cuda(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Kernel ``atan2f_elementwise``: :func:`atan2f_plain` on the card."""
    _check(y, x)
    dev = x.device
    if dev.type != "cuda" or y.device != dev:
        raise ValueError(f"atan2f_cuda needs CUDA tensors on one card, got {y.device}, {dev}")
    if y.shape != x.shape:
        y, x = torch.broadcast_tensors(y, x)
    if not y.is_contiguous():
        y = y.contiguous()
    if not x.is_contiguous():
        x = x.contiguous()
    if x.numel() >= 2**31:
        raise ValueError("atan2f_elementwise takes fewer than 2^31 elements")
    out = torch.empty_like(x)
    if out.numel():
        _kernels.launch("atan2f_elementwise", "atan2f_elementwise", dev,
                        y.data_ptr(), x.data_ptr(), out.data_ptr(), out.numel())
    return out


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return atan2f_plain(y, x)
    return atan2f_cuda(y, x)

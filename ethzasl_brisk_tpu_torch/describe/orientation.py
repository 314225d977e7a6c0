"""BRISK's orientation step: the angle and rotation bin of each keypoint
from its long-pair gradient sums, bit for bit the JAX package's float32
chain (``ethzasl_brisk_tpu/describe/extractor.py``, ``_describe_core``).

Every JAX describe entry point is jitted, and XLA:CPU compiles the chain's
``atan2(d1, d0) / float32(pi) * 180`` and ``trunc(N_ROT * angle / 360 +
0.5)`` to (the compiled HLO; the constants are its folded ones):

* ``atan2f(float(d1), float(d0))``, glibc's chain (``core/atan2f.py``);
* one multiply by ``DEG_PER_RAD`` (float32 ``0x42652ee0``, 57.2957764);
* the given angle where none is needed (``angle != -1``);
* ``theta = trunc(fma(angle, BINS_PER_DEG, 0.5))``: one multiply by
  float32 ``0x40360b61`` (2.84444451), the ``+ 0.5`` contracted into it
  with one rounding to float32; then wrapped into ``[0, N_ROT)``.

The 16-bit path's float sampler is held to the JAX package run op by op
(its jitted program FMA-contracts the sampler's float chain, which no
ordered rounding reproduces), and so is its angle chain: with ``op_by_op``
the angle is ``atan2f(...) / float32(pi) * 180`` and ``theta = trunc(N_ROT
* angle / 360 + 0.5)``, each step rounded on its own, the divisions true
ones.

``orientation_plain`` is the plain version: it takes the fused
multiply-add in float64, where a float32 product is exact and, wherever
the bin can change (``|angle * BINS_PER_DEG| >= 2^-5``), so is the sum,
so its one rounding to float32 is the FMA's. ``orientation_cuda`` launches
kernel ``brisk_orientation`` (``csrc/angle.cu``), one thread a keypoint;
``orientation`` picks by device.
"""
from __future__ import annotations

import torch

from ethzasl_brisk_tpu_torch import _kernels
from ethzasl_brisk_tpu_torch.core.atan2f import PI, _f32, atan2f_plain
from ethzasl_brisk_tpu_torch.core.pattern import N_ROT

DEG_PER_RAD = _f32(0x42652EE0)    # 180 / float32(pi), folded by XLA
BINS_PER_DEG = _f32(0x40360B61)   # N_ROT / 360, folded by XLA


def orientation_plain(d0, d1, given, need, op_by_op: bool = False):
    """(K,) int32 sums, (K,) float32 given angle, (K,) bool need ->
    (K,) float32 angle in degrees, (K,) int64 theta."""
    rad = atan2f_plain(d1.to(torch.float32), d0.to(torch.float32))
    if op_by_op:
        angle = torch.where(need, rad / torch.full_like(rad, PI) * 180.0, given)
        raw = angle * float(N_ROT) / torch.full_like(angle, 360.0) + 0.5
    else:
        angle = torch.where(need, rad * DEG_PER_RAD, given)
        raw = (angle.to(torch.float64) * BINS_PER_DEG + 0.5).to(torch.float32)
    theta = torch.trunc(raw).to(torch.int64)
    theta = torch.where(theta < 0, theta + N_ROT, theta)
    theta = torch.where(theta >= N_ROT, theta - N_ROT, theta)
    return angle, theta


def orientation_cuda(d0, d1, given, need, op_by_op: bool = False):
    """Kernel ``brisk_orientation``: :func:`orientation_plain` on the card."""
    dev = d0.device
    if dev.type != "cuda":
        raise ValueError(f"orientation_cuda needs CUDA tensors, got {dev}")
    (k,) = d0.shape
    for name, t, dt in (("d0", d0, torch.int32), ("d1", d1, torch.int32),
                        ("given", given, torch.float32), ("need", need, torch.bool)):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (k,) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous ({k},) {dt} on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    angle = torch.empty((k,), dtype=torch.float32, device=dev)
    theta = torch.empty((k,), dtype=torch.int64, device=dev)
    if k:
        _kernels.launch("orientation", "brisk_orientation", dev, d0.data_ptr(), d1.data_ptr(),
                        given.data_ptr(), need.data_ptr(), angle.data_ptr(), theta.data_ptr(),
                        k, N_ROT, int(op_by_op))
    return angle, theta


def orientation(d0, d1, given, need, op_by_op: bool = False):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if d0.device.type == "cpu":
        return orientation_plain(d0, d1, given, need, op_by_op)
    return orientation_cuda(d0, d1, given, need, op_by_op)

"""Ordered segment sums for the BA's normal equations.

The BA scatter-adds per-observation blocks by keyframe, by landmark and by
(landmark, keyframe). ``index_add_`` adds with atomics on the card, in an
order that changes from run to run, so two runs of the VO loop drift
apart. The indices of a solve are fixed over its iterations, so a solve
builds a CSR once (``segment_plan``: a stable argsort and the segment
offsets) and every iteration sums each segment's rows in ascending
observation order, from 0: what the CPU's ``index_add_`` does, bit for
bit, on either device.

* ``segment_sum_plain`` is the plain version: ``index_add_`` in
  observation order, which the CPU runs sequentially (on the card
  ``index_add_`` is atomic, so the plain version is the CPU's);
* ``segment_sum_cuda`` launches kernel ``segment_sum``
  (``csrc/segment_sum.cu``): a block per segment that stages its rows in
  shared memory, a thread a component adding them in order;
* ``segment_sum`` picks by device.

An index outside ``[0, n)`` is dropped (the JAX package's scatter drops
out-of-bounds updates; ``partition_problem``'s padding slots are such).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ethzasl_brisk_tpu_torch import _kernels


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """A CSR of ``n`` segments over O observations."""

    key: torch.Tensor      # (O,) int64: the segment of each observation, ``n`` if dropped
    order: torch.Tensor    # (O,) int64: observations by segment, ascending within one
    offsets: torch.Tensor  # (n + 1,) int64: segment s is order[offsets[s]:offsets[s + 1]]
    n: int


def segment_plan(idx: torch.Tensor, n: int) -> SegmentPlan:
    """The CSR of ``idx`` over ``n`` segments, on ``idx``'s device, with no
    host sync."""
    key = torch.where((idx >= 0) & (idx < n), idx, n).to(torch.int64)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n + 1)[:n]
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return SegmentPlan(key, order, offsets, n)


def segment_sum_plain(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(O, ...) values -> (n, ...) sums, by ``index_add_`` in observation
    order (the CPU's adds, one after the other, from 0)."""
    out = torch.zeros((plan.n + 1, *values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add_(0, plan.key, values)[:plan.n]


def segment_sum_cuda(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Kernel ``segment_sum``: :func:`segment_sum_plain`'s bits on the card."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_cuda needs CUDA tensors, got {dev}")
    if values.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"segment_sum takes float32 or float64, got {values.dtype}")
    if plan.order.device != dev or tuple(plan.order.shape) != values.shape[:1]:
        raise ValueError("the plan and the values must be on one card, one row an observation")
    width = math.prod(values.shape[1:])
    if plan.n * width >= 2**31 or values.shape[0] >= 2**31:
        raise ValueError("segment_sum takes fewer than 2^31 outputs and observations")
    values = values.contiguous()
    out = torch.empty((plan.n, *values.shape[1:]), dtype=values.dtype, device=dev)
    if out.numel():
        _kernels.launch("segment_sum", "segment_sum", dev, values.data_ptr(),
                        plan.order.data_ptr(), plan.offsets.data_ptr(), out.data_ptr(),
                        plan.n, width, int(values.dtype == torch.float64))
    return out


def segment_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if values.device.type == "cpu":
        return segment_sum_plain(values, plan)
    return segment_sum_cuda(values, plan)

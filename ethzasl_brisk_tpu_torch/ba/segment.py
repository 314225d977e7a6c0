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
* ``segment_sums_cuda`` launches kernel ``segment_sums``
  (``csrc/segment_sum.cu``) once for every (values, plan) item of a call
  site: a warp a (segment, 32-component slice), its lanes adding their
  components' rows in order, the gathers of the next rows in flight;
* ``segment_sums`` picks by device (one launch a call site on the card);
  ``segment_sum`` is its one-item call.

An index outside ``[0, n)`` is dropped (the JAX package's scatter drops
out-of-bounds updates; ``partition_problem``'s padding slots are such).
"""
from __future__ import annotations

import ctypes
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


SLICE = 32      # components a warp of the kernel sums (csrc/segment_sum.cu kSlice)
MAX_ITEMS = 8   # items one launch takes (kMaxItems)


def _check_items(items) -> None:
    """One device and one float type for every item, a plan of the
    values' length on that device."""
    dev, dtype = items[0][0].device, items[0][0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"segment sums take float32 or float64, got {dtype}")
    for values, plan in items:
        if values.device != dev or values.dtype != dtype:
            raise ValueError(f"segment_sums takes one device and one dtype, got {dev} {dtype} "
                             f"and {values.device} {values.dtype}")
        if plan.order.device != dev or tuple(plan.order.shape) != values.shape[:1]:
            raise ValueError("the plan and the values must be on one device, one row an "
                             "observation")


def segment_sums_cuda(items) -> list[torch.Tensor]:
    """Kernel ``segment_sums``: :func:`segment_sum_plain` of every
    (values, plan) item, bit for bit, in one launch on the card."""
    items = list(items)
    dev = items[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"segment_sums_cuda needs CUDA tensors, got {dev}")
    _check_items(items)
    if len(items) > MAX_ITEMS:
        raise ValueError(f"segment_sums takes at most {MAX_ITEMS} items, got {len(items)}")
    outs, fields = [], []
    # Items with fewer segments first: a keyframe plan's few long chains
    # start on the first warps.
    for i in sorted(range(len(items)), key=lambda i: items[i][1].n):
        values, plan = items[i]
        width = math.prod(values.shape[1:])
        if plan.n * width >= 2**31 or values.shape[0] >= 2**31:
            raise ValueError("segment sums take fewer than 2^31 outputs and observations")
        if not values.is_contiguous():
            values = values.contiguous()
        out = torch.empty((plan.n, *values.shape[1:]), dtype=values.dtype, device=dev)
        outs.append((i, out, values))
        if out.numel():
            fields += (values.data_ptr(), plan.order.data_ptr(), plan.offsets.data_ptr(),
                       out.data_ptr(), plan.n, width)
    if fields:
        table = (ctypes.c_int64 * len(fields))(*fields)
        _kernels.launch("segment_sums", "segment_sum", dev, table, len(fields) // 6,
                        int(items[0][0].dtype == torch.float64))
    return [out for _, out, _ in sorted(outs, key=lambda t: t[0])]


def segment_sums(items) -> list[torch.Tensor]:
    """The (n, ...) sums of every (values, plan) item, each bit for bit
    :func:`segment_sum_plain`: one kernel launch for all of them for CUDA
    tensors, the plain version for CPU tensors. Every item has one device
    and one float type."""
    items = list(items)
    if not items:
        return []
    if items[0][0].device.type != "cpu":
        return segment_sums_cuda(items)
    _check_items(items)
    return [segment_sum_plain(values, plan) for values, plan in items]


def segment_sum_cuda(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Kernel ``segment_sums`` on one item: :func:`segment_sum_plain`'s
    bits on the card."""
    return segment_sums_cuda([(values, plan)])[0]


def segment_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    return segment_sums([(values, plan)])[0]

"""Timing on the card and the least time the card could take.

``cuda_time`` times a function by CUDA events, which bracket the host work
of each call as well, with its inputs warm in L2 from the call before;
``device_time`` reads the kernels' own time on the card from
``torch.profiler``, each call from a cold L2 as the bound assumes;
``device_busy_ms`` sums the card's busy time over one call;
``card_line`` is the run's card's name and power limit as ``nvidia-smi``
reports them, printed beside every time. ``bound_ms`` is the least time one NVIDIA
H100 SXM could take for a piece of work: the larger of its bytes over the
device-memory rate and its operations over the peak rate for their type.
The peaks are the published ones at the full 700 W limit (NVIDIA's data
sheet): 3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor
cores, which is 132 SMs x 128 lanes x 2 (a fused multiply-add) x 1.98 GHz,
and 34 TFLOP/s of float64 outside them.
The data sheet gives no int32 rate; the Hopper white paper gives 64 int32
lanes per SM, so at the same clock and counting a multiply-add as two
operations, 33.5 Tops/s. Where a gather's traffic depends on its indices,
``distinct_sector_bytes`` counts the 32-byte sectors the indices touch, the
least the card can read.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 132 * 64 * 2 * 1.98e9
SECTOR = 32  # bytes: the unit in which the card moves device memory
L2_BYTES = 50 * 2**20  # H100's L2 cache
TRACE_ATTEMPTS = 3
LEAD_CALLS = 6  # calls at the start of a trace that are not counted


def card_line(device: str | torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card ``device``, selected
    by its UUID: an index would name another card under
    ``CUDA_VISIBLE_DEVICES``."""
    uuid = str(torch.cuda.get_device_properties(torch.device(device)).uuid).removeprefix("GPU-")
    out = subprocess.run(
        ["nvidia-smi", f"--id=GPU-{uuid}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_time(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median time (ms) of fn() over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _traced_calls(fn, flush: torch.Tensor, kernel_names, calls: int) -> list[float]:
    """Device time (ms) of each of ``calls`` calls of fn(), each after a read
    of ``flush`` on the card it lies on, as one profiler trace shows them
    (see ``device_time``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.sum(dim=1)
            torch.cuda.synchronize(flush.device)
            fn()
            torch.cuda.synchronize(flush.device)
    work = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start, ms = ((e.start_ns(), e.duration_ns() / 1e6) if hasattr(e, "start_ns")
                         else (1e3 * e.start_us(), e.duration_us() / 1e3))
            work.append((start, ms, e.name()))
    times, flushing = [], False
    for _, ms, name in sorted(work):
        if "reduce_kernel" in name:
            if not flushing:
                times.append(0.0)
            flushing = True
            continue
        flushing = False
        if times and (kernel_names is None or any(k in name for k in kernel_names)):
            times[-1] += ms
    return times


def device_time(fn, device: str | torch.device, kernel_names: tuple[str, ...] | None = None,
                reps: int = 10, warmup: int = 3) -> float:
    """Median device time (ms) of fn() over ``reps`` calls on card
    ``device``, each from a cold L2: the summed own time on the card of the
    kernels whose names contain one of ``kernel_names`` (all of the call's
    device work, copies included, when None), from a ``torch.profiler``
    trace of CUDA activity.

    Before each call a row-wise float32 sum (one reduction kernel, no cast)
    on that card reads a buffer twice its L2's size, and the card is
    synchronised before and after the call; the sum's kernel marks where
    each call's work starts in the trace and is not counted, so ``fn`` must
    launch no reduction of its own. The profiler can miss events, at the start of a
    trace or all of them: each trace starts with ``LEAD_CALLS`` more calls,
    not counted, and a trace that still lacks a call is taken again, up to
    ``TRACE_ATTEMPTS`` times, before this raises."""
    for _ in range(warmup):
        fn()
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_time times work on a card, got {device}")
    flush = torch.empty((2 * L2_BYTES // 4 // 512, 512), dtype=torch.float32, device=device)
    torch.cuda.synchronize(device)
    seen = []
    for _ in range(TRACE_ATTEMPTS):
        times = _traced_calls(fn, flush, kernel_names, reps + LEAD_CALLS)[-reps:]
        if len(times) == reps and all(times):
            return statistics.median(times)
        seen.append(len(times))
    raise RuntimeError(f"device_time: {reps} calls of {kernel_names or 'any kernel'} not in "
                       f"{TRACE_ATTEMPTS} profiler traces (found {seen})")


def busy_ms(events) -> float:
    """The summed duration (ms) of the device events (kernels, copies,
    sets) among a trace's kineto events, each counted once.
    ``key_averages()`` lists a kernel's time twice, under the kernel and
    again as the self device time of the operator that launched it, so a
    sum over its rows doubles the device work."""
    from torch.autograd import DeviceType

    total = 0.0
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            total += (e.duration_ns() / 1e6 if hasattr(e, "duration_ns")
                      else e.duration_us() / 1e3)
    return total


def device_busy_ms(fn) -> float:
    """The card's busy time (ms) in one call of fn(), after one warm-up
    call: every kernel, copy and set of a ``torch.profiler`` trace, once
    each (0.0 if the trace holds no device event)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return busy_ms(prof.profiler.kineto_results.events())


def bound_ms(nbytes: float, int32_ops: float = 0.0, fp32_ops: float = 0.0,
             fp64_ops: float = 0.0) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): what bounds the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (int32_ops / INT32_OPS_PER_S + fp32_ops / FP32_OPS_PER_S
             + fp64_ops / FP64_OPS_PER_S)
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def distinct_sector_bytes(flat: torch.Tensor, element: int, numel: int) -> int:
    """Bytes of the distinct sectors that element indices ``flat`` touch in
    a table of ``numel`` elements of ``element`` bytes."""
    hit = torch.zeros((numel * element + SECTOR - 1) // SECTOR, dtype=torch.bool,
                      device=flat.device)
    hit[(flat.reshape(-1).to(torch.int64) * element) // SECTOR] = True
    return SECTOR * int(hit.sum())

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
operations, 33.5 Tops/s; and 16 32-bit population counts a clock an SM
(the CUDA C++ programming guide's throughput table, compute capability
9.0), 4.18 T a second. Where a gather's traffic depends on its indices,
``distinct_sector_bytes`` counts the 32-byte sectors the indices touch, the
least the card can read. Where the work is a serial chain of dependent
adds, as an ordered segment sum is, no rate helps: ``chain_bound_ms`` is
the longest chain's adds times one add's latency (``add_latency_cycles``,
timed on the card) over the card's highest SM clock (``sm_clock_hz``);
greedy uniformity's rounds are such a chain too, each a round's latency
(``round_latency_cycles``).
"""
from __future__ import annotations

import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
INT32_OPS_PER_S = 132 * 64 * 2 * 1.98e9
POPC_OPS_PER_S = 132 * 16 * 1.98e9
SECTOR = 32  # bytes: the unit in which the card moves device memory
L2_BYTES = 50 * 2**20  # H100's L2 cache
TRACE_ATTEMPTS = 10  # the profiler now and then drops whole traces, or most of one, in a row
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


def sm_clock_hz(device: str | torch.device) -> float:
    """The highest SM clock (Hz) of card ``device``, ``nvidia-smi``'s
    ``clocks.max.sm``: the clock at which a chain of latencies is
    shortest."""
    uuid = str(torch.cuda.get_device_properties(torch.device(device)).uuid).removeprefix("GPU-")
    out = subprocess.run(
        ["nvidia-smi", f"--id=GPU-{uuid}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip()) * 1e6


def add_latency_cycles(device: str | torch.device, dtype: torch.dtype) -> float:
    """SM cycles of one dependent add (``__fadd_rn`` for float32,
    ``__dadd_rn`` for float64) on card ``device``: one thread's chains of
    1,024 and 8,192 adds timed by the SM's clock, their difference over
    7,168 adds, so the chain's fixed cost drops out."""
    from ethzasl_brisk_tpu_torch import _kernels

    device = torch.device(device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=dtype, device=device)

    def chain(adds: int) -> int:
        _kernels.launch("add_latency", "add_latency", device, int(dtype == torch.float64), adds,
                        cycles.data_ptr(), sink.data_ptr())
        return int(cycles)

    chain(1024)
    return (chain(8192) - chain(1024)) / 7168


def round_latency_cycles(device: str | torch.device) -> float:
    """SM cycles of one round of kernel ``enforce_uniformity`` that accepts
    nothing (a shared-memory read, the ballot, the slot write, a barrier,
    the reduction) on card ``device``: a CTA's chains of 256 and 2,048
    rounds timed by the SM's clock, their difference over 1,792 rounds."""
    from ethzasl_brisk_tpu_torch import _kernels

    device = torch.device(device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=torch.int32, device=device)

    def chain(rounds: int) -> int:
        _kernels.launch("round_latency", "round_latency", device, rounds, cycles.data_ptr(),
                        sink.data_ptr())
        return int(cycles)

    chain(256)
    return (chain(2048) - chain(256)) / 1792


def chain_bound_ms(adds: int, cycles_per_add: float, clock_hz: float) -> float:
    """The least time (ms) of ``adds`` dependent adds."""
    return 1e3 * adds * cycles_per_add / clock_hz


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


def _split(work, kernel_names) -> list[list]:
    """``split_calls``' calls as [ms, kernels counted] pairs."""
    work = sorted(work)
    calls = []
    for i, (_, ms, name) in enumerate(work):
        if "spin_kernel" in name:
            calls.append([0.0, 0])
        elif "reduce_kernel" in name and i + 1 < len(work) and "spin_kernel" in work[i + 1][2]:
            continue
        elif calls and (kernel_names is None or any(k in name for k in kernel_names)):
            calls[-1][0] += ms
            calls[-1][1] += 1
    return calls


def split_calls(work, kernel_names) -> list[float]:
    """The device time (ms) of each timed call in a trace's device work,
    ``(start, ms, name)`` tuples: a call's work follows the marker kernel
    (``spin_kernel``, ``torch.cuda._sleep``) that ends the L2 flush before
    it; the flush's own reduction, the kernel just before each marker, is
    not counted, and a reduction of the timed call is."""
    return [ms for ms, _ in _split(work, kernel_names)]


def whole_calls(calls: list, made: int, reps: int, per_call: int | None = None,
                named: bool = False) -> list[float]:
    """The times of the whole calls among the last ``reps`` of a trace of
    ``made`` calls (``_split``'s pairs). Where the caller knows that a call
    launches ``per_call`` of the kernels counted, only the calls that count
    that many. Otherwise, with every marker in the trace, each call that
    counts a kernel. With markers lost, a call may have taken in the next
    call's work: of named kernels (``named``) no call is kept; of a call's
    whole device work, those that count the trace's usual number of
    kernels (a call whose kernels the profiler lost counts fewer, a merged
    one more)."""
    if per_call is not None:
        return [ms for ms, n in calls[-reps:] if n == per_call]
    counts = [n for _, n in calls if n]
    if not counts:
        return []
    if len(calls) == made:
        return [ms for ms, n in calls[-reps:] if n]
    if named:
        return []
    usual = statistics.mode(counts)
    return [ms for ms, n in calls[-reps:] if n == usual]


def _traced_calls(fn, flush: torch.Tensor, kernel_names, calls: int) -> list[list]:
    """Device time (ms) and kernels counted of each of ``calls`` calls of
    fn(), each after a read of ``flush`` on the card it lies on, as one
    profiler trace shows them (see ``device_time``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            with torch.cuda.device(flush.device):
                flush.sum(dim=1)
                torch.cuda._sleep(1)  # marks the flush's end in the trace
            torch.cuda.synchronize(flush.device)
            fn()
            torch.cuda.synchronize(flush.device)
    work = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start, ms = ((e.start_ns(), e.duration_ns() / 1e6) if hasattr(e, "start_ns")
                         else (1e3 * e.start_us(), e.duration_us() / 1e3))
            work.append((start, ms, e.name()))
    return _split(work, kernel_names)


def device_time(fn, device: str | torch.device, kernel_names: tuple[str, ...] | None = None,
                reps: int = 10, warmup: int = 3, per_call: int | None = None) -> float:
    """Median device time (ms) of fn() over ``reps`` calls on card
    ``device``, each from a cold L2: the summed own time on the card of the
    kernels whose names contain one of ``kernel_names`` (all of the call's
    device work, copies included, when None), from a ``torch.profiler``
    trace of CUDA activity.

    Before each call a row-wise float32 sum (one reduction kernel, no cast)
    on that card reads a buffer twice its L2's size, a spin of one cycle
    (``torch.cuda._sleep``) marks its end, and the card is synchronised
    before and after the call; neither is counted, so ``fn`` may launch
    reductions of its own (``split_calls``). The profiler can miss events,
    at the start of a trace, a part of it or all of it: each trace starts
    with ``LEAD_CALLS`` more calls, not counted, only whole calls count
    (``whole_calls``; ``per_call``, where given, is the number of the named
    kernels one call launches), and traces are taken until ``reps`` whole
    calls are in, up to ``TRACE_ATTEMPTS`` traces, before this raises."""
    for _ in range(warmup):
        fn()
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_time times work on a card, got {device}")
    flush = torch.empty((2 * L2_BYTES // 4 // 512, 512), dtype=torch.float32, device=device)
    torch.cuda.synchronize(device)
    times, seen = [], []
    for _ in range(TRACE_ATTEMPTS):
        calls = _traced_calls(fn, flush, kernel_names, reps + LEAD_CALLS)
        seen.append(len(calls))
        times += whole_calls(calls, reps + LEAD_CALLS, reps, per_call, kernel_names is not None)
        if len(times) >= reps:
            return statistics.median(times[:reps])
    raise RuntimeError(f"device_time: {reps} whole calls of {kernel_names or 'any kernel'} not "
                       f"in {TRACE_ATTEMPTS} profiler traces (calls found {seen})")


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
             fp64_ops: float = 0.0, popc_ops: float = 0.0) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): what bounds the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (int32_ops / INT32_OPS_PER_S + fp32_ops / FP32_OPS_PER_S
             + fp64_ops / FP64_OPS_PER_S + popc_ops / POPC_OPS_PER_S)
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def distinct_sector_bytes(flat: torch.Tensor, element: int, numel: int) -> int:
    """Bytes of the distinct sectors that element indices ``flat`` touch in
    a table of ``numel`` elements of ``element`` bytes."""
    hit = torch.zeros((numel * element + SECTOR - 1) // SECTOR, dtype=torch.bool,
                      device=flat.device)
    hit[(flat.reshape(-1).to(torch.int64) * element) // SECTOR] = True
    return SECTOR * int(hit.sum())

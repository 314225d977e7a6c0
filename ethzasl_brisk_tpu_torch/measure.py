"""Timing on the card and the least time the card could take.

``cuda_time`` times a function by CUDA events; ``card_line`` is the card's
name and power limit as ``nvidia-smi`` reports them, printed beside every
time. ``bound_ms`` is the least time one NVIDIA H100 SXM could take for a
piece of work: the larger of its bytes over the device-memory rate and its
operations over the peak rate for their type. The peaks are the published
ones at the full 700 W limit (NVIDIA's data sheet): 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores, which is 132 SMs x 128
lanes x 2 (a fused multiply-add) x 1.98 GHz. The data sheet gives no int32
rate; the Hopper white paper gives 64 int32 lanes per SM, so at the same
clock and counting a multiply-add as two operations, 33.5 Tops/s. Where a
gather's traffic depends on its indices, ``distinct_sector_bytes`` counts
the 32-byte sectors the indices touch, the least the card can read.
"""
from __future__ import annotations

import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 2 * 1.98e9
SECTOR = 32  # bytes: the unit in which the card moves device memory


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def bound_ms(nbytes: float, int32_ops: float = 0.0, fp32_ops: float = 0.0) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): what bounds the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int32_ops / INT32_OPS_PER_S + fp32_ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def distinct_sector_bytes(flat: torch.Tensor, element: int, numel: int) -> int:
    """Bytes of the distinct sectors that element indices ``flat`` touch in
    a table of ``numel`` elements of ``element`` bytes."""
    hit = torch.zeros((numel * element + SECTOR - 1) // SECTOR, dtype=torch.bool,
                      device=flat.device)
    hit[(flat.reshape(-1).to(torch.int64) * element) // SECTOR] = True
    return SECTOR * int(hit.sum())

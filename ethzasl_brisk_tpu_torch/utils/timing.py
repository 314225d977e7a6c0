"""Tagged timing registry with rolling-window statistics (port of
``utils/timing.py``).

Mirrors the reference's ``brisk::timing`` subsystem
(``brisk/include/brisk/internal/timer.h:40-190``, ``brisk/src/timer.cc``):
a process-wide registry of named timers, each keeping a rolling window of
the last N samples with total/mean/min/max/variance and Hz, plus a
``print_timing()`` report in the JAX package's format. ``debug_timer`` is
a no-op unless ``BRISK_TPU_TIMING`` is set (the reference's
``ENABLE_BRISK_TIMING`` switch, ``timer.h:182-186``).

A timer can wait for the device work a probe depends on before it stops
(``block_on``: a tensor, or tuples, lists, dicts and the port's
dataclasses such as ``KeyPoints`` and ``BaProblem`` holding tensors).
``mode="checksum"`` (the default) sums every tensor in float32 on its
device and reads one scalar back; ``mode="block"`` records a CUDA event on
each leaf device's current stream and waits for that event alone, the
counterpart of ``jax.block_until_ready``: it does not synchronise the
whole device. ``annotate`` is ``torch.profiler.record_function``, so tags
appear in ``torch.profiler`` traces.
"""
from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

import torch

_WINDOW = 50  # Accumulator<double,double,50> (timer.h:135)

_ENABLED_DEBUG = os.environ.get("BRISK_TPU_TIMING", "0") not in ("0", "")


class _Accumulator:
    """Rolling-window accumulator (timer.h:60-133 semantics)."""

    def __init__(self, window: int = _WINDOW):
        self.window = deque(maxlen=window)
        self.total_samples = 0
        self.total_time = 0.0
        self.min_v = math.inf
        self.max_v = -math.inf

    def add(self, v: float) -> None:
        self.window.append(v)
        self.total_samples += 1
        self.total_time += v
        self.min_v = min(self.min_v, v)
        self.max_v = max(self.max_v, v)

    @property
    def rolling_mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    @property
    def rolling_std(self) -> float:
        n = len(self.window)
        if n < 2:
            return 0.0
        m = self.rolling_mean
        return math.sqrt(sum((x - m) ** 2 for x in self.window) / (n - 1))

    @property
    def mean(self) -> float:
        return self.total_time / max(self.total_samples, 1)


class Timing:
    """Singleton tag registry (timer.h:135-180)."""

    _lock = threading.Lock()
    _tags: dict[str, _Accumulator] = {}

    @classmethod
    def add(cls, tag: str, seconds: float) -> None:
        with cls._lock:
            cls._tags.setdefault(tag, _Accumulator()).add(seconds)

    @classmethod
    def get(cls, tag: str) -> Optional[_Accumulator]:
        return cls._tags.get(tag)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._tags.clear()

    @classmethod
    def print_timing(cls) -> str:
        """Formatted report (Timing::Print, timer.cc)."""
        lines = ["BRISK-TPU Timing", "-" * 78]
        with cls._lock:
            for tag in sorted(cls._tags):
                a = cls._tags[tag]
                hz = 1.0 / a.rolling_mean if a.rolling_mean > 0 else 0.0
                lines.append(
                    f"{tag:<48s} {a.total_samples:>6d}  "
                    f"mean {a.rolling_mean * 1e3:9.3f}ms  "
                    f"[{a.min_v * 1e3:8.3f}, {a.max_v * 1e3:8.3f}]  "
                    f"{hz:8.1f}Hz"
                )
        return "\n".join(lines)


def tensor_leaves(probe) -> list[torch.Tensor]:
    """Every tensor inside ``probe``: a tensor, or tuples, lists, dicts and
    dataclasses holding tensors, in order."""
    if isinstance(probe, torch.Tensor):
        return [probe]
    if dataclasses.is_dataclass(probe) and not isinstance(probe, type):
        probe = [getattr(probe, f.name) for f in dataclasses.fields(probe)]
    elif isinstance(probe, dict):
        probe = list(probe.values())
    elif not isinstance(probe, (tuple, list)):
        return []
    return [t for item in probe for t in tensor_leaves(item)]


def force_device(probe) -> float:
    """Wait for everything ``probe`` depends on; return a checksum.

    Sums every tensor leaf in float32 on its device and reads back one
    scalar, which waits for the work that produced each leaf.
    """
    leaves = tensor_leaves(probe)
    if not leaves:
        return 0.0
    total = 0.0
    by_device: dict[torch.device, list[torch.Tensor]] = {}
    for x in leaves:
        by_device.setdefault(x.device, []).append(x)
    for xs in by_device.values():
        acc = torch.zeros((), dtype=torch.float32, device=xs[0].device)
        for x in xs:
            acc = acc + torch.sum(x, dtype=torch.float32)
        total += float(acc)  # one readback per device forces its chain
    return total


def block_until_ready(probe) -> None:
    """Wait for the work on each CUDA leaf's device stream through an event
    recorded there; CPU leaves are ready when they exist."""
    devices = {x.device for x in tensor_leaves(probe) if x.device.type == "cuda"}
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()


@contextmanager
def timer(tag: str, block_on=None, mode: str = "checksum"):
    """Context timer; pass tensors as ``block_on`` to include the device's
    execution time (``mode`` "checksum" or "block", see the module)."""
    if mode not in ("checksum", "block"):
        raise ValueError(f"mode must be 'checksum' or 'block', not {mode!r}")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block_on is not None:
            if mode == "checksum":
                force_device(block_on)
            else:
                block_until_ready(block_on)
        Timing.add(tag, time.perf_counter() - t0)


@contextmanager
def debug_timer(tag: str, block_on=None):
    """No-op unless BRISK_TPU_TIMING is set (DebugTimer, timer.h:182)."""
    if not _ENABLED_DEBUG:
        yield
        return
    with timer(tag, block_on):
        yield


@contextmanager
def annotate(tag: str):
    """A ``torch.profiler`` range, so tags appear in its traces."""
    with torch.profiler.record_function(tag):
        yield


class Timer:
    """Imperative start/stop timer (timing::Timer, timer.h:40-58)."""

    def __init__(self, tag: str, construct_stopped: bool = False):
        self.tag = tag
        self._t0 = None
        if not construct_stopped:
            self.start()

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        Timing.add(self.tag, time.perf_counter() - self._t0)
        self._t0 = None

    def is_timing(self) -> bool:
        return self._t0 is not None

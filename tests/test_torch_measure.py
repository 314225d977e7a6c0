"""``measure.busy_ms``: the card's busy time from a profiler trace counts
each device event once.

``torch.profiler``'s ``key_averages()`` lists a kernel's time under the
kernel and again as the self device time of the operator that launched
it, so summing its rows (what ``chip_smoke.py`` did before) doubles the
busy time. The trace's kineto events hold each kernel, copy and set once,
with its device type; ``busy_ms`` sums those of the card. Fake events
stand in for a trace here (this machine has no card to profile).
"""
import pytest
import torch
from torch.autograd import DeviceType

from ethzasl_brisk_tpu_torch import measure


class _Event:
    def __init__(self, device_type, ns):
        self._type, self._ns = device_type, ns

    def device_type(self):
        return self._type

    def duration_ns(self):
        return self._ns


class _OldEvent:
    """A kineto event of a torch that reports microseconds only."""

    def __init__(self, device_type, us):
        self._type, self._us = device_type, us

    def device_type(self):
        return self._type

    def duration_us(self):
        return self._us


def test_busy_ms_counts_device_events_once():
    # An operator on the host (3 ms, whose launch owns the kernel) and its
    # kernel (1.5 ms) and a copy (0.5 ms) on the card.
    events = [_Event(DeviceType.CPU, 3_000_000), _Event(DeviceType.CUDA, 1_500_000),
              _Event(DeviceType.CUDA, 500_000)]
    assert measure.busy_ms(events) == pytest.approx(2.0)
    assert measure.busy_ms([_OldEvent(DeviceType.CUDA, 250), _OldEvent(DeviceType.CPU, 9)]) \
        == pytest.approx(0.25)
    assert measure.busy_ms([]) == 0.0


def test_device_busy_ms_fails_without_a_card():
    """A measuring path that finds no card fails; it gives no busy time."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        measure.device_busy_ms(lambda: None)


def test_split_calls_counts_the_timed_calls_reductions():
    """``device_time``'s trace split: each call's work follows a spin
    marker; the L2 flush's reduction just before a marker is not counted,
    a reduction of the timed call is (the describe chain sums), and the
    kernel-name filter picks the kernels summed."""
    flush, mark = "void at::native::reduce_kernel<512, 1>(float)", "at::cuda::spin_kernel(long)"
    work = [
        (0, 9.0, flush), (1, 0.001, mark),
        (2, 0.5, "k2_sampler_kernel"), (3, 0.2, "void at::native::reduce_kernel<128, 4>(int)"),
        (4, 9.0, flush), (5, 0.001, mark),
        (6, 0.3, "describe_rotated_kernel"),
    ]
    assert measure.split_calls(list(reversed(work)), None) == pytest.approx([0.7, 0.3])
    assert measure.split_calls(work, ("k2_sampler",)) == pytest.approx([0.5, 0.0])
    assert measure.split_calls(work[1:], ("reduce_kernel",)) == pytest.approx([0.2, 0.0])
    assert measure.split_calls(work[2:4], None) == []  # no marker, no call


def test_whole_calls_drops_calls_the_profiler_cut():
    """``device_time`` keeps only whole calls: where the caller gives the
    kernels a call launches, the calls that count that many; else, with
    every marker in the trace, each call whose kernels arrived; with
    markers lost, of a call's whole work the calls that count the trace's
    usual number of kernels (a call that took in the next one's work counts
    more, one whose kernels were lost fewer), of named kernels none."""
    full = [[0.5, 2], [0.0, 0], [0.4, 2], [0.6, 3]]
    assert measure.whole_calls(full, 4, 3) == pytest.approx([0.4, 0.6])
    assert measure.whole_calls(full, 4, 3, per_call=2) == pytest.approx([0.4])
    cut = [[0.5, 2], [1.1, 4], [0.4, 2], [0.2, 1], [0.6, 2]]
    assert measure.whole_calls(cut, 8, 4) == pytest.approx([0.4, 0.6])
    assert measure.whole_calls(cut, 8, 4, named=True) == []
    assert measure.whole_calls(cut, 8, 4, per_call=2, named=True) == pytest.approx([0.4, 0.6])
    merged = [[0.3, 1], [0.7, 2], [0.3, 1], [0.4, 1]]
    assert measure.whole_calls(merged, 8, 4, per_call=1, named=True) == pytest.approx(
        [0.3, 0.3, 0.4])
    assert measure.whole_calls([[0.0, 0]], 8, 4) == []

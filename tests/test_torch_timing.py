"""Port parity: ``utils/timing.py`` against the JAX package's.

The same samples go into both registries; the accumulators' statistics
and ``print_timing``'s text must be equal (exact: both are the same
Python float arithmetic). The timers themselves run on the CPU here:
``force_device``'s checksum over the port's dataclasses, ``mode="block"``
(a no-op on CPU tensors), ``debug_timer``'s switch and ``annotate``'s
profiler range. Mirrors tests/test_kernels.py:348-368.
"""
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ethzasl_brisk_tpu.utils import timing as jt  # noqa: E402
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch.utils import timing as tt  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    jt.Timing.reset()
    tt.Timing.reset()
    yield
    jt.Timing.reset()
    tt.Timing.reset()


def test_statistics_and_report_equal_jax():
    rng = np.random.default_rng(0)
    samples = {"0 load": rng.uniform(1e-4, 2e-2, 3),
               "1 detect+describe": rng.uniform(1e-3, 1, 75),
               "2 radius-match vs reference (device)": [0.0125],
               "a/very/long/tag/" * 4: [1e-6, 2.0]}
    for tag, values in samples.items():
        for v in values:
            jt.Timing.add(tag, float(v))
            tt.Timing.add(tag, float(v))
    assert tt.Timing.print_timing() == jt.Timing.print_timing()
    for tag in samples:
        a, b = tt.Timing.get(tag), jt.Timing.get(tag)
        assert list(a.window) == list(b.window)  # the rolling window keeps the last 50
        for stat in ("total_samples", "total_time", "min_v", "max_v", "rolling_mean",
                     "rolling_std", "mean"):
            assert getattr(a, stat) == getattr(b, stat), (tag, stat)
    assert tt.Timing.get("1 detect+describe").total_samples == 75
    assert len(tt.Timing.get("1 detect+describe").window) == 50
    assert tt.Timing.get("missing") is None


def test_timer_and_report():
    with tt.timer("unit/stage-a"):
        time.sleep(0.01)
    t = tt.Timer("unit/stage-b")
    time.sleep(0.005)
    t.stop()
    assert not t.is_timing()
    t.stop()  # a stopped timer adds nothing
    a = tt.Timing.get("unit/stage-a")
    assert a is not None and a.total_samples == 1
    assert a.rolling_mean >= 0.009
    assert tt.Timing.get("unit/stage-b").total_samples == 1
    report = tt.Timing.print_timing()
    assert "unit/stage-a" in report and "unit/stage-b" in report
    tt.Timing.reset()
    assert tt.Timing.get("unit/stage-a") is None
    stopped = tt.Timer("unit/c", construct_stopped=True)
    assert not stopped.is_timing()
    stopped.start()
    assert stopped.is_timing()


def test_probes_walk_the_ports_containers():
    kp = KeyPoints.from_numpy([1.0, 2.0], [3.0, 4.0], device="cpu")
    desc = torch.ones((2, 12), dtype=torch.int32)
    probe = {"kp": kp, "pair": (desc, [torch.tensor(0.5)]), "skip": "text"}
    leaves = tt.tensor_leaves(probe)
    assert len(leaves) == len(kp.fields()) + 2
    expect = sum(float(x.to(torch.float32).sum()) for x in leaves)
    assert tt.force_device(probe) == pytest.approx(expect)
    assert tt.force_device(None) == 0.0
    for mode in ("checksum", "block"):
        with tt.timer(f"probe/{mode}", block_on=probe, mode=mode):
            pass
        assert tt.Timing.get(f"probe/{mode}").total_samples == 1
    with pytest.raises(ValueError):
        with tt.timer("probe/bad", mode="sync"):
            pass


def test_debug_timer_follows_the_switch(monkeypatch):
    monkeypatch.setattr(tt, "_ENABLED_DEBUG", False)
    with tt.debug_timer("dbg/off"):
        pass
    assert tt.Timing.get("dbg/off") is None
    monkeypatch.setattr(tt, "_ENABLED_DEBUG", True)
    with tt.debug_timer("dbg/on"):
        pass
    assert tt.Timing.get("dbg/on").total_samples == 1


def test_annotate_names_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tt.annotate("brisk/annotated-stage"):
            torch.ones(8).sum()
    assert "brisk/annotated-stage" in {e.key for e in prof.key_averages()}

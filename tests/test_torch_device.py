"""Where the port's entry points run: the card unless asked for the CPU.

``BriskFeature``, ``BriskExtractor``, ``HarrisFeatureDetector`` and
``FramePipeline`` default to ``device="cuda"``; without a card that raises
(nothing falls back to the CPU), and ``device="cpu"`` runs on the CPU. The
no-card case is forced by patching ``torch.cuda.is_available``, so it holds
on any machine. The card's side is in tests/test_torch_gpu.py.
"""
import pytest
import torch

from ethzasl_brisk_tpu_torch import BriskFeature, FramePipeline, HarrisFeatureDetector
from ethzasl_brisk_tpu_torch import pipeline
from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.describe.extractor import BriskExtractor
from ethzasl_brisk_tpu_torch.frames import bench_frames

SMALL = dict(octaves=0, uniformity_radius=10.0, absolute_threshold=20.0, max_candidates=512,
             max_keypoints=64)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda: BriskFeature(),
    lambda: BriskExtractor(),
    lambda: HarrisFeatureDetector(),
    lambda: FramePipeline(BriskFeature(device="cpu")),
    lambda: BriskFeature(device="cuda:0"),
], ids=["BriskFeature", "BriskExtractor", "HarrisFeatureDetector", "FramePipeline", "cuda:0"])
def test_default_device_raises_without_card(no_card, make):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_entry_points_run_on_cpu(monkeypatch):
    """device="cpu": buffers on the CPU, a CPU batch reaches detection as
    the same tensor, and every output lies on the CPU."""
    frames = torch.from_numpy(bench_frames(2, 64, 96))
    feature = BriskFeature(**SMALL, device="cpu")
    assert feature.device == torch.device("cpu")
    assert all(b.device.type == "cpu" for b in feature.buffers())

    seen = []
    real = pipeline.detect_keypoints
    monkeypatch.setattr(pipeline, "detect_keypoints",
                        lambda img, *a, **k: seen.append(img) or real(img, *a, **k))
    kps, desc = feature.detect_and_compute(frames)
    assert seen and seen[0] is frames
    assert desc.device.type == "cpu" and all(f.device.type == "cpu" for f in kps.fields())

    single = HarrisFeatureDetector(threshold=20.0, max_candidates=512, device="cpu")
    assert single.detect(frames[0]).x.device.type == "cpu"
    out = FramePipeline(feature, device="cpu").step(frames)
    assert all(t.device.type == "cpu" for t in out[1:])


def test_pipeline_and_feature_must_share_a_device():
    feature = BriskFeature(**SMALL, device="cpu")
    feature.extractor.lut_x = feature.extractor.lut_x.to("meta")
    with pytest.raises(ValueError, match="same device"):
        FramePipeline(feature, device="cpu")


@pytest.mark.parametrize("flag", [True, False])
def test_pipeline_leaves_the_tf32_flag_alone(flag):
    """Building a FramePipeline writes no process-wide matmul setting."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = flag
    try:
        FramePipeline(BriskFeature(**SMALL, device="cpu"), device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_launch_runs_on_the_tensors_card(monkeypatch):
    """``_kernels.launch`` resolves the C entry point once, makes the given
    card current around the C call only when another card is current,
    passes that card's raw stream last, counts one launch, and raises
    (without counting) on a launch error."""
    from ethzasl_brisk_tpu_torch import _kernels

    events = []

    class FakeLib:
        looked_up = 0

        def __getattr__(self, name):
            assert name == "brisk_probe_take", name
            FakeLib.looked_up += 1

            def call(*args):
                events.append(("call", args))
                return self.err
            return call

        def brisk_error_string(self, err):
            return b"fake error"

    class Guard:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            events.append(("enter", self.index))

        def __exit__(self, *exc):
            events.append(("exit", self.index))

    lib = FakeLib()
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(_kernels, "_entries", {})
    monkeypatch.setattr(_kernels, "_current_device", lambda: 0)
    monkeypatch.setattr(_kernels, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setitem(_kernels.LAUNCHES, "probe_take", 0)
    lib.err = 0
    _kernels.launch("probe_take", "probe_take", torch.device("cuda", 1), 7, 8)
    assert events == [("enter", 1), ("call", (7, 8, 1001)), ("exit", 1)]
    events.clear()
    for dev in (torch.device("cuda", 0), torch.device("cuda")):
        _kernels.launch("probe_take", "probe_take", dev, 7, 8)
    assert events == [("call", (7, 8, 1000))] * 2
    assert _kernels.LAUNCHES["probe_take"] == 3 and FakeLib.looked_up == 1
    lib.err = 3
    with pytest.raises(RuntimeError, match="fake error"):
        _kernels.launch("probe_take", "probe_take", torch.device("cuda", 1), 7, 8)
    assert _kernels.LAUNCHES["probe_take"] == 3
    with pytest.raises(ValueError, match="CUDA device"):
        _kernels.launch("probe_take", "probe_take", torch.device("cpu"), 7, 8)


def test_every_wrapper_launches_through_the_helper():
    """Every C entry point of csrc/ is launched by ``_kernels.launch`` and
    nowhere else: no module calls ``lib.brisk_*`` or bumps ``LAUNCHES``
    itself, and each counter is some launch's."""
    import ast
    import pathlib
    import re

    import ethzasl_brisk_tpu_torch
    from ethzasl_brisk_tpu_torch import _kernels

    pkg = pathlib.Path(ethzasl_brisk_tpu_torch.__file__).parent
    entries = set()
    for src in (pkg / "csrc").glob("*.cu"):
        entries |= set(re.findall(r'extern "C" int brisk_(\w+)\(', src.read_text()))
    launched, counters = set(), set()
    for path in pkg.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr.startswith("brisk_"):
                assert path.name == "_kernels.py", f"{path}: calls {node.attr} directly"
            if isinstance(node, ast.AugAssign) and "LAUNCHES" in ast.unparse(node.target):
                assert path.name == "_kernels.py", f"{path}: counts a launch by hand"
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch" and ast.unparse(node.func.value) == "_kernels"):
                entry, counter = (a.value for a in node.args[:2])
                launched.add(entry)
                counters.add(counter)
    assert launched == entries
    assert counters == set(_kernels.LAUNCHES)

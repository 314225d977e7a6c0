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

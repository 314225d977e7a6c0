"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one. This file
imports no JAX, so the card's machine runs it without the JAX package's
test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from ethzasl_brisk_tpu_torch import BriskFeature
from ethzasl_brisk_tpu_torch.core.pattern import brisk_v2_pattern
from ethzasl_brisk_tpu_torch.describe.extractor import _stack_frames, scale_index
from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity, smoothed_intensity_cuda
from ethzasl_brisk_tpu_torch.frames import bench_frames
from ethzasl_brisk_tpu_torch.kernels.harris import (
    harris_score_i32,
    harris_score_i32_cuda,
    harris_score_mask_cuda,
    harris_score_mask_i32,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape", [(2, 480, 640), (3, 320, 426), (2, 240, 320), (2, 160, 213), (1, 37, 70), (1, 4, 5)]
)
def test_harris_cuda_matches_plain(cuda, shape):
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    got = harris_score_i32_cuda(imgs)
    torch.cuda.synchronize()
    assert torch.equal(got, harris_score_i32(imgs))


@pytest.mark.parametrize("thr", [0, 20, 300])
@pytest.mark.parametrize(
    "shape", [(2, 480, 640), (3, 320, 426), (2, 240, 320), (2, 160, 213), (1, 37, 70), (1, 4, 5)]
)
def test_harris_mask_cuda_matches_plain(cuda, shape, thr):
    """Kernel K3 on smoothed noise (so the mask is not empty), scores and
    mask bit for bit; the mask's bytes are only 0 and 1."""
    imgs = torch.from_numpy(bench_frames(shape[0], shape[1], shape[2], seed=3)).to(cuda)
    got_sc, got_mask = harris_score_mask_cuda(imgs, thr)
    torch.cuda.synchronize()
    ref_sc, ref_mask = harris_score_mask_i32(imgs, thr)
    assert torch.equal(got_sc, ref_sc)
    assert torch.equal(got_mask, ref_mask)
    assert int(got_mask.view(torch.uint8).max()) <= 1
    if shape[1] >= 37:
        assert int(got_mask.sum()) > 0


@pytest.mark.parametrize("pattern_scale", [1.0, 0.3])
def test_sampler_cuda_matches_plain(cuda, pattern_scale):
    """Random keypoints, including ones whose pattern leaves the frame
    (clipped taps) and, at pattern_scale 0.3, small-sigma points."""
    rng = np.random.default_rng(1)
    b, h, w, k = 3, 120, 160, 200
    imgs = torch.from_numpy(bench_frames(b, h, w)).to(cuda)
    host = brisk_v2_pattern(pattern_scale)
    sizes = torch.from_numpy(rng.choice([12.0, 18.0, 24.0, 36.0, 54.0], b * k).astype(np.float32))
    sidx = scale_index(sizes).numpy()
    rot = rng.integers(0, 1024, b * k)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    args = (
        _stack_frames(imgs),
        t(rng.uniform(-5, w + 5, b * k).astype(np.float32)),
        t(rng.uniform(-5, h + 5, b * k).astype(np.float32)),
        t(host.lut_x[sidx, rot]), t(host.lut_y[sidx, rot]), t(host.lut_sigma[sidx]),
        t(host.lut_scaling[sidx]), t(host.lut_scaling2[sidx]),
        t(np.repeat(np.arange(b, dtype=np.int32) * (h + 1), k)), h,
    )
    got = smoothed_intensity_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, smoothed_intensity(*args))


STEP_CONFIG = dict(
    octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
    max_candidates=(704, 256, 192, 96), max_keypoints=128,
    refine_capacity=(64, 32, 24, 16), describe_capacity=48,
)


def test_step_launches_both_kernels(cuda):
    from ethzasl_brisk_tpu_torch import FramePipeline, _kernels

    feature = BriskFeature(**STEP_CONFIG).to(cuda)
    frames = torch.from_numpy(bench_frames(3, 120, 160))
    _kernels.reset_launches()
    got = FramePipeline(feature).step(frames.to(cuda))
    assert _kernels.LAUNCHES["harris_score_i32"] == 4
    assert _kernels.LAUNCHES["harris_score_mask"] == 0
    assert _kernels.LAUNCHES["smoothed_intensity"] == 2
    ref = FramePipeline(BriskFeature(**STEP_CONFIG)).step(frames)
    assert torch.equal(got[0].valid.cpu(), ref[0].valid)
    assert torch.equal(got[0].response.cpu(), ref[0].response)


def test_fused_step_launches_k3_and_equals_default(cuda):
    """fused_mask=True: K3 once per layer, K1 never, K2 twice; every output
    bit-equal to the default step on the card."""
    from ethzasl_brisk_tpu_torch import FramePipeline, _kernels

    frames = torch.from_numpy(bench_frames(3, 120, 160)).to(cuda)
    default = FramePipeline(BriskFeature(**STEP_CONFIG).to(cuda)).step(frames)
    _kernels.reset_launches()
    fused = FramePipeline(BriskFeature(**STEP_CONFIG, fused_mask=True).to(cuda)).step(frames)
    assert _kernels.LAUNCHES["harris_score_mask"] == 4
    assert _kernels.LAUNCHES["harris_score_i32"] == 0
    assert _kernels.LAUNCHES["smoothed_intensity"] == 2
    for a, b in zip(default[0].fields(), fused[0].fields()):
        assert torch.equal(a, b)
    for a, b in zip(default[1:], fused[1:]):
        assert torch.equal(a, b)

"""Port parity: pyramid, Harris (kernel K1's plain version), NMS, integral.

The torch port (ethzasl_brisk_tpu_torch) against the JAX package on the
same numpy inputs, bit for bit; the Pallas Harris kernel runs in
interpret mode as tests/test_pallas.py runs it. The CUDA kernel itself is
held against this plain version in tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.detect.scale_space import build_pyramid as jax_pyramid  # noqa: E402
from ethzasl_brisk_tpu.kernels.harris import harris_score_i32 as jax_harris  # noqa: E402
from ethzasl_brisk_tpu.kernels.integral import integral_image_i32 as jax_integral  # noqa: E402
from ethzasl_brisk_tpu.kernels.nms import maxima2d_mask as jax_nms  # noqa: E402
from ethzasl_brisk_tpu.kernels.pallas_harris import (  # noqa: E402
    harris_score_i32_batch_pallas,
)
from ethzasl_brisk_tpu_torch.detect.scale_space import build_pyramid  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import downsample  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels.harris import (  # noqa: E402
    harris_score_i32,
    harris_score_i32_cuda,
    harris_score_i32_fused,
)
from ethzasl_brisk_tpu_torch.kernels.integral import integral_image_i32  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels.nms import maxima2d_mask  # noqa: E402

from . import np_reference  # noqa: E402


@pytest.fixture(scope="module")
def frames():
    """The inputs of tests/test_pallas.py: 3 smoothed-noise 120x200 frames."""
    from scipy import ndimage

    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (3, 120, 200)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((1, 5, 5)) / 25.0, mode="nearest")
    return np.clip(sm, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("width", [200, 190])
def test_harris_plain_matches_jax_and_pallas(frames, width):
    crop = np.ascontiguousarray(frames[:, :, :width])
    got = harris_score_i32(torch.from_numpy(crop)).numpy()
    ref = np.asarray(jax.vmap(jax_harris)(jnp.asarray(crop)))
    np.testing.assert_array_equal(got, ref)
    pallas = np.asarray(harris_score_i32_batch_pallas(jnp.asarray(crop), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert np.count_nonzero(got) > 0.5 * got.size


def test_harris_plain_matches_scalar_reference(frames):
    crop = np.ascontiguousarray(frames[0, :40, :53])
    got = harris_score_i32(torch.from_numpy(crop)).numpy()
    np.testing.assert_array_equal(got, np_reference.harris_scores(crop))


def test_harris_fused_takes_plain_on_cpu(frames):
    t = torch.from_numpy(frames)
    np.testing.assert_array_equal(
        harris_score_i32_fused(t).numpy(), harris_score_i32(t).numpy()
    )
    with pytest.raises(ValueError, match="CUDA"):
        harris_score_i32_cuda(t)


def test_pyramid_matches_jax_and_scalar_reference(frames):
    got = build_pyramid(torch.from_numpy(frames), 4)
    assert [tuple(g.shape[1:]) for g in got] == [(120, 200), (80, 132), (60, 100), (40, 66)]
    for b in range(frames.shape[0]):
        ref = jax_pyramid(jnp.asarray(frames[b]), 4)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))
    small = frames[0, :30, :45]
    t = torch.from_numpy(np.ascontiguousarray(small))
    np.testing.assert_array_equal(
        downsample.halfsample8(t).numpy(), np_reference.halfsample(small)
    )
    np.testing.assert_array_equal(
        downsample.twothirdsample8(t).numpy(), np_reference.twothirdsample(small)
    )


@pytest.mark.parametrize("thr", [20, 300])
def test_nms_and_integral_match_jax(frames, thr):
    sc = harris_score_i32(torch.from_numpy(frames))
    got = maxima2d_mask(sc, thr).numpy()
    ref = np.asarray(jax.vmap(lambda s: jax_nms(s, thr))(jnp.asarray(sc.numpy())))
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 0
    np.testing.assert_array_equal(
        integral_image_i32(torch.from_numpy(frames)).numpy(),
        np.asarray(jax.vmap(jax_integral)(jnp.asarray(frames))),
    )



def _separable_harris(img: torch.Tensor) -> torch.Tensor:
    """Kernel K1's order of the integer passes (csrc/harris.cu) in torch:
    the column difference and [3, 10, 3] column sums, their vertical
    [3, 10, 3] and difference (dx, dy x8), the products, the horizontal then
    vertical [1, 2, 1] sums with one ``>> 4``, the score; 0 off [2, n-3]."""
    from ethzasl_brisk_tpu_torch.kernels.harris import _border_mask, _shift

    h, w = img.shape[-2:]
    p = img.to(torch.int32)
    left, right = _shift(p, 0, -1), _shift(p, 0, 1)
    hd = left - right
    hs = 3 * (left + right) + 10 * p
    dx = 24 * (_shift(hd, -1, 0) + _shift(hd, 1, 0)) + 80 * hd
    dy = 8 * (_shift(hs, -1, 0) - _shift(hs, 1, 0))

    def smooth(v):
        hsum = _shift(v, 0, -1) + 2 * v + _shift(v, 0, 1)
        return (_shift(hsum, -1, 0) + 2 * hsum + _shift(hsum, 1, 0)) >> 4

    sxx, syy, sxy = smooth((dx * dx) >> 16), smooth((dy * dy) >> 16), smooth((dx * dy) >> 16)
    th = (sxx + syy) >> 1
    score = sxx * syy - sxy * sxy - ((th * th) >> 2)
    return torch.where(_border_mask(h, w, 2, img.device), score,
                       torch.zeros((), dtype=torch.int32))


def _extreme_frames(h: int, w: int) -> np.ndarray:
    """0/255 frames whose gradients reach |dx|, |dy| = 8*16*255: a vertical
    and a horizontal step, a 2x2 checkerboard and binary noise."""
    yy, xx = np.mgrid[:h, :w]
    pats = [xx >= w // 2, yy >= h // 2, ((yy // 2) + (xx // 2)) % 2 == 1,
            np.random.default_rng(5).random((h, w)) < 0.5]
    return np.stack([255 * p.astype(np.uint8) for p in pats])


@pytest.mark.parametrize("case", ["layers", "37x70", "4x5", "extreme"])
def test_harris_separable_order_matches_jax(frames, case):
    """K1's separable integer order equals the JAX function bit for bit:
    on the four pyramid layers of a frame, odd shapes, and 0/255 frames
    at the int32 range limits."""
    if case == "layers":
        imgs = [g.numpy() for g in build_pyramid(torch.from_numpy(frames), 4)]
    elif case == "extreme":
        imgs = [_extreme_frames(40, 66), _extreme_frames(37, 70)]
    else:
        h, w = map(int, case.split("x"))
        imgs = [np.random.default_rng(h).integers(0, 256, (2, h, w), dtype=np.uint8)]
    for im in imgs:
        got = _separable_harris(torch.from_numpy(np.ascontiguousarray(im))).numpy()
        ref = np.asarray(jax.vmap(jax_harris)(jnp.asarray(im)))
        np.testing.assert_array_equal(got, ref)
        if case == "extreme":
            # The steps reach |dx| = 32640 (dx*dx near 2^30) and scores
            # past 2^24 of either sign.
            assert got.max() > 2**24 and got.min() < -2**23
            np.testing.assert_array_equal(got, harris_score_i32(torch.from_numpy(im)).numpy())


def test_harris_layers_takes_plain_on_cpu(frames):
    """``harris_score_i32_layers`` (one K1 launch for the pyramid on the
    card) is the per-layer plain version on CPU tensors."""
    from ethzasl_brisk_tpu_torch.kernels.harris import (
        harris_score_i32_layers,
        harris_score_i32_layers_cuda,
    )

    pyr = build_pyramid(torch.from_numpy(frames), 4)
    got = harris_score_i32_layers(pyr)
    assert len(got) == 4
    for g, layer in zip(got, pyr):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), harris_score_i32(layer).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        harris_score_i32_layers_cuda(pyr)

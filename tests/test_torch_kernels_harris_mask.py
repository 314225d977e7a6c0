"""Port parity: kernel K3's plain version (Harris scores + 2-D maxima mask)
and the ``fused_mask`` detector setting.

The plain version is held against the JAX package's Pallas kernel
``harris_score_mask_batch_pallas`` in interpret mode, as
tests/test_pallas.py runs it, bit for bit (scores and mask). The CUDA
kernel itself is held against this plain version in tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.kernels.pallas_harris import (  # noqa: E402
    harris_score_mask_batch_pallas,
)
from ethzasl_brisk_tpu_torch import BriskFeature  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import scale_space  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels.harris import (  # noqa: E402
    harris_score_mask_cuda,
    harris_score_mask_fused,
    harris_score_mask_i32,
)


@pytest.fixture(scope="module")
def frames():
    """The inputs of tests/test_pallas.py: 3 smoothed-noise 120x200 frames."""
    from scipy import ndimage

    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (3, 120, 200)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((1, 5, 5)) / 25.0, mode="nearest")
    return np.clip(sm, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("width", [200, 190])
@pytest.mark.parametrize("thr", [20, 300])
def test_harris_mask_plain_matches_pallas(frames, width, thr):
    crop = np.ascontiguousarray(frames[:, :, :width])
    sc, mask = harris_score_mask_i32(torch.from_numpy(crop), thr)
    jsc, jmask = harris_score_mask_batch_pallas(jnp.asarray(crop), thr=thr, interpret=True)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.dtype == torch.bool and int(mask.sum()) > 0


def test_harris_mask_fused_takes_plain_on_cpu(frames):
    t = torch.from_numpy(frames)
    got = harris_score_mask_fused(t, 20)
    ref = harris_score_mask_i32(t, 20)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="CUDA"):
        harris_score_mask_cuda(t, 20)


@pytest.mark.parametrize("octaves,thr", [(2, 20.0), (2, 300.7), (0, 20.0)])
def test_layer_score_masks_fused_equals_unfused(frames, octaves, thr):
    """The fused_mask setting changes how the 2-D masks are made, never
    what they are; the threshold truncates to int either way."""
    cfg = dict(octaves=octaves, uniformity_radius=30.0, absolute_threshold=thr)
    pyr = scale_space.build_pyramid(torch.from_numpy(frames), max(2 * octaves, 1))
    stages = []
    sc_f, mk_f = scale_space.layer_score_masks(
        pyr, BriskFeature(**cfg, fused_mask=True, device="cpu").config, mark=stages.append
    )
    sc_u, mk_u = scale_space.layer_score_masks(pyr, BriskFeature(**cfg, device="cpu").config)
    assert stages == ["harris", "masks"]
    for a, b in zip(sc_f, sc_u):
        assert torch.equal(a, b)
    for a, b in zip(mk_f, mk_u):
        assert torch.equal(a, b)
    assert int(mk_f[0].sum()) > 0

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
    _border_mask,
    _shift,
    harris_score_mask_cuda,
    harris_score_mask_fused,
    harris_score_mask_i32,
    harris_score_mask_layers,
    harris_score_mask_layers_cuda,
)

from .test_torch_kernels_harris import _extreme_frames, _separable_harris  # noqa: E402


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


def _separable_mask(img: torch.Tensor, thr: int):
    """Kernel K3's order (csrc/harris.cu, the masked body) in torch: K1's
    separable scores, 0 off [2, n-3] (0 also off the image, as the ring
    reads them); the horizontal max of 3; the max of two rows of those,
    then with the third; the threshold, the compare and border 2."""
    sc = _separable_harris(img)
    hx = torch.maximum(torch.maximum(_shift(sc, 0, -1), sc), _shift(sc, 0, 1))
    pair = torch.maximum(_shift(hx, -1, 0), hx)
    vmax = torch.maximum(pair, _shift(hx, 1, 0))
    h, w = sc.shape[-2:]
    return sc, _border_mask(h, w, 2, img.device) & (sc >= thr) & (vmax <= sc)


@pytest.mark.parametrize("thr", [0, 20, 300])
@pytest.mark.parametrize("case", ["layers", "37x70", "5x5", "4x5", "extreme"])
def test_harris_mask_separable_order_matches_pallas(frames, case, thr):
    """K3's separable order equals the JAX Pallas kernel (interpret mode)
    bit for bit, scores and mask: on the four pyramid layers of the 120x200
    frames, odd shapes, and 0/255 frames whose score plateaus tie the
    ``<=`` of the maximum."""
    if case == "layers":
        imgs = [g.numpy() for g in scale_space.build_pyramid(torch.from_numpy(frames), 4)]
    elif case == "extreme":
        imgs = [_extreme_frames(40, 66), _extreme_frames(37, 70)]
    else:
        h, w = map(int, case.split("x"))
        imgs = [np.random.default_rng(h * w).integers(0, 256, (2, h, w), dtype=np.uint8)]
    ties = 0
    for im in imgs:
        im = np.ascontiguousarray(im)
        sc, mask = _separable_mask(torch.from_numpy(im), thr)
        jsc, jmask = harris_score_mask_batch_pallas(jnp.asarray(im), thr=thr, interpret=True)
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        # Kept maxima with an equal neighbour: the tie the ``<=`` keeps.
        p = torch.nn.functional.pad(sc, (1, 1, 1, 1))
        h, w = sc.shape[-2:]
        equal = torch.zeros_like(mask)
        for dy in range(3):
            for dx in range(3):
                if (dy, dx) != (1, 1):
                    equal |= p[..., dy : dy + h, dx : dx + w] == sc
        ties += int((mask & equal).sum())
    if case == "extreme":
        assert ties > 0
    if case in ("layers", "extreme", "37x70") and thr <= 20:
        assert int(mask.sum()) > 0


def test_harris_mask_layers_takes_plain_on_cpu(frames):
    """``harris_score_mask_layers`` (one K3 launch for the pyramid on the
    card) is the per-layer plain version on CPU tensors."""
    pyr = scale_space.build_pyramid(torch.from_numpy(frames), 4)
    got = harris_score_mask_layers(pyr, 20)
    assert len(got) == 4
    for (sc, mask), layer in zip(got, pyr):
        ref_sc, ref_mask = harris_score_mask_i32(layer, 20)
        assert sc.dtype == torch.int32 and mask.dtype == torch.bool
        assert torch.equal(sc, ref_sc) and torch.equal(mask, ref_mask)
    with pytest.raises(ValueError, match="CUDA"):
        harris_score_mask_layers_cuda(pyr, 20)

"""Port parity: the 16-bit pipeline against the JAX package.

The 16-bit samplers (``halfsample16``, ``twothirdsample16``), the float
integrals, the float Harris score, the float warps and 3 x 3 maximum, the
float branch of ``layer_score_masks`` and ``_layer_candidates``, the float
sampler ``smoothed_intensity_f32``, ``detect_keypoints`` and
``BriskFeature.detect_and_compute`` on uint16 single images, and the
``ValueError`` on uint16 batches.

Inputs: the smoothed-noise texture of tests/test_16bit.py (``default_rng(3)``,
a Gaussian of sigma 1.5) stretched to all 16 bits, at 120 x 160 (one JAX
eager run of the layers serves the function tests and end to end), and
random 16-bit images at 96 x 128 and other shapes (samplers, integrals). Float chains are compared against JAX run
eagerly (``jax.disable_jit()`` or ``eager_exact=True``): jitted XLA:CPU may
FMA-contract them.

Tolerances:
- integers (pyramid, masks, candidates in order, accept masks, size,
  octave, valid) bit for bit;
- Harris maps, warped maps, float integrals and smoothed intensities bit
  for bit. The port's float integral performs the float32 adds of the
  blocked scan XLA:CPU compiles ``jnp.cumsum`` to, so it is exact against
  JAX, well inside the 4e-7-of-the-largest-entry bar; with equal integrals
  the sampler's float chain leaves the smoothed intensities no room, so
  the bound derived for them is 0;
- x, y within 1 ULP (both equal here);
- angle bit for bit on valid slots (the port takes JAX's float32 ``atan2``
  and, on the 16-bit path, the chain's steps op by op,
  ``describe/orientation.py``), and with it theta; descriptors bit for bit.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy import ndimage  # noqa: E402

from ethzasl_brisk_tpu.describe import extractor as jex  # noqa: E402
from ethzasl_brisk_tpu.detect import scale_space as jss  # noqa: E402
from ethzasl_brisk_tpu.kernels import downsample as jds  # noqa: E402
from ethzasl_brisk_tpu.kernels import harris as jh  # noqa: E402
from ethzasl_brisk_tpu.kernels import integral as jint  # noqa: E402
from ethzasl_brisk_tpu.pipeline import BriskFeature as JaxBriskFeature  # noqa: E402
from ethzasl_brisk_tpu_torch import BriskFeature, FramePipeline, HarrisFeatureDetector  # noqa: E402
from ethzasl_brisk_tpu_torch.describe import extractor as tex  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import scale_space as tss  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import downsample as tds  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import harris as th  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import integral as tint  # noqa: E402

N_ROT = 1024
# Float Harris on all 16 bits scales the 8-bit scores by ~257^4.
CONFIG = dict(octaves=2, uniformity_radius=10.0, absolute_threshold=20.0 * 257.0**4,
              max_candidates=1024, max_keypoints=512)


def texture(shape) -> np.ndarray:
    rng = np.random.default_rng(3)
    t = ndimage.gaussian_filter(rng.uniform(0, 255, shape), 1.5)
    return ((t - t.min()) / np.ptp(t) * 65535).astype(np.uint16)


def _bits_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape)
    if got.dtype.kind == "f":
        got, ref = got.view(np.int32 if got.itemsize == 4 else np.int64), ref.view(
            np.int32 if ref.itemsize == 4 else np.int64)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def small():
    return texture((120, 160))


@pytest.fixture(scope="module")
def jax_layers(small):
    """JAX's 4-layer uint16 pyramid of the texture, and its float scores
    and candidate masks, run eagerly."""
    jcfg = JaxBriskFeature(**CONFIG).config
    with jax.disable_jit():
        scores, masks = jss.layer_score_masks(jnp.asarray(small), jcfg)
    return jss.build_pyramid(jnp.asarray(small), 4), scores, masks


@pytest.mark.parametrize("name", ["halfsample16", "twothirdsample16"])
@pytest.mark.parametrize("shape", [(96, 128), (121, 161)])
def test_downsample16_matches_jax(name, shape):
    img = np.random.default_rng(7).integers(0, 65536, shape).astype(np.uint16)
    ref = np.asarray(getattr(jds, name)(jnp.asarray(img)))
    got = getattr(tds, name)(torch.from_numpy(img))
    assert got.dtype == torch.uint16
    _bits_equal(got.numpy(), ref)
    # A leading batch axis gives each frame's result.
    batch = getattr(tds, name)(torch.from_numpy(np.stack([img, img[::-1].copy()])))
    _bits_equal(batch[0].numpy(), ref)


def test_build_pyramid_dispatches_on_dtype(small, jax_layers):
    got = tss.build_pyramid(torch.from_numpy(small)[None], 4)
    for g, r in zip(got, jax_layers[0]):
        assert g.dtype == torch.uint16
        _bits_equal(g[0].numpy(), np.asarray(r))


@pytest.mark.parametrize("name", ["integral_image_16_f32", "integral_image_f32"])
@pytest.mark.parametrize("shape", [(96, 128), (120, 160), (17, 300)])
def test_float_integral_matches_jax(name, shape):
    img = np.random.default_rng(1).integers(0, 65536, shape).astype(np.uint16)
    ref = np.asarray(getattr(jint, name)(jnp.asarray(img)))
    got = getattr(tint, name)(torch.from_numpy(img)).numpy()
    # The contract's bar, then the bits.
    assert np.abs(got - ref).max() <= 4e-7 * np.abs(ref).max()
    _bits_equal(got, ref)


def test_harris_f32_matches_jax_eager(jax_layers):
    pyramid, scores, _ = jax_layers
    with jax.disable_jit():
        np.testing.assert_array_equal(np.asarray(jh.harris_score_f32(pyramid[1])),
                                      np.asarray(scores[1]))
    for layer, ref in zip(pyramid, scores):
        got = th.harris_score_f32(torch.from_numpy(np.array(layer))[None])[0]
        _bits_equal(got.numpy(), ref)
        assert np.abs(np.asarray(ref)).max() > 0


def test_warps_and_max3x3_match_jax_eager(jax_layers):
    scores = jax_layers[1]
    geoms = [jss.layer_geometry(i) for i in range(4)]
    for i in range(4):
        h, w = scores[i].shape
        for j, affine in ((i + 1, geoms[i].above_map), (i - 1, geoms[i].below_map)):
            if not 0 <= j < 4:
                continue
            with jax.disable_jit():
                ref = jss.warp_scores_f32(scores[j], affine, (h, w))
                ref_max = jss._max3x3_f32(ref)
            got = tss.warp_scores_f32(torch.from_numpy(np.array(scores[j]))[None], affine,
                                      (h, w))[0]
            _bits_equal(got.numpy(), ref)
            _bits_equal(tss._max3x3_zero_fill(got).numpy(), ref_max)


@pytest.mark.parametrize("fused_mask", [False, True], ids=["plain", "fused_mask_ignored"])
def test_layer_masks_and_candidates_match_jax(small, jax_layers, fused_mask):
    """JAX ignores ``fused_mask`` on uint16 (its masks are the same)."""
    _, jscores, jmasks = jax_layers
    jcfg = JaxBriskFeature(**CONFIG).config
    tcfg = BriskFeature(**CONFIG, fused_mask=fused_mask, device="cpu").config
    scores, masks = tss.layer_score_masks(tss.build_pyramid(torch.from_numpy(small)[None], 4), tcfg)
    for i in range(4):
        _bits_equal(scores[i][0].numpy(), jscores[i])
        np.testing.assert_array_equal(masks[i][0].numpy(), np.asarray(jmasks[i]))
        jc = jss._layer_candidates(jscores[i], jmasks[i], jcfg, jcfg.layer_cap(i))
        tc = tss._layer_candidates(scores[i], masks[i], tcfg.layer_cap(i))
        for a, b in zip(tc, jc[:4]):
            _bits_equal(a[0].numpy(), np.asarray(b).astype(a.numpy().dtype))
        ja = jss._layer_accept(jc, jscores[i].shape, jcfg)
        np.testing.assert_array_equal(tss._layer_accept(tc, tcfg)[0].numpy(), np.asarray(ja))
        assert int(masks[i].sum()) > 0


def test_smoothed_intensity_f32_matches_jax_eager(small):
    """Same image, integral and keypoints on both sides: the float sampler's
    chain, box and small-sigma branches, rotated and unrotated patterns."""
    rng = np.random.default_rng(11)
    jpat = JaxBriskFeature().extractor.pattern
    tpat = tex.DevicePattern.from_host(tex.brisk_v2_pattern())
    k = 96
    h, w = small.shape
    key_x = rng.uniform(-4, w + 4, k).astype(np.float32)
    key_y = rng.uniform(-4, h + 4, k).astype(np.float32)
    scale_idx = rng.integers(0, 64, k)
    theta = rng.integers(0, N_ROT, k)
    imgf = small.astype(np.float32) / np.float32(65536.0)
    integral = np.asarray(jint.integral_image_16_f32(jnp.asarray(small)))
    sigma = np.asarray(jpat.lut_sigma)[scale_idx]
    # Halve some sigmas below 0.5 so the small-sigma branch runs too.
    sigma = np.where(rng.random(sigma.shape) < 0.2, sigma * np.float32(0.3), sigma)
    for rot in (np.zeros(k, int), theta):
        px = np.asarray(jpat.lut_x)[scale_idx, rot]
        py = np.asarray(jpat.lut_y)[scale_idx, rot]
        np.testing.assert_array_equal(px, tpat.lut_x.numpy()[scale_idx, rot])
        with jax.disable_jit():
            ref = jex.smoothed_intensity_f32(
                jnp.asarray(imgf), jnp.asarray(integral), jnp.asarray(key_x),
                jnp.asarray(key_y), jnp.asarray(px), jnp.asarray(py), jnp.asarray(sigma),
                jnp.asarray(np.float32(4.0) * sigma * sigma),
            )
        t = {n: torch.from_numpy(v) for n, v in
             dict(x=key_x, y=key_y, px=px, py=py, s=sigma).items()}
        got = tex.smoothed_intensity_f32(
            torch.from_numpy(imgf), tint.integral_image_16_f32(torch.from_numpy(small)),
            t["x"], t["y"], t["px"], t["py"], t["s"], 4.0 * t["s"] * t["s"],
        )
        _bits_equal(got.numpy(), ref)
        assert int(np.asarray(ref).max()) > 256


@pytest.fixture(scope="module")
def end_to_end():
    """Port and JAX detect_and_compute on the texture, JAX run eagerly
    (``jax.disable_jit()``)."""
    img = texture((120, 160))
    jf = JaxBriskFeature(**CONFIG, eager_exact=True)
    with jax.disable_jit():
        jdet, jdiag = jf.detect_with_diagnostics(jnp.asarray(img))
        jkp, jdesc = jf.compute(jnp.asarray(img), jdet)
    feature = BriskFeature(**CONFIG, device="cpu")
    port_det = feature.detect_with_diagnostics(torch.from_numpy(img))
    port = feature.detect_and_compute(torch.from_numpy(img))
    return img, port_det, port, (jdet, jdiag), (jkp, jdesc)


def _assert_ulp(a, b, ulps=1):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    gap = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    assert gap.max(initial=0) <= ulps, gap.max()


def test_detect_keypoints_u16_matches_jax(end_to_end):
    _, (kps, diag), _, (jkps, jdiag), _ = end_to_end
    assert kps.x.shape == jkps.x.shape
    np.testing.assert_array_equal(kps.valid.numpy(), np.asarray(jkps.valid))
    for name in ("size", "response", "octave", "angle"):
        _bits_equal(getattr(kps, name).numpy(), getattr(jkps, name))
    for name in ("x", "y"):
        _assert_ulp(getattr(kps, name).numpy(), getattr(jkps, name))
    for name in jdiag._fields:
        np.testing.assert_array_equal(getattr(diag, name).numpy(), np.asarray(getattr(jdiag, name)),
                                      err_msg=name)
    assert bool(diag.ok) and int(kps.valid.sum()) > 50
    # The layer-batched detect_keypoints gives the facade's keypoints.
    raw = tss.detect_keypoints(torch.from_numpy(end_to_end[0])[None], BriskFeature(
        **CONFIG, device="cpu").config)
    assert int(raw.valid.sum()) == int(kps.valid.sum())


def test_detect_and_compute_u16_matches_jax(end_to_end):
    _, _, (kps, desc), _, (jkp, jdesc) = end_to_end
    valid = np.asarray(jkp.valid)
    np.testing.assert_array_equal(kps.valid.numpy(), valid)
    for name in ("size", "response", "octave"):
        _bits_equal(getattr(kps, name).numpy(), getattr(jkp, name))
    for name in ("x", "y"):
        _assert_ulp(getattr(kps, name).numpy(), getattr(jkp, name))
    got_a, ref_a = kps.angle.numpy(), np.asarray(jkp.angle)
    np.testing.assert_array_equal(got_a[valid].view(np.int32), ref_a[valid].view(np.int32))
    np.testing.assert_array_equal(desc.numpy(), np.asarray(jdesc).view(np.int32))
    assert tuple(desc.shape) == (kps.capacity, 12) and valid.sum() > 30


def test_harris_detector_u16_matches_facade(end_to_end):
    img = end_to_end[0]
    got = HarrisFeatureDetector(threshold=CONFIG["absolute_threshold"], uniformity_radius=10.0,
                                max_candidates=1024, device="cpu").detect(torch.from_numpy(img))
    ref = BriskFeature(**dict(CONFIG, octaves=0, max_keypoints=1024), device="cpu").detect(
        torch.from_numpy(img))
    for a, b in zip(got.fields(), ref.fields()):
        assert torch.equal(a, b)
    assert int(got.valid.sum()) > 50


@pytest.mark.parametrize("call", ["detect", "detect_with_diagnostics", "compute",
                                  "detect_and_compute", "describe", "harris", "frame_pipeline"])
def test_u16_batch_raises(call):
    frames = torch.from_numpy(np.stack([texture((48, 64))] * 2))
    feature = BriskFeature(**CONFIG, device="cpu")
    kps = feature.detect(frames.to(torch.uint8))
    calls = {
        "detect": lambda: feature.detect(frames),
        "detect_with_diagnostics": lambda: feature.detect_with_diagnostics(frames),
        "compute": lambda: feature.compute(frames, kps),
        "detect_and_compute": lambda: feature.detect_and_compute(frames),
        "describe": lambda: feature.describe(frames, kps),
        "harris": lambda: HarrisFeatureDetector(device="cpu").detect(frames),
        "frame_pipeline": lambda: FramePipeline(feature, device="cpu").step(frames),
    }
    with pytest.raises(ValueError, match="uint16 batch"):
        calls[call]()

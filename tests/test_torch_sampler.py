"""Port parity: the smoothed-intensity sampler (kernel K2's plain version)
and the describe stage.

Inputs of tests/test_fast_sampler.py (B=2, 160x200 stacked frames, K=24
per frame). The port's sampler reads its taps from the integral with
frame clipping; it must equal smoothed_intensity_u8 and the Pallas
sampler (interpret mode) bit for bit on every describable keypoint, i.e.
one whose pattern lies inside the frame.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.core.pattern import brisk_v2_pattern as jax_v2_pattern  # noqa: E402
from ethzasl_brisk_tpu.describe import extractor as jext  # noqa: E402
from ethzasl_brisk_tpu.describe.pallas_sampler import (  # noqa: E402
    smoothed_intensity_patch_pallas,
)
from ethzasl_brisk_tpu_torch.core.keypoints import KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch.core.pattern import brisk_v2_pattern  # noqa: E402
from ethzasl_brisk_tpu_torch.describe.extractor import (  # noqa: E402
    DevicePattern,
    _stack_frames,
    extract_descriptors_compact,
    scale_index,
)
from ethzasl_brisk_tpu_torch.describe.sampler import (  # noqa: E402
    smoothed_intensity,
    smoothed_intensity_cuda,
    smoothed_intensity_fused,
)

B, H, W, K = 2, 160, 200, 24


def _inputs(pattern_scale=1.0):
    from scipy import ndimage

    rng = np.random.default_rng(9)
    base = rng.integers(0, 256, (B, H, W)).astype(np.float32)
    imgs = np.clip(
        ndimage.convolve(base, np.ones((1, 5, 5)) / 25.0, mode="nearest"), 0, 255
    ).astype(np.uint8)
    kx = rng.uniform(30, 170, (B, K)).astype(np.float32).reshape(-1)
    ky = rng.uniform(30, 130, (B, K)).astype(np.float32).reshape(-1)
    sizes = rng.choice([12.0, 18.0, 24.0, 40.0], (B * K,)).astype(np.float32)
    row_base = np.repeat(np.arange(B, dtype=np.int32) * (H + 1), K)
    host = jax_v2_pattern(pattern_scale)
    sidx = np.asarray(jext.scale_index(jnp.asarray(sizes), True))
    tab = dict(
        pat_x=host.lut_x[sidx, 0], pat_y=host.lut_y[sidx, 0],
        pat_sigma=host.lut_sigma[sidx], pat_scaling=host.lut_scaling[sidx],
        pat_scaling2=host.lut_scaling2[sidx],
    )
    border = host.size_list[sidx].astype(np.float32)
    describable = (kx >= border) & (kx < W - border) & (ky >= border) & (ky < H - border)
    return imgs, kx, ky, sizes, row_base, tab, describable


def _port_values(imgs, kx, ky, row_base, tab, fn=smoothed_intensity):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tab.items()}
    return fn(
        _stack_frames(torch.from_numpy(imgs)), torch.from_numpy(kx), torch.from_numpy(ky),
        t["pat_x"], t["pat_y"], t["pat_sigma"], t["pat_scaling"], t["pat_scaling2"],
        torch.from_numpy(row_base), H,
    ).numpy()


def _jax_args(imgs, kx, ky, tab):
    img_pad, int_flat = jext._stack_frames(jnp.asarray(imgs))
    return (
        img_pad, int_flat, jnp.asarray(kx), jnp.asarray(ky),
        *(jnp.asarray(tab[k]) for k in
          ("pat_x", "pat_y", "pat_sigma", "pat_scaling", "pat_scaling2")),
    )


def test_scale_index_matches_jax():
    sizes = np.array([8.4, 12.0, 16.8, 18.0, 24.0, 33.6, 36.0, 40.0, 200.0], np.float32)
    np.testing.assert_array_equal(
        scale_index(torch.from_numpy(sizes)).numpy(),
        np.asarray(jext.scale_index(jnp.asarray(sizes), True)),
    )


def test_sampler_matches_gather_and_pallas():
    imgs, kx, ky, _, row_base, tab, desc = _inputs()
    assert desc.sum() >= 20  # the comparison is not vacuous
    got = _port_values(imgs, kx, ky, row_base, tab)
    args = _jax_args(imgs, kx, ky, tab)
    u8 = np.asarray(jext.smoothed_intensity_u8(
        *args, row_base=jnp.asarray(row_base), frame_rows=H
    ))
    np.testing.assert_array_equal(got[desc], u8[desc])
    pallas = np.asarray(smoothed_intensity_patch_pallas(
        *args, patch_sizes=((32, 128), (64, 128), (128, 128)),
        row_base=jnp.asarray(row_base), frame_rows=H, interpret=True,
    ))
    np.testing.assert_array_equal(got[desc], pallas[desc])
    np.testing.assert_array_equal(
        _port_values(imgs, kx, ky, row_base, tab, smoothed_intensity_fused), got
    )


def test_sampler_small_sigma_branch():
    """pattern_scale 0.3 puts some sigmas below 0.5: the bilinear branch."""
    imgs, kx, ky, _, row_base, tab, desc = _inputs(pattern_scale=0.3)
    small = tab["pat_sigma"] < 0.5
    assert small[desc].sum() > 50
    got = _port_values(imgs, kx, ky, row_base, tab)
    ref = np.asarray(jext.smoothed_intensity_u8(
        *_jax_args(imgs, kx, ky, tab), row_base=jnp.asarray(row_base), frame_rows=H,
    ))
    np.testing.assert_array_equal(got[desc], ref[desc])


def test_sampler_cuda_rejects_cpu_tensors():
    imgs, kx, ky, _, row_base, tab, _ = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        _port_values(imgs, kx, ky, row_base, tab, smoothed_intensity_cuda)


def test_describe_matches_jax():
    """Compacted describe (orientation + descriptor) against the JAX
    reference-exact gather path, on random keypoints of 3 frames with a
    capacity that drops some describable keypoints."""
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    rng = np.random.default_rng(0)
    b, h, w, k = 3, 120, 160, 40
    imgs = bench_frames(b, h, w)
    f = dict(
        x=rng.uniform(2, w - 2, (b, k)).astype(np.float32),
        y=rng.uniform(2, h - 2, (b, k)).astype(np.float32),
        size=rng.choice([12.0, 18.0, 24.0, 36.0], (b, k)).astype(np.float32),
        angle=np.full((b, k), -1.0, np.float32),
        response=np.zeros((b, k), np.float32),
        octave=np.zeros((b, k), np.int32),
        valid=rng.random((b, k)) < 0.8,
    )
    jkp, jdesc, jn = jext.extract_descriptors_compact(
        jext.DevicePattern.from_host(jax_v2_pattern()), jnp.asarray(imgs),
        JaxKeyPoints(**{n: jnp.asarray(v) for n, v in f.items()}),
        capacity=12, sampler="gather", with_diagnostics=True,
    )
    kp, desc, n = extract_descriptors_compact(
        DevicePattern.from_host(brisk_v2_pattern()), torch.from_numpy(imgs),
        KeyPoints(**{n: torch.from_numpy(v) for n, v in f.items()}),
        capacity=12, with_diagnostics=True,
    )
    valid = np.asarray(jkp.valid)
    assert valid.sum() == 12 and int(n) == int(jn) > 12
    np.testing.assert_array_equal(kp.valid.numpy(), valid)
    for name in ("x", "y", "size", "response", "octave"):
        np.testing.assert_array_equal(getattr(kp, name).numpy(), np.asarray(getattr(jkp, name)))
    # atan2 differs between backends by an ULP: angle within 1e-4 degree.
    np.testing.assert_allclose(kp.angle.numpy()[valid], np.asarray(jkp.angle)[valid],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(desc.numpy(), np.asarray(jdesc).view(np.int32))


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


def _kernel_tap_order(integral, kx, ky, px, py, ps, sc, sc2, row_base, frame_rows):
    """Box-branch values as kernel K2 (csrc/sampler.cu) reads them: 22 taps
    named by their column pairs, (x_left, x_left+1) and (x_right,
    x_right+1) on rows y_top, y_top+1, y_bottom; (d_x, d_x+1) and (c_x,
    c_x+1) on rows cd_y, cd_y+1; x_left+1 and x_right on row y_bottom+1;
    sums wrapped to 32 bits."""
    from ethzasl_brisk_tpu_torch.describe.sampler import _tap_geometry

    g = _tap_geometry(kx, ky, px, py, ps)
    cols = integral.shape[1] - 1
    flat = integral.reshape(-1).to(torch.int64)
    base = row_base.to(torch.int64)[:, None] * (cols + 1)
    big = g["big"]

    def row(r):
        return base + r.clamp(0, frame_rows).to(torch.int64) * (cols + 1)

    def col(c):
        return c.clamp(0, cols).to(torch.int64)

    xl, xr = g["x_left"], g["x_right"]
    d_x, c_x = torch.where(big, xl + 1, xl), torch.where(big, xr + 1, xr)
    cd_y = torch.where(big, g["y_bottom"] - 1, g["y_bottom"])
    l0, l1, r0, r1 = col(xl), col(xl + 1), col(xr), col(xr + 1)
    d0, d1, c0, c1 = col(d_x), col(d_x + 1), col(c_x), col(c_x + 1)
    R0, R1 = row(g["y_top"]), row(g["y_top"] + 1)
    R2, R3 = row(cd_y), row(cd_y + 1)
    R4, R5 = row(g["y_bottom"]), row(g["y_bottom"] + 1)
    t00, t01, t03, t04 = (flat[R0 + c] for c in (l0, l1, r0, r1))
    t10, t11, t13, t14 = (flat[R1 + c] for c in (l0, l1, r0, r1))
    d2, t22, c2, t25 = (flat[R2 + c] for c in (d0, d1, c0, c1))
    d3, t32, c3, t35 = (flat[R3 + c] for c in (d0, d1, c0, c1))
    t40, t41, t43, t44 = (flat[R4 + c] for c in (l0, l1, r0, r1))
    t51, t53 = flat[R5 + l1], flat[R5 + r0]

    def trunc(v):
        return torch.trunc(v).to(torch.int64)

    r_x_1f = xl.to(torch.float32) - g["x_1"] + 0.5
    r_y_1f = g["y_top"].to(torch.float32) - g["y_1"] + 0.5
    r_x1f = g["x1"] - xr.to(torch.float32) + 0.5
    r_y1f = g["y1"] - g["y_bottom"].to(torch.float32) + 0.5
    scf = sc.to(torch.float32)
    corners = (trunc(r_x_1f * r_y_1f * scf) * (t11 - t01 - t10 + t00)
               + trunc(r_x1f * r_y_1f * scf) * (t14 - t04 - t13 + t03)
               + trunc(r_x1f * r_y1f * scf) * (t35 - t25 - c3 + c2)
               + trunc(r_x_1f * r_y1f * scf) * (t32 - t22 - d3 + d2))
    total = (corners + (t13 - t03 + t01 - t11) * trunc(r_y_1f * scf)
             + (t43 - t13 + t11 - t41) * sc.to(torch.int64)
             + (t41 - t11 + t10 - t40) * trunc(r_x_1f * scf)
             + (t44 - t14 + t13 - t43) * trunc(r_x1f * scf)
             + (t53 - t43 + t41 - t51) * trunc(r_y1f * scf))
    total = ((total + 2**31) % 2**32 - 2**31).to(torch.int32)
    return torch.div(total, sc2.clamp(min=1), rounding_mode="floor"), g["small"]


@pytest.mark.parametrize("pattern_scale", [1.0, 0.3])
def test_kernel_tap_order_matches_jax(pattern_scale):
    """K2's reading of the box branch (by column pairs, the corner columns
    that ``big`` picks named c_x and d_x) equals JAX's smoothed intensity on
    describable keypoints and the plain version everywhere, keypoints whose
    pattern leaves the frame (clipped taps) included."""
    imgs, kx, ky, _, row_base, tab, desc = _inputs(pattern_scale)
    rng = np.random.default_rng(2)
    kx = np.concatenate([kx, rng.uniform(-8, W + 8, 40).astype(np.float32)])
    ky = np.concatenate([ky, rng.uniform(-8, H + 8, 40).astype(np.float32)])
    row_base = np.concatenate([row_base, np.repeat(np.arange(B, dtype=np.int32) * (H + 1), 20)])
    tab = {k: np.concatenate([v, v[:40]]) for k, v in tab.items()}
    desc = np.concatenate([desc, np.zeros(40, bool)])
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tab.items()}
    args = (_stack_frames(torch.from_numpy(imgs)), torch.from_numpy(kx), torch.from_numpy(ky),
            t["pat_x"], t["pat_y"], t["pat_sigma"], t["pat_scaling"], t["pat_scaling2"],
            torch.from_numpy(row_base), H)
    got, small = _kernel_tap_order(*args)
    box = ~small.numpy()
    assert box.all() == (pattern_scale == 1.0) and box[~desc].sum() > 1000
    plain = smoothed_intensity(*args).numpy()
    np.testing.assert_array_equal(got.numpy()[box], plain[box])
    u8 = np.asarray(jext.smoothed_intensity_u8(
        *_jax_args(imgs, kx, ky, tab), row_base=jnp.asarray(row_base), frame_rows=H))
    sel = box & desc[:, None]
    assert sel.sum() > 1000
    np.testing.assert_array_equal(got.numpy()[sel], u8[sel])

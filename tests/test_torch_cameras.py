"""Port parity: ``kernels/filters.py`` and ``geometry/cameras.py`` against
the JAX package.

Filters: bit for bit against the JAX functions on uint8, int16 and
float32 images with float, int and float64 kernels (the result types are
JAX's without x64), and ``filter2d`` against ``scipy.ndimage.correlate``
as in ``tests/test_kernels.py:304``.

Cameras: seeded points through ``distort``, ``undistort``,
``distort_jacobian``, ``project``, ``unproject`` and ``project_jacobian``
of a pinhole camera with each distortion model, against the JAX package
in float32. Tolerance: 4 ULP. Measured: radial-tangential ``distort``,
``distort_jacobian`` and ``project`` 0, ``undistort`` 2 and ``unproject`` 1
(the JAX ``fori_loop`` compiles its body, and XLA:CPU contracts it into
fused multiply-adds; run op by op, ``jax.disable_jit()``, it is bit for
bit); equidistant ``distort`` 2, ``undistort`` 3, ``unproject`` 2 (XLA's
and torch's ``arctan``, ``tan`` and ``sqrt`` differ in the last bits).
``project_jacobian`` (forward-mode differentiation in both) within 1e-6
relative to the largest entry. Plus the round trips of
``tests/test_geometry.py:16-64``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu import geometry as jgeo  # noqa: E402
from ethzasl_brisk_tpu.kernels import filters as jfl  # noqa: E402
from ethzasl_brisk_tpu_torch import geometry as tgeo  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import filters as tfl  # noqa: E402

ULP = 4
RNG = np.random.default_rng(7)
MODELS = {
    "none": ((), "NoDistortion"),
    "radtan": ((-0.3, 0.1, 1e-3, -2e-3), "RadialTangentialDistortion"),
    "equidistant": ((-0.01, 0.005, -0.002, 0.001), "EquidistantDistortion"),
}


def _ulp(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def _models(name):
    coef, cls = MODELS[name]
    if name == "none":
        return jgeo.NoDistortion(), tgeo.NoDistortion()
    return getattr(jgeo, cls).create(*coef), getattr(tgeo, cls)(*coef)


def _cameras(name):
    jd, td = _models(name)
    return (jgeo.PinholeCamera.create(450.0, 452.0, 320.0, 240.0, 640, 480, jd),
            tgeo.PinholeCamera(450.0, 452.0, 320.0, 240.0, 640, 480, td))


# ---------------------------------------------------------------------------
# Filters.
# ---------------------------------------------------------------------------
IMAGES = {
    "f32": RNG.normal(size=(15, 17)).astype(np.float32),
    "u8": RNG.integers(0, 256, (12, 14)).astype(np.uint8),
    "i16": RNG.integers(-900, 900, (12, 14)).astype(np.int16),
}
KERNELS = {
    "f32_3x5": RNG.normal(size=(3, 5)).astype(np.float32),
    "i32_box": np.ones((3, 3), np.int32),
    "f64_5x3": RNG.normal(size=(5, 3)),
    "gauss": np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]]),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("image", list(IMAGES))
def test_filter2d_bitwise(image, kernel):
    img, k = IMAGES[image], KERNELS[kernel]
    got = tfl.filter2d(torch.from_numpy(img), k).numpy()
    ref = np.asarray(jfl.filter2d(jnp.asarray(img), k))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_filter2d_matches_scipy():
    from scipy import ndimage

    img = RNG.normal(size=(15, 17)).astype(np.float32)
    k = RNG.normal(size=(3, 5)).astype(np.float32)
    got = tfl.filter2d(torch.from_numpy(img), k).numpy()
    want = ndimage.correlate(img, k, mode="constant")
    want[:1] = 0
    want[-1:] = 0
    want[:, :2] = 0
    want[:, -2:] = 0
    np.testing.assert_allclose(got[1:-1, 2:-2], want[1:-1, 2:-2], rtol=1e-4, atol=1e-4)
    assert (got[0] == 0).all() and (got[:, :2] == 0).all()
    with pytest.raises(ValueError, match="odd"):
        tfl.filter2d(torch.from_numpy(img), np.ones((2, 3)))


@pytest.mark.parametrize("name", ["filter_box_3x3_i16", "filter_gauss_3x3_i16",
                                  "filter_gauss_3x3_f32"])
@pytest.mark.parametrize("image", ["i16", "u8", "f32"])
def test_fixed_filters_bitwise(name, image):
    img = IMAGES[image]
    if image == "i16":
        img = RNG.integers(-3000, 3000, (12, 14)).astype(np.int16)  # the box sum wraps
    got = getattr(tfl, name)(torch.from_numpy(img)).numpy()
    ref = np.asarray(getattr(jfl, name)(jnp.asarray(img)))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# Cameras.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["radtan", "equidistant"])
def test_distortion_against_jax(name):
    jd, td = _models(name)
    pn = RNG.uniform(-0.5, 0.5, (500, 2)).astype(np.float32)
    pd = np.array(jd.distort(jnp.asarray(pn)))
    got_d = td.distort(torch.from_numpy(pn)).numpy()
    assert _ulp(got_d, pd) <= ULP
    assert _ulp(td.undistort(torch.from_numpy(pd)).numpy(), jd.undistort(jnp.asarray(pd))) <= ULP
    if name == "radtan":
        assert _ulp(td.distort_jacobian(torch.from_numpy(pn)).numpy(),
                    jd.distort_jacobian(jnp.asarray(pn))) <= ULP
        with jax.disable_jit():  # the fori_loop op by op: bit for bit
            ref_u = np.asarray(jd.undistort(jnp.asarray(pd)))
        np.testing.assert_array_equal(td.undistort(torch.from_numpy(pd)).numpy(), ref_u)


@pytest.mark.parametrize("name", list(MODELS))
def test_pinhole_against_jax(name):
    jc, tc = _cameras(name)
    pts = RNG.uniform([-0.8, -0.6, 1.0], [0.8, 0.6, 5.0], (300, 3)).astype(np.float32)
    pts[:4, 2] = [0.0, -1.0, 1e-3, 2.0]  # z = 0, behind the camera, grazing
    jkp, jvalid = jc.project(jnp.asarray(pts))
    kp, valid = tc.project(torch.from_numpy(pts))
    assert _ulp(kp.numpy()[4:], np.asarray(jkp)[4:]) <= ULP
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert _ulp(tc.unproject(torch.from_numpy(np.array(jkp)[4:])).numpy(),
                jc.unproject(jkp[4:])) <= ULP
    np.testing.assert_array_equal(tc.is_valid(kp).numpy(), np.asarray(jc.is_valid(jkp)))
    jj = np.asarray(jc.project_jacobian(jnp.asarray(pts[4:])))
    tj = tc.project_jacobian(torch.from_numpy(pts[4:])).numpy()
    assert tj.shape == jj.shape == (296, 2, 3)
    np.testing.assert_allclose(tj, jj, rtol=0, atol=1e-6 * np.abs(jj).max())


def test_pinhole_roundtrip():
    cam = tgeo.PinholeCamera(450.0, 452.0, 320.0, 240.0, 640, 480)
    rng = np.random.default_rng(0)
    pts = rng.uniform([-1, -1, 1], [1, 1, 5], (100, 3)).astype(np.float32)
    kp, valid = cam.project(torch.from_numpy(pts))
    rays = cam.unproject(kp).numpy()
    p = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    assert np.all(np.abs((rays * p).sum(1))[valid.numpy()] > 1 - 1e-5)


def test_radtan_roundtrip():
    dist = tgeo.RadialTangentialDistortion(-0.3, 0.1, 1e-3, -2e-3)
    rng = np.random.default_rng(1)
    pn = rng.uniform(-0.5, 0.5, (200, 2)).astype(np.float32)
    pu = dist.undistort(dist.distort(torch.from_numpy(pn)))
    np.testing.assert_allclose(pu.numpy(), pn, atol=1e-5)
    cam = tgeo.PinholeCamera(450.0, 452.0, 320.0, 240.0, 640, 480, dist)
    pts = rng.uniform([-0.5, -0.5, 2], [0.5, 0.5, 6], (50, 3)).astype(np.float32)
    kp, valid = cam.project(torch.from_numpy(pts))
    rays = cam.unproject(kp).numpy()
    p = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    assert np.all(np.abs((rays * p).sum(1))[valid.numpy()] > 1 - 1e-4)


def test_equidistant_roundtrip():
    dist = tgeo.EquidistantDistortion(-0.01, 0.005, -0.002, 0.001)
    pn = np.random.default_rng(2).uniform(-0.8, 0.8, (200, 2)).astype(np.float32)
    pu = dist.undistort(dist.distort(torch.from_numpy(pn)))
    np.testing.assert_allclose(pu.numpy(), pn, atol=1e-4)

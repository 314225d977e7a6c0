"""Port parity: the single-view ``CameraAwareFeature``, the grid's
extraction direction, and the JAX package's functional tests of the grid
(``tests/test_camera_aware_grid.py``) run on the port.

Inputs and tolerances as in ``test_torch_camera_aware.py``: the single
view's warp maps and warp bit for bit, its keypoints as the facades' (x
and y within 1 ULP before the distortion maps them back, within 4 ULP
after), descriptors and angles bit for bit; the extraction direction's
angles bit for bit too (the Jacobian by forward-mode differentiation in
both, then glibc's ``atan2f``).
"""
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu import geometry as jgeo  # noqa: E402
from ethzasl_brisk_tpu.geometry import camera_aware as jca  # noqa: E402
from ethzasl_brisk_tpu_torch import geometry as tgeo  # noqa: E402
from ethzasl_brisk_tpu_torch.geometry import camera_aware as tca  # noqa: E402

from .test_torch_camera_aware import (  # noqa: E402,F401
    CAMERAS,
    H,
    W,
    _bits,
    _same,
    _tables,
    _texture,
    carried_features,
    detections,
    features,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the JAX reference's compiles take the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_single_view_against_jax(features):
    """``CameraAwareFeature``: the warp maps and the warp bit for bit; the
    keypoints and descriptors as the facades' (x and y within 1 ULP before
    the distortion maps them back, so within 4 ULP after)."""
    jf, tf = features
    cls, coef = CAMERAS["radtan"]
    jc = jgeo.PinholeCamera.create(260.0, 260.0, 160.0, 120.0, W, H,
                                   getattr(jgeo, cls).create(*coef))
    tc = tgeo.PinholeCamera(260.0, 260.0, 160.0, 120.0, W, H, getattr(tgeo, cls)(*coef))
    img = _texture(seed=8)
    jsv, tsv = jca.CameraAwareFeature(camera=jc, feature=jf), tca.CameraAwareFeature(tc, tf)
    for a, b in zip(tsv.warp_maps(), jsv.warp_maps()):
        _same(a, b, "warp maps")
    kps, desc, warped = tsv.detect_and_compute(torch.from_numpy(img))
    rk, rd, rw = jsv.detect_and_compute(jnp.asarray(img))
    _same(warped, rw, "warped")
    valid = np.asarray(rk.valid)
    for f in ("size", "response", "octave", "valid"):
        _same(getattr(kps, f), getattr(rk, f), f)
    for f in ("x", "y"):
        gap = np.abs(_bits(getattr(kps, f).numpy()).astype(np.int64)
                     - _bits(np.asarray(getattr(rk, f))).astype(np.int64))
        assert gap.max() <= 4, f
    _same(desc, np.asarray(rd).view(np.int32), "descriptors")
    _same(kps.angle.numpy()[valid], np.asarray(rk.angle)[valid], "angle")
    assert valid.sum() > 50


def test_extraction_direction(features, detections):
    """setExtractionDirection: against the JAX grid on the same tables and
    detections (the Jacobian by forward-mode differentiation in both:
    bit for bit), and e_C = +y gives ~90 degrees near the center of
    an undistorted camera (``tests/test_camera_aware_grid.py``)."""
    jf, tf = features
    jc = jgeo.PinholeCamera.create(300.0, 300.0, W / 2.0, H / 2.0, W, H)
    tc = tgeo.PinholeCamera(300.0, 300.0, W / 2.0, H / 2.0, W, H)
    img = _texture()
    jfeat, tfeat = carried_features(features, detections)
    kw = dict(distortion_tolerance=10.0, extraction_direction=(0.0, 1.0, 0.0))
    jgrid = jca.CameraAwareFeatureGrid(camera=jc, feature=jfeat, **kw)
    tgrid = tca.CameraAwareFeatureGrid(tc, tfeat, device="cpu", tables=_tables(jgrid), **kw)
    rk, rd = jgrid.detect_and_compute(jnp.asarray(img))
    kps, desc = tgrid.detect_and_compute(torch.from_numpy(img))
    valid = np.asarray(rk.valid)
    _same(kps.valid, valid, "valid")
    _same(desc, np.asarray(rd).view(np.int32), "descriptors")
    _same(kps.angle.numpy()[valid], np.asarray(rk.angle)[valid], "angle")
    x, y, ang = kps.x.numpy()[valid], kps.y.numpy()[valid], kps.angle.numpy()[valid]
    central = (np.abs(x - W / 2.0) < 60) & (np.abs(y - H / 2.0) < 60)
    assert central.sum() > 5
    da = np.abs(ang[central] - 90.0)
    assert np.minimum(da, 360 - da).max() < 3.0


def test_identity_grid_matches_plain_pipeline(features):
    """A 1 x 1 grid under NoDistortion is the original camera: the plain
    pipeline's detections, its validity less removeBorderKeypoints(2.0),
    near-identical descriptors (the keypoints pass the float undistort
    maps) and angles (``tests/test_camera_aware_grid.py:42``)."""
    tf = features[1]
    cam = tgeo.PinholeCamera(300.0, 300.0, W / 2.0, H / 2.0, W, H)
    grid = tca.CameraAwareFeatureGrid(cam, tf, distortion_tolerance=10.0, device="cpu")
    assert (grid.n_x, grid.n_y) == (1, 1)
    v = grid.views[0]
    assert (v.pixels_u, v.pixels_v) == (W, H)
    np.testing.assert_allclose([v.center_u, v.center_v], [W / 2.0, H / 2.0], atol=1e-3)
    np.testing.assert_allclose(grid.focal, 300.0, rtol=1e-4)
    np.testing.assert_allclose(grid.r_ci_c[0].numpy(), np.eye(3), atol=1e-5)
    img = torch.from_numpy(_texture())
    assert torch.equal(grid.warp_views(img)[0, :H, :W], img)
    kg, dg = grid.detect_and_compute(img)
    kp, dp = tf.detect_and_compute(img)
    assert torch.equal(kg.x, kp.x)
    s2 = 2.0 * kp.size
    ok = (kp.x - s2 >= 0) & (kp.y - s2 >= 0) & (kp.x + s2 <= W) & (kp.y + s2 <= H)
    assert torch.equal(kg.valid, kp.valid & ok) and int(kg.valid.sum()) > 30
    x = (dg[kg.valid] ^ dp[kg.valid]).numpy().view(np.uint8)
    ham = np.unpackbits(x, axis=1).sum(axis=1)
    assert (ham == 0).mean() > 0.98 and ham.max() <= 4
    da = (kg.angle - kp.angle).abs()[kg.valid]
    assert float(torch.minimum(da, 360 - da).max()) < 0.75


def test_grid_beats_single_view_near_border(features):
    """Strong barrel distortion: the grid's views keep describing
    keypoints near the border that the single view loses
    (``tests/test_camera_aware_grid.py:105``)."""
    tf = features[1]
    dist = tgeo.RadialTangentialDistortion(-0.31, 0.11, 0.0, 0.0)
    cam = tgeo.PinholeCamera(200.0, 200.0, W / 2.0, H / 2.0, W, H, dist)
    ys, xs = np.mgrid[0:H, 0:W]
    pn = np.stack([(xs - W / 2.0) / 200.0, (ys - H / 2.0) / 200.0], -1).astype(np.float32)
    pu = dist.undistort(torch.from_numpy(pn))
    captured = tca.bilinear_remap(torch.from_numpy(_texture()), 200.0 * pu[..., 0] + W / 2.0,
                                  200.0 * pu[..., 1] + H / 2.0)
    grid = tca.CameraAwareFeatureGrid(cam, tf, margin=40, device="cpu")
    assert grid.n_views >= 4 and float((grid.sel_map > 0).float().mean()) > 0.98
    kg, _ = grid.detect_and_compute(captured)
    ks, _, _ = tca.CameraAwareFeature(cam, tf).detect_and_compute(captured)

    def near_border(k):
        near = (k.x < 50) | (k.x >= W - 50) | (k.y < 50) | (k.y >= H - 50)
        return int((near & k.valid).sum())

    assert near_border(kg) > 10 and near_border(kg) > near_border(ks)


def test_grid_refuses_a_feature_elsewhere():
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="same device"):
        tca.CameraAwareFeatureGrid(tgeo.PinholeCamera(300.0, 300.0, 160.0, 120.0, W, H),
                                   elsewhere, device="cpu")

"""Port parity: ``geometry/camera_aware.py`` and
``extract_descriptors_views`` against the JAX package.

A 240 x 320 texture (``tests/test_camera_aware_grid.py``'s recipe) seen
through a radial-tangential camera (``tests/test_geometry.py:167-169``)
and an equidistant one, with ``tests/test_camera_aware_grid.py``'s
``BriskFeature`` (octaves 0, threshold 35, 512 keypoints).

* ``bilinear_remap`` and ``warp_views``: bit for bit given the same maps.
* The grid's ``detect_and_compute`` with the JAX grid's tables installed
  (``install_tables``) and the same detections on both sides (the JAX
  grid detects with a jitted detect, whose float tails XLA:CPU may
  contract; detection itself is held in ``test_torch_facade.py``): every
  keypoint field and every descriptor bit for bit. The angle is within
  1e-3 degree (measured 8.2e-4): the view angle differs from JAX's within
  the facade's 1e-4 degree (float32 ``atan2``), and the back-transform's
  ``cos``, ``sin`` and ``atan2``, XLA's and torch's, differ in the last
  bits again.
* The port's own grid, built on the host from its own cameras, against
  the JAX grid built op by op (``jax.disable_jit()``): the grid size, the
  focal length and the view sizes exactly; the maps within 1e-4 px where
  the grid reads them (the undistort map where the selection map picks the
  view, the distort map inside the view's true size; measured 1.5e-5 /
  3.6e-5 px) and within 3e-4 px everywhere (measured 2.4e-4, equidistant:
  XLA's and torch's ``arctan`` and ``tan``); selection maps disagree on at
  most 0.1 % of the pixels (measured 0).
* ``extract_descriptors_views`` on two views of different true sizes.

The single view, the extraction direction, the identity grid and the
border test are in ``test_torch_camera_aware_views.py``.
"""
import types

import numpy as np
import pytest
import torch
from scipy import ndimage

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu import geometry as jgeo  # noqa: E402
from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.describe import extractor as jext  # noqa: E402
from ethzasl_brisk_tpu.geometry import camera_aware as jca  # noqa: E402
from ethzasl_brisk_tpu.pipeline import BriskFeature as JaxBriskFeature  # noqa: E402
from ethzasl_brisk_tpu_torch import BriskFeature, KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch import geometry as tgeo  # noqa: E402
from ethzasl_brisk_tpu_torch.describe.extractor import (  # noqa: E402
    PATTERN_FIELDS,
    extract_descriptors_views,
    pattern_from_numpy,
)
from ethzasl_brisk_tpu_torch.geometry import camera_aware as tca  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the JAX reference's compiles take the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W = 240, 320
FIELDS = ("x", "y", "size", "angle", "response", "octave", "valid")
FEATURE = dict(octaves=0, uniformity_radius=0.0, absolute_threshold=35.0, max_candidates=512,
               max_keypoints=512)
CAMERAS = {
    "radtan": ("RadialTangentialDistortion", (-0.25, 0.06, 0.0, 0.0)),
    "equidistant": ("EquidistantDistortion", (-0.01, 0.005, -0.002, 0.001)),
}


def _texture(h=H, w=W, seed=6):
    rng = np.random.default_rng(seed)
    tex = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w)), 1.5)
    return ((tex - tex.min()) / (np.ptp(tex) + 1e-9) * 255).astype(np.uint8)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def _same(got, ref, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(_bits(got), _bits(ref.astype(got.dtype)), err_msg=what)


def _tables(jg) -> dict:
    """The JAX grid's host tables, as ``install_tables`` takes them."""
    return dict(dist_maps=np.asarray(jg._dist_maps), undist_maps=np.asarray(jg._undist_maps),
                sel_map=np.asarray(jg._sel_map), n_x=jg.n_x, n_y=jg.n_y, focal=jg.focal,
                r_ci_c=np.asarray(jg._r_ci_c), view_cols=np.asarray(jg._view_cols),
                view_rows=np.asarray(jg._view_rows))


@pytest.fixture(scope="module")
def features():
    jf = JaxBriskFeature(**FEATURE, eager_exact=True)
    carried = pattern_from_numpy(
        {f: np.asarray(getattr(jf.extractor.pattern, f)) for f in PATTERN_FIELDS})
    return jf, BriskFeature(**FEATURE, pattern=carried, device="cpu")


@pytest.fixture(scope="module", params=list(CAMERAS))
def grids(request, features):
    """(name, JAX camera, port camera, JAX grid built op by op, port grid
    built by the port)."""
    cls, coef = CAMERAS[request.param]
    jc = jgeo.PinholeCamera.create(260.0, 260.0, 160.0, 120.0, W, H,
                                   getattr(jgeo, cls).create(*coef))
    tc = tgeo.PinholeCamera(260.0, 260.0, 160.0, 120.0, W, H, getattr(tgeo, cls)(*coef))
    jf, tf = features
    with jax.disable_jit():
        jg = jca.CameraAwareFeatureGrid(camera=jc, feature=jf, margin=40)
    return request.param, jc, tc, jg, tca.CameraAwareFeatureGrid(tc, tf, margin=40, device="cpu")


def test_bilinear_remap_bitwise():
    img = _texture()
    rng = np.random.default_rng(3)
    # Inside, on the edges, outside, and far out (the int cast saturates).
    sx = rng.uniform(-20, W + 20, (60, 70)).astype(np.float32)
    sy = rng.uniform(-20, H + 20, (60, 70)).astype(np.float32)
    sx[0, :4] = [0.0, W - 1, -1e9, 1e9]
    sy[0, :4] = [0.0, H - 1, 5.0, 5.0]
    got = tca.bilinear_remap(torch.from_numpy(img), torch.from_numpy(sx), torch.from_numpy(sy))
    ref = jca.bilinear_remap(jnp.asarray(img), jnp.asarray(sx), jnp.asarray(sy))
    _same(got, ref)
    assert got.dtype == torch.uint8 and int((got > 0).sum()) > 3000


def test_port_grid_against_jax(grids):
    name, _, _, jg, tg = grids
    assert (tg.n_x, tg.n_y, tg.n_views) == (jg.n_x, jg.n_y, jg.n_views) == (3, 3, 9)
    _same(tg.view_cols, jg._view_cols, "view_cols")
    _same(tg.view_rows, jg._view_rows, "view_rows")
    assert abs(tg.focal - jg.focal) <= 1e-9 * abs(jg.focal)
    np.testing.assert_allclose(tg.r_ci_c.numpy(), np.asarray(jg._r_ci_c), rtol=0, atol=1e-7)
    for got, ref in ((tg.views, jg._views),):
        for a, b in zip(got, ref):
            np.testing.assert_allclose([a.center_u, a.center_v], [b.center_u, b.center_v],
                                       rtol=0, atol=1e-4)
    dm = np.abs(tg.dist_maps.numpy() - np.asarray(jg._dist_maps))
    um = np.abs(tg.undist_maps.numpy() - np.asarray(jg._undist_maps))
    sel = np.asarray(jg._sel_map)
    assert dm.max() <= 3e-4 and um.max() <= 3e-4, (dm.max(), um.max())
    for i in range(jg.n_views):
        rows, cols = int(jg._view_rows[i]), int(jg._view_cols[i])
        assert dm[i, :rows, :cols].max() <= 1e-4, (name, i)
        if (sel == i + 1).any():
            assert um[i][sel == i + 1].max() <= 1e-4, (name, i)
    assert int((tg.sel_map.numpy() != sel).sum()) <= H * W // 1000
    assert (sel > 0).mean() > 0.98


def test_warp_views_bitwise(grids, features):
    _, _, tc, jg, _ = grids
    tg = tca.CameraAwareFeatureGrid(tc, features[1], margin=40, device="cpu",
                                    tables=_tables(jg))
    img = _texture()
    got = tg.warp_views(torch.from_numpy(img))
    _same(got, jg.warp_views(jnp.asarray(img)))
    assert tuple(got.shape) == tuple(jg._dist_maps.shape[:3])


@pytest.fixture(scope="module")
def detections(features):
    """The JAX feature's detections of ``_texture()``, op by op, and the
    same as port KeyPoints."""
    jk = features[0].detect(jnp.asarray(_texture()))
    return jk, KeyPoints(*(torch.from_numpy(np.array(getattr(jk, f))) for f in FIELDS))


def carried_features(features, detections):
    """Features that hand both grids the same detections."""
    (jf, tf), (jk, tk) = features, detections
    jfeat = types.SimpleNamespace(
        _detect_jit=lambda im: jk, extractor=jf.extractor, rotation_invariant=True,
        scale_invariant=True, sampler=jf.sampler, patch_h=jf.patch_h, patch_w=jf.patch_w)
    tfeat = types.SimpleNamespace(detect=lambda im: tk, extractor=tf.extractor, device=tf.device)
    return jfeat, tfeat


def test_grid_detect_and_compute_bitwise(grids, features, detections):
    _, jc, tc, jg, _ = grids
    img = _texture()
    jfeat, tfeat = carried_features(features, detections)
    jgrid = jca.CameraAwareFeatureGrid(camera=jc, feature=jfeat, margin=40)
    tgrid = tca.CameraAwareFeatureGrid(tc, tfeat, margin=40, device="cpu", tables=_tables(jgrid))
    ref_kps, ref_desc = jgrid.detect_and_compute(jnp.asarray(img))
    stages = []
    kps, desc = tgrid.detect_and_compute(torch.from_numpy(img), mark=stages.append)
    assert stages == ["detect", "warp", "describe", "angles"]
    valid = np.asarray(ref_kps.valid)
    for f in FIELDS:
        if f != "angle":
            _same(getattr(kps, f), getattr(ref_kps, f), f)
    _same(desc, np.asarray(ref_desc).view(np.int32), "descriptors")
    np.testing.assert_allclose(kps.angle.numpy()[valid], np.asarray(ref_kps.angle)[valid],
                               rtol=0, atol=1e-3)
    assert valid.sum() > 300


def test_extract_descriptors_views(features):
    """Two views of different true sizes padded to one frame: the border
    filter takes each view's own size; the descriptors equal JAX's."""
    jf, tf = features
    views = np.stack([_texture(120, 160, seed=1), _texture(120, 160, seed=2)])
    rng = np.random.default_rng(4)
    n = 200
    f = dict(x=rng.uniform(0, 160, n), y=rng.uniform(0, 120, n), size=rng.uniform(8, 30, n),
             angle=np.full(n, -1.0), response=np.ones(n), octave=np.zeros(n),
             valid=np.ones(n, bool))
    f = {k: v.astype(np.int32 if k == "octave" else bool if k == "valid" else np.float32)
         for k, v in f.items()}
    vidx = (np.arange(n) % 2).astype(np.int32)
    cols, rows = np.array([160, 110], np.int32), np.array([120, 90], np.int32)
    ref_kps, ref_desc = jext.extract_descriptors_views(
        jf.extractor.pattern, jnp.asarray(views), JaxKeyPoints(**{k: jnp.asarray(v) for k, v in
                                                                  f.items()}),
        jnp.asarray(vidx), skip_small=True, view_cols=jnp.asarray(cols),
        view_rows=jnp.asarray(rows))
    kps, desc = extract_descriptors_views(
        tf.pattern, torch.from_numpy(views), KeyPoints(**{k: torch.from_numpy(v)
                                                          for k, v in f.items()}),
        torch.from_numpy(vidx), view_cols=torch.from_numpy(cols),
        view_rows=torch.from_numpy(rows))
    valid = np.asarray(ref_kps.valid)
    _same(kps.valid, valid, "valid")
    _same(desc, np.asarray(ref_desc).view(np.int32), "descriptors")
    np.testing.assert_allclose(kps.angle.numpy()[valid], np.asarray(ref_kps.angle)[valid],
                               rtol=0, atol=1e-4)
    # View 1's true size cuts some keypoints that view 0's would keep.
    full = extract_descriptors_views(
        tf.pattern, torch.from_numpy(views), KeyPoints(**{k: torch.from_numpy(v)
                                                          for k, v in f.items()}),
        torch.from_numpy(vidx))[0].valid
    assert int(full.sum()) > int(kps.valid.sum()) > 20

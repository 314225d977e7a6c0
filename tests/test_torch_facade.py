"""Port parity: the single-image facades and the README quick-start path.

``BriskFeature.detect_and_compute`` / ``detect_with_diagnostics`` (with
``fused_mask=True``, so kernel K3's plain version runs),
``HarrisFeatureDetector``, ``BriskExtractor`` without rotation or scale
invariance, ``extract_descriptors_batch``, the PGM reader and writer, and
the README path ``write_pgm -> read_pgm -> detect_and_compute ->
radius_match_best``, against the JAX package on the same numpy inputs.

The JAX reference detects eagerly (``eager_exact=True``: jitted XLA:CPU
may FMA-contract the sub-pixel float chain) and samples with its ``gather``
sampler; the pattern tables travel from it as numpy arrays. Tolerances, as
in tests/test_torch_pipeline.py: integer outputs and descriptors bit for
bit, x/y within 1 ULP, the angle bit for bit (JAX's float32 ``atan2``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core import image_io as jio  # noqa: E402
from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.describe.extractor import (  # noqa: E402
    BriskExtractor as JaxBriskExtractor,
    extract_descriptors_batch as jax_describe_batch,
)
from ethzasl_brisk_tpu.match.matcher import radius_match_best as jax_radius_best  # noqa: E402
from ethzasl_brisk_tpu.pipeline import (  # noqa: E402
    BriskFeature as JaxBriskFeature,
    HarrisFeatureDetector as JaxHarris,
)
from ethzasl_brisk_tpu_torch import BriskFeature, HarrisFeatureDetector, KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch.core.image_io import read_pgm, read_pgm_batch, write_pgm  # noqa: E402
from ethzasl_brisk_tpu_torch.describe.extractor import (  # noqa: E402
    PATTERN_FIELDS,
    BriskExtractor,
    describable_count,
    extract_descriptors_batch,
    pattern_from_numpy,
)
from ethzasl_brisk_tpu_torch.frames import bench_frames  # noqa: E402
from ethzasl_brisk_tpu_torch.match.matcher import radius_match_best  # noqa: E402

H, W = 120, 160
CONFIG = dict(uniformity_radius=30.0, absolute_threshold=20.0, max_candidates=1536,
              max_keypoints=384)
RADIUS = 90


def _assert_ulp(a, b, ulps=1):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    gap = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    assert gap.max(initial=0) <= ulps, gap.max()


def _assert_kps(got: KeyPoints, ref, valid_only_angle=True):
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for name in ("size", "response", "octave"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    for name in ("x", "y"):
        _assert_ulp(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    sel = valid if valid_only_angle else np.ones_like(valid)
    np.testing.assert_array_equal(got.angle.numpy()[sel].view(np.int32),
                                  np.asarray(ref.angle)[sel].view(np.int32))


def _carried(jax_extractor):
    return pattern_from_numpy(
        {f: np.asarray(getattr(jax_extractor.pattern, f)) for f in PATTERN_FIELDS}
    )


def _to_jax_kps(kps: KeyPoints):
    return JaxKeyPoints(**{n: jnp.asarray(getattr(kps, n).numpy()) for n in
                           ("x", "y", "size", "angle", "response", "octave", "valid")})


@pytest.fixture(scope="module")
def views():
    """Two 120x160 views of one smoothed-noise scene, the second shifted by
    (6, 4) pixels, so that descriptors match across them."""
    scene = bench_frames(1, H + 6, W + 4, seed=21)[0]
    return np.stack([scene[:H, :W], scene[6:, 4:]])


@pytest.fixture(scope="module", params=[0, 2], ids=["octaves0", "octaves2"])
def facade_pair(request, views):
    """(port feature, JAX feature, port outputs, JAX outputs) on view 0."""
    octaves = request.param
    jf = JaxBriskFeature(octaves=octaves, fused_mask=True, eager_exact=True, **CONFIG)
    feature = BriskFeature(octaves=octaves, fused_mask=True, pattern=_carried(jf.extractor),
                           device="cpu", **CONFIG)
    img = views[0]
    port = (feature.detect_with_diagnostics(torch.from_numpy(img)),
            feature.detect_and_compute(torch.from_numpy(img)))
    ref = (jf.detect_with_diagnostics(jnp.asarray(img)),
           jf.detect_and_compute(jnp.asarray(img)))
    return feature, jf, port, ref


def test_detect_with_diagnostics_matches_jax(facade_pair):
    _, jf, port, ref = facade_pair
    (kps, diag), (jkps, jdiag) = port[0], ref[0]
    assert kps.x.shape == jkps.x.shape
    _assert_kps(kps, jkps, valid_only_angle=False)
    assert set(diag._fields) == set(jdiag._fields)
    for name in jdiag._fields:
        np.testing.assert_array_equal(getattr(diag, name).numpy(), np.asarray(getattr(jdiag, name)),
                                      err_msg=name)
    assert bool(diag.ok) and int(kps.valid.sum()) > 5


def test_detect_and_compute_matches_jax(facade_pair, views):
    feature, jf, port, ref = facade_pair
    (kps, desc), (jkps, jdesc) = port[1], ref[1]
    assert tuple(desc.shape) == (kps.capacity, 12) and desc.dtype == torch.int32
    _assert_kps(kps, jkps)
    np.testing.assert_array_equal(desc.numpy(), np.asarray(jdesc).view(np.int32))
    assert int(kps.valid.sum()) > 5
    # The batched entry gives each frame's single-image result.
    bk, bd = feature.detect_and_compute(torch.from_numpy(views))
    assert torch.equal(bd[0], desc) and torch.equal(bk.valid[0], kps.valid)


def test_harris_detector_matches_jax(views):
    got = HarrisFeatureDetector(threshold=20.0, max_candidates=1536, device="cpu").detect(
        torch.from_numpy(views[1]))
    ref = JaxHarris(threshold=20.0, max_candidates=1536).detect(jnp.asarray(views[1]))
    assert got.capacity == ref.x.shape[0] == 1536
    _assert_kps(got, ref, valid_only_angle=False)
    assert int(got.valid.sum()) > 5


@pytest.fixture(scope="module")
def batch_kps(views):
    """Port keypoints of both views (B=2, K=384) with every other valid
    keypoint given a preset angle, which describe must keep."""
    kps = BriskFeature(octaves=2, device="cpu", **CONFIG).detect(torch.from_numpy(views))
    rng = np.random.default_rng(5)
    preset = rng.uniform(-180, 180, kps.x.shape).astype(np.float32)
    keep = (np.arange(kps.capacity)[None, :] % 2 == 0)
    angle = torch.where(torch.from_numpy(keep), torch.from_numpy(preset), kps.angle)
    return KeyPoints(kps.x, kps.y, kps.size, angle, kps.response, kps.octave, kps.valid)


@pytest.mark.parametrize("rot,scale,pattern_scale", [
    (False, False, 1.0), (True, False, 1.0), (False, True, 1.0), (True, True, 0.8),
])
def test_extractor_matches_jax(views, batch_kps, rot, scale, pattern_scale):
    jext = JaxBriskExtractor(rotation_invariant=rot, scale_invariant=scale,
                             pattern_scale=pattern_scale)
    ext = BriskExtractor(rotation_invariant=rot, scale_invariant=scale,
                         pattern_scale=pattern_scale, device="cpu")
    for f in PATTERN_FIELDS:
        np.testing.assert_array_equal(
            getattr(ext.pattern, f).numpy(), np.asarray(getattr(jext.pattern, f)), err_msg=f
        )
    kps = batch_kps.map(lambda a: a[1])
    got_kp, got = ext(torch.from_numpy(views[1]), kps)
    ref_kp, ref = jext(jnp.asarray(views[1]), _to_jax_kps(kps))
    _assert_kps(got_kp, ref_kp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).view(np.int32))
    assert int(got_kp.valid.sum()) > 5
    assert int(describable_count(ext.pattern, torch.from_numpy(views[1:]), kps,
                                 scale_invariant=scale)) == int(got_kp.valid.sum())


def test_extract_descriptors_batch_matches_jax(views, batch_kps):
    jext = JaxBriskExtractor()
    pat = _carried(jext)
    got_kp, got = extract_descriptors_batch(pat, torch.from_numpy(views), batch_kps)
    ref_kp, ref = jax_describe_batch(jext.pattern, jnp.asarray(views), _to_jax_kps(batch_kps),
                                     skip_small=jext.skip_small)
    assert tuple(got.shape) == (2, batch_kps.capacity, 12)
    _assert_kps(got_kp, ref_kp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).view(np.int32))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pgm_round_trip_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(8)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (37, 53)).astype(dtype)
    path = str(tmp_path / "img.pgm")
    write_pgm(path, img)
    got = read_pgm(path)
    assert got.dtype == dtype and got.flags.writeable
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jio._read_pgm_py(path))
    jio.write_pgm(str(tmp_path / "jax.pgm"), img)
    assert (tmp_path / "jax.pgm").read_bytes() == (tmp_path / "img.pgm").read_bytes()
    # The ascii form (P2), with a comment in the header.
    (tmp_path / "a.pgm").write_text(
        f"P2\n# comment\n53 37\n{np.iinfo(dtype).max}\n" + " ".join(map(str, img.ravel())) + "\n"
    )
    np.testing.assert_array_equal(read_pgm(str(tmp_path / "a.pgm")), img)
    np.testing.assert_array_equal(read_pgm_batch([path, str(tmp_path / "a.pgm")], 2),
                                  np.stack([img, img]))


def test_readme_quick_start_matches_jax(tmp_path, views):
    """write_pgm -> read_pgm -> detect_and_compute -> radius_match_best."""
    paths = [str(tmp_path / f"img{i}.pgm") for i in range(2)]
    for p, v in zip(paths, views):
        write_pgm(p, v)
    jf = JaxBriskFeature(octaves=0, fused_mask=True, eager_exact=True, **CONFIG)
    feature = BriskFeature(octaves=0, fused_mask=True, pattern=_carried(jf.extractor),
                           device="cpu", **CONFIG)
    port = [feature.detect_and_compute(torch.from_numpy(read_pgm(p))) for p in paths]
    ref = [jf.detect_and_compute(jnp.asarray(jio._read_pgm_py(p))) for p in paths]
    for (kps, desc), (jkps, jdesc) in zip(port, ref):
        _assert_kps(kps, jkps)
        np.testing.assert_array_equal(desc.numpy(), np.asarray(jdesc).view(np.int32))
    got = radius_match_best(port[1][1], port[0][1], port[1][0].valid, port[0][0].valid, RADIUS)
    want = jax_radius_best(ref[1][1], ref[0][1], ref[1][0].valid, ref[0][0].valid, RADIUS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) > 5

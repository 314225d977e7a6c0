"""Port parity: the v1 engine's resamplers, patterns, pyramid, K2's v1
rounding and the v1 descriptors against the JAX package.

* ``halfsample8_v1`` and ``twothirdsample8_v1`` at odd sizes and the VGA
  pyramid's sizes, against the JAX functions and the scalar emulations of
  the SSE code in ``tests/test_v1.py``; batched frames equal each frame.
* ``brisk_v1_pattern`` at pattern scales 1 and 0.5 against the JAX tables
  and the compiled reference's slices (``tests/fixtures``);
  ``pattern_from_file`` on a ``.ptn`` written from the v2 base points.
* K2's plain version with ``v1_rounding`` against
  ``smoothed_intensity_u8(v1_rounding=True)`` and the ``patch_ms`` sampler,
  with the bilinear branch live (pattern scale 0.5, small keypoints).
* The facades' 16-word descriptors on the port's detections (the
  detections themselves are held in ``test_torch_v1_detect*.py``), the
  ``pattern_file`` switch, and both batched steps with a v1 detector,
  whose describe rounds as v2 (the JAX steps pass no ``v1_rounding``) and
  whose AST match covers 512 bits.

Inputs are smoothed noise made from a seed. Tolerances: bit for bit,
except the facades' valid angles within 1e-4 degree (XLA's and torch's
float32 ``atan2`` differ in the last bits), bit for bit with
``angle_exact=True``.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core import pattern as jpat  # noqa: E402
from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.describe import extractor as jext  # noqa: E402
from ethzasl_brisk_tpu.describe.fast_sampler import smoothed_intensity_patch_ms  # noqa: E402
from ethzasl_brisk_tpu.kernels import downsample as jds  # noqa: E402
from ethzasl_brisk_tpu.match.matcher import hamming_distance_matrix as jax_hamming  # noqa: E402
from ethzasl_brisk_tpu.parallel.frames import _match_adjacent  # noqa: E402
from ethzasl_brisk_tpu_torch import (  # noqa: E402
    AstFramePipeline,
    BriskFeature,
    BriskFeatureDetector,
    FramePipeline,
    KeyPoints,
)
from ethzasl_brisk_tpu_torch.core import pattern as tpat  # noqa: E402
from ethzasl_brisk_tpu_torch.describe.extractor import (  # noqa: E402
    BriskExtractor,
    _stack_frames,
)
from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity  # noqa: E402
from ethzasl_brisk_tpu_torch.kernels import downsample as tds  # noqa: E402

from . import test_v1 as jv1  # noqa: E402  (the scalar resampler emulations)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the JAX reference's compiles take the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("x", "y", "size", "angle", "response", "octave", "valid")
TABLES = ("lut_x", "lut_y", "lut_sigma", "scale_list", "size_list", "short_pairs",
          "long_pairs", "long_weights")
H, W = 96, 128
AST_KW = dict(threshold=30, octaves=2, max_candidates_per_layer=(384, 256, 128, 64))
HARRIS_KW = dict(octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
                 max_candidates=(704, 256, 192, 96), max_keypoints=128)


def _frames(n, seed=21, h=H, w=W):
    base = np.random.default_rng(seed).integers(0, 256, (n, h, w)).astype(np.float32)
    return np.clip(ndimage.convolve(base, np.ones((1, 3, 3)) / 9.0, mode="nearest"),
                   0, 255).astype(np.uint8)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype in (np.float32, np.uint32) else a


def _same(got, ref, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(_bits(got), _bits(ref.astype(got.dtype)), err_msg=what)


def _same_kps(got, ref, angle="bits"):
    valid = np.asarray(ref.valid)
    for f in FIELDS:
        if f != "angle":
            _same(getattr(got, f), getattr(ref, f), f)
    g, r = got.angle.numpy()[valid], np.asarray(ref.angle)[valid]
    if angle == "bits":
        _same(g, r, "angle")
    else:
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)


def _to_jax(kps: KeyPoints):
    return JaxKeyPoints(**{f: jnp.asarray(getattr(kps, f).numpy()) for f in FIELDS})


# ---------------------------------------------------------------------------
# Resamplers.
# ---------------------------------------------------------------------------
# Odd crops (tests/test_v1.py) and the VGA pyramid's layer sizes.
@pytest.mark.parametrize("shape", [(96, 160), (63, 106), (70, 133), (480, 640), (320, 426),
                                   (240, 320), (160, 213)])
def test_v1_resamplers_bitwise(shape):
    src = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    t = torch.from_numpy(src)
    third, half = tds.twothirdsample8_v1(t), tds.halfsample8_v1(t)
    assert third.dtype == half.dtype == torch.uint8
    assert third.shape == (2 * (shape[0] // 3), 2 * (shape[1] // 3))
    assert half.shape == (shape[0] // 2, shape[1] // 2)
    # Integer ops only, so the jitted JAX functions are exact (and compile
    # once a shape, where op by op compiles each op).
    _same(third, jax.jit(jds.twothirdsample8_v1)(jnp.asarray(src)), "twothirds vs JAX")
    _same(half, jax.jit(jds.halfsample8_v1)(jnp.asarray(src)), "half vs JAX")
    _same(third, jv1.TestV1Resamplers._twothirds_scalar(src), "twothirds vs scalar")
    _same(half, jv1.TestV1Resamplers._half_scalar(src), "half vs scalar")
    # A batch equals each frame alone.
    both = torch.stack([t, t.flip(0)])
    assert torch.equal(tds.twothirdsample8_v1(both)[0], third)
    assert torch.equal(tds.halfsample8_v1(both)[1], tds.halfsample8_v1(t.flip(0)))


def test_v1_resamplers_differ_from_v2():
    """The v1 rounding is not v2's: on noise they disagree somewhere."""
    src = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (63, 106), dtype=np.uint8))
    assert not torch.equal(tds.twothirdsample8_v1(src), tds.twothirdsample8(src))
    assert not torch.equal(tds.halfsample8_v1(src), tds.halfsample8(src))


# ---------------------------------------------------------------------------
# Patterns.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pattern_scale", [1.0, 0.5])
def test_v1_pattern_tables(pattern_scale):
    got, ref = tpat.brisk_v1_pattern(pattern_scale), jpat.brisk_v1_pattern(pattern_scale)
    for f in TABLES:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(got.lut_scaling, ref.lut_scaling)
    np.testing.assert_array_equal(got.lut_scaling2, ref.lut_scaling2)
    assert got.lut_x.shape == (64, 1024, 60)
    assert got.short_pairs.shape == (512, 2) and got.long_pairs.shape == (870, 2)
    assert got.descriptor_words == 16
    if pattern_scale == 1.0:
        # The compiled reference's tables (tests/test_v1.py:TestPatternGoldens).
        import pathlib

        fix = np.load(pathlib.Path(__file__).parent / "fixtures" / "v1_pattern_slices.npz")
        np.testing.assert_array_equal(got.scale_list, fix["scale_list"])
        np.testing.assert_array_equal(got.size_list, fix["size_list"].astype(np.int32))
        pts = fix["points"]
        np.testing.assert_array_equal(got.lut_x[:, fix["rots"]], pts[..., 0])
        np.testing.assert_array_equal(got.lut_y[:, fix["rots"]], pts[..., 1])
        np.testing.assert_array_equal(got.lut_sigma, pts[:, 0, :, 2])
        np.testing.assert_array_equal(got.short_pairs, fix["short_pairs"].astype(np.int32))
        np.testing.assert_array_equal(got.long_pairs, fix["long_pairs"][:, :2])
        np.testing.assert_array_equal(got.long_weights, fix["long_pairs"][:, 2:])
        assert got.lut_sigma.min() >= 0.5  # the bilinear branch is dead at scale 1
    else:
        assert got.lut_sigma.min() < 0.5


def _write_ptn(path) -> str:
    """The v2 base points and pairs as a ``.ptn`` file (InitFromStream's
    token order)."""
    with np.load(tpat._PATTERN_NPZ) as data:
        pts, short, long = data["points"], data["short_pairs"], data["long_pairs"]
    lines = [str(len(pts))] + [" ".join(repr(float(v)) for v in p) for p in pts]
    lines += [str(len(short))] + [f"{i} {j}" for i, j in short]
    lines += [str(len(long))] + [f"{i} {j}" for i, j in long]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("pattern_scale", [1.0, 0.5])
def test_pattern_from_file(tmp_path, pattern_scale):
    path = _write_ptn(tmp_path / f"v2_{pattern_scale}.ptn")
    got = tpat.pattern_from_file(path, pattern_scale)
    ref = jpat.pattern_from_file(path, pattern_scale)
    v2 = tpat.brisk_v2_pattern(pattern_scale)
    for f in TABLES:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(v2, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(v2, f).dtype, f


# ---------------------------------------------------------------------------
# K2's plain version with v1 rounding.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pattern_scale", [1.0, 0.5])
def test_sampler_v1_rounding(pattern_scale):
    """Against the JAX gather sampler and the ``patch_ms`` sampler with
    ``v1_rounding=True`` on every describable point. At pattern scale 0.5
    the keypoints of size under ~7.5 (scale index 0) take the bilinear
    branch, so both branches are live."""
    b, h, w, k = 2, 160, 200, 40
    imgs = _frames(b, seed=9, h=h, w=w)
    rng = np.random.default_rng(9)
    kx = rng.uniform(30, 170, b * k).astype(np.float32)
    ky = rng.uniform(30, 130, b * k).astype(np.float32)
    sizes = rng.choice([5.0, 6.0, 12.0, 18.0, 24.0], b * k).astype(np.float32)
    row_base = np.repeat(np.arange(b, dtype=np.int32) * (h + 1), k)
    host = jpat.brisk_v1_pattern(pattern_scale)
    sidx = np.asarray(jext.scale_index(jnp.asarray(sizes), True))
    tab = [host.lut_x[sidx, 7], host.lut_y[sidx, 7], host.lut_sigma[sidx],
           host.lut_scaling[sidx], host.lut_scaling2[sidx]]
    border = host.size_list[sidx].astype(np.float32)
    desc = (kx >= border) & (kx < w - border) & (ky >= border) & (ky < h - border)
    small = tab[2] < 0.5
    assert desc.sum() > 30
    assert (small[desc].sum() > 0) == (pattern_scale == 0.5)

    def port(v1):
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in tab]
        return smoothed_intensity(
            _stack_frames(torch.from_numpy(imgs)), torch.from_numpy(kx), torch.from_numpy(ky),
            *t, torch.from_numpy(row_base), h, v1,
        ).numpy()

    got = port(True)
    img_pad, int_flat = jext._stack_frames(jnp.asarray(imgs))
    args = (img_pad, int_flat, jnp.asarray(kx), jnp.asarray(ky), *map(jnp.asarray, tab))
    kw = dict(row_base=jnp.asarray(row_base), frame_rows=h, v1_rounding=True)
    np.testing.assert_array_equal(
        got[desc], np.asarray(jext.smoothed_intensity_u8(*args, **kw))[desc])
    ms = np.asarray(smoothed_intensity_patch_ms(
        *args, patch_sizes=((32, 128), (64, 128), (128, 128)), **kw))
    np.testing.assert_array_equal(got[desc], ms[desc])
    v2 = port(False)
    differ = got != v2
    assert differ[desc].any(), "v1 rounding changes some values"
    if pattern_scale == 0.5:
        assert (differ & small)[desc].any(), "and some on the bilinear branch"


# ---------------------------------------------------------------------------
# The facades' v1 descriptors.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def frames():
    return _frames(3)


@pytest.fixture(scope="module")
def ast_v1(frames):
    """A v1 detector and its detections of the 3 frames (port)."""
    det = BriskFeatureDetector(**AST_KW, version="v1", device="cpu")
    return det, det.detect(torch.from_numpy(frames))


def _jax_describe(img, kps, angle_exact=False, **ext_kw):
    ext = jext.BriskExtractor(angle_exact=angle_exact, **ext_kw)
    with jax.enable_x64(angle_exact):
        return ext(jnp.asarray(img), _to_jax(kps))


@pytest.mark.parametrize("angle_exact", [False, True])
def test_ast_facade_v1_descriptors(frames, ast_v1, angle_exact):
    """``BriskFeatureDetector(version="v1").detect_and_compute`` against the
    JAX v1 extractor (v1 rounding) on the same detections."""
    det, kps = ast_v1
    if angle_exact:
        det = BriskFeatureDetector(**AST_KW, version="v1", angle_exact=True, device="cpu")
    got_kps, desc = det.detect_and_compute(torch.from_numpy(frames[0]))
    one = kps.map(lambda a: a[0])
    ref_kps, ref_desc = _jax_describe(frames[0], one, angle_exact, version="v1")
    assert desc.shape == (one.capacity, 16) and det.descriptor_bytes == 64
    _same_kps(got_kps, ref_kps, "bits" if angle_exact else "close")
    _same(desc, np.asarray(ref_desc).view(np.int32), "descriptors")
    assert int(got_kps.valid.sum()) > 30


def test_harris_feature_v1_descriptors(frames):
    """``BriskFeature(version="v1")``: Harris detections, v1 descriptors."""
    feature = BriskFeature(**HARRIS_KW, version="v1", device="cpu")
    kps = feature.detect(torch.from_numpy(frames[1]))
    got_kps, desc = feature.detect_and_compute(torch.from_numpy(frames[1]))
    ref_kps, ref_desc = _jax_describe(frames[1], kps, version="v1")
    _same_kps(got_kps, ref_kps, "close")
    _same(desc, np.asarray(ref_desc).view(np.int32), "descriptors")
    # The v1 ring's border (size_list) is wider than v2's: few describable here.
    assert int(got_kps.valid.sum()) >= 5 and desc.shape[1] == 16


def test_pattern_file_turns_v1_rounding_off(frames, ast_v1, tmp_path):
    """A pattern file overrides ``version`` and turns v1 rounding off, as in
    the JAX extractor; the same file under v2 describes the same."""
    path = _write_ptn(tmp_path / "v2.ptn")
    one = ast_v1[1].map(lambda a: a[0])
    ext = BriskExtractor(version="v1", pattern_file=path, device="cpu")
    assert not ext.v1_rounding and ext.descriptor_bytes == 48
    got_kps, desc = ext(torch.from_numpy(frames[0]), one)
    ref_kps, ref_desc = _jax_describe(frames[0], one, version="v1", pattern_file=path)
    _same_kps(got_kps, ref_kps, "close")
    _same(desc, np.asarray(ref_desc).view(np.int32), "descriptors")
    v2_kps, v2_desc = BriskExtractor(pattern_file=path, device="cpu")(
        torch.from_numpy(frames[0]), one)
    assert torch.equal(desc, v2_desc)
    default = BriskExtractor(device="cpu")(torch.from_numpy(frames[0]), one)[1]
    assert torch.equal(desc, default), "the file holds the v2 pattern"


# ---------------------------------------------------------------------------
# The batched steps with a v1 detector.
# ---------------------------------------------------------------------------
def test_ast_step_v1_rounds_as_v2_and_matches_512_bits(frames, ast_v1):
    """``AstFramePipeline`` with a v1 detector against the JAX step's
    describe and match on the same detections: ``extract_descriptors_compact``
    with the step's keywords (no ``v1_rounding``) and ``_match_adjacent``
    (all 512 bits, sentinel 513). The facade rounds as v1, so its
    descriptors differ somewhere."""
    det, kps = ast_v1
    cap = 120
    pipe = AstFramePipeline(det, device="cpu", describe_capacity=cap)
    got = pipe.step(torch.from_numpy(frames))
    jkps, jdesc = jext.extract_descriptors_compact(
        jext.DevicePattern.from_host(jpat.brisk_v1_pattern(1.0)), jnp.asarray(frames),
        _to_jax(kps), capacity=cap * 3, sampler="gather", skip_small=True)
    jmidx, jmdist = _match_adjacent(jkps, jdesc)
    _same_kps(got[0], jkps, "close")
    _same(got[1], np.asarray(jdesc).view(np.int32), "descriptors")
    _same(got[2], jmidx, "match_idx")
    _same(got[3], jmdist, "match_dist")
    valid = got[0].valid
    assert torch.equal(got[3] == 513, ~valid[1:]) and int(got[3].max()) == 513
    from ethzasl_brisk_tpu_torch.match.matcher import match_adjacent

    d384 = match_adjacent(got[1], valid)[1]
    assert not torch.equal(d384[valid[1:]], got[3][valid[1:]]), "the match counts all 512 bits"
    facade = det.compute(torch.from_numpy(frames), kps)[1]
    assert not torch.equal(facade[valid], got[1][valid]), "the step rounds as v2"
    v2 = BriskFeatureDetector(**AST_KW, device="cpu")
    v2_desc = AstFramePipeline(v2, device="cpu", describe_capacity=cap).step(
        torch.from_numpy(frames))[1]
    assert v2_desc.shape[-1] == 12


def test_harris_step_v1(frames):
    """``FramePipeline`` with a v1 feature against the JAX ``_pipeline_step``'s
    describe and match on the same detections: v2 rounding, and a 384-bit
    match (sentinel 385) over the 16-word descriptors."""
    feature = BriskFeature(**HARRIS_KW, version="v1", describe_capacity=48, device="cpu")
    got = FramePipeline(feature, device="cpu").step(torch.from_numpy(frames))
    kps = feature.detect(torch.from_numpy(frames))
    jkps, jdesc = jext.extract_descriptors_compact(
        jext.DevicePattern.from_host(jpat.brisk_v1_pattern(1.0)), jnp.asarray(frames),
        _to_jax(kps), capacity=48 * 3, sampler="gather", skip_small=True)

    def match_pair(qd, td, qvd, tvd):  # _pipeline_step's match (frames.py:256-264)
        d = jnp.where(tvd[None, :], jax_hamming(qd, td), 385)
        return jnp.argmin(d, axis=1).astype(jnp.int32), jnp.where(qvd, jnp.min(d, axis=1), 385)

    jmidx, jmdist = jax.vmap(match_pair)(jdesc[1:], jdesc[:-1], jkps.valid[1:], jkps.valid[:-1])
    _same_kps(got[0], jkps, "close")
    _same(got[1], np.asarray(jdesc).view(np.int32), "descriptors")
    _same(got[2], jmidx, "match_idx")
    _same(got[3], jmdist, "match_dist")
    assert int(got[3].max()) == 385 and got[1].shape[-1] == 16


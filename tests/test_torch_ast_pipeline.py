"""Port parity: ``BriskFeatureDetector``, ``compute_scale`` and
``AstFramePipeline`` against the JAX package.

Three 96 x 128 smoothed-noise frames, threshold 40, octaves 2, under
``jax.enable_x64(True)``. The jitted JAX step's detection float tails
differ from the reference's (XLA:CPU contracts jitted float chains into
fused multiply-adds; ROADMAP's contract), so the reference assembles the
step's own functions: ``BriskFeatureDetector.detect`` on each frame (what
the step vmaps) run op by op, as it runs under ``jax.disable_jit()``, then
``extract_descriptors_compact`` with the step's keywords and
``_match_adjacent`` jitted, as in the step (their outputs are integers
and the angle). The step's sampler ``patch_pallas`` falls back to
``patch_ms`` off the TPU; its patches are set to the frame height (a
patch larger than the frame reads wrong taps, ROADMAP Queue 3 item 1).

Tolerances: keypoints, descriptors, matches and the valid slots' angles
bit for bit (the port takes JAX's float32 ``atan2`` and the chain XLA:CPU
compiles, as on the Harris path, ``tests/test_torch_pipeline.py``). With
``angle_exact=True`` (the host's double ``atan2``) the facade's angles are
bit for bit too. The ``angle`` of slots that leave describe invalid lies
outside parity (``_describe_core``).
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.describe.extractor import (  # noqa: E402
    BriskExtractor as JaxBriskExtractor,
    extract_descriptors_compact as jax_compact,
)
from ethzasl_brisk_tpu.parallel.frames import _match_adjacent  # noqa: E402
from ethzasl_brisk_tpu.pipeline import (  # noqa: E402
    BriskFeatureDetector as JaxBriskFeatureDetector,
    compute_scale as jax_compute_scale,
)
from ethzasl_brisk_tpu_torch import (  # noqa: E402
    AstFramePipeline,
    BriskFeatureDetector,
    KeyPoints,
    compute_scale,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port on one thread here: tier-1 runs six workers on few cores,
    and the JAX reference's compiles take the rest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("x", "y", "size", "angle", "response", "octave", "valid")
KW = dict(threshold=40, octaves=2, max_candidates_per_layer=2048)
PATCH = 96
# bench.py's AST detector and pipeline keywords (bench.py:522-556, :590-602).
BENCH_DETECTOR = dict(threshold=70, octaves=3,
                      max_candidates_per_layer=(512, 384, 320, 160, 96, 48),
                      raw_cache_model="emulated", detect_impl="dense")
BENCH_PIPELINE = dict(sampler="patch_pallas", describe_capacity=384)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, ref, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_array_equal(_bits(got), _bits(ref.astype(got.dtype)), err_msg=what)


def _same_kps(got, ref):
    """Every field bitwise; ``angle`` on valid slots only."""
    valid = np.asarray(ref.valid)
    for f in FIELDS:
        if f == "angle":
            _same(got.angle.numpy()[valid], np.asarray(ref.angle)[valid], "angle")
        else:
            _same(getattr(got, f), getattr(ref, f), f)


@pytest.fixture(scope="module")
def frames():
    base = np.random.default_rng(21).integers(0, 256, (3, 96, 128)).astype(np.float32)
    return np.clip(ndimage.convolve(base, np.ones((1, 3, 3)) / 9.0, mode="nearest"),
                   0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_detector():
    return JaxBriskFeatureDetector(**KW)


@pytest.fixture(scope="module")
def jax_det(frames, jax_detector):
    """The JAX detection of each frame, op by op, stacked."""
    with jax.enable_x64(True):
        dets = [jax_detector.detect(jnp.asarray(f)) for f in frames]
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *dets)


def _jax_step(frames, jax_detector, det, describe_capacity):
    def describe(pattern, imgs, kps):
        return jax_compact(
            pattern, imgs, kps, capacity=describe_capacity * frames.shape[0],
            rotation_invariant=True, scale_invariant=True, sampler="patch_pallas",
            patch_h=PATCH, patch_w=PATCH, skip_small=jax_detector.extractor.skip_small)

    with jax.enable_x64(True):
        kps, desc = jax.jit(describe)(jax_detector.extractor.pattern, jnp.asarray(frames), det)
        midx, mdist = jax.jit(_match_adjacent)(kps, desc)
    return kps, desc, midx, mdist


@pytest.mark.parametrize("describe_capacity", [200, 40])
def test_ast_frame_pipeline_step(frames, jax_detector, jax_det, describe_capacity):
    """The step, with a budget that covers the describable keypoints and one
    that truncates (``describable`` > budget)."""
    ref = _jax_step(frames, jax_detector, jax_det, describe_capacity)
    pipe = AstFramePipeline(BriskFeatureDetector(**KW, device="cpu"), device="cpu",
                            patch_h=PATCH, patch_w=PATCH, describe_capacity=describe_capacity)
    kps, desc, midx, mdist, diag = pipe.step(torch.from_numpy(frames), with_diagnostics=True)
    _same_kps(kps, ref[0])
    _same(desc, np.asarray(ref[1]).view(np.int32), "descriptors")
    _same(midx, ref[2], "match_idx")
    _same(mdist, ref[3], "match_dist")
    assert bool(diag["detect"].ok.all())
    n_desc = int(diag["describable"])
    assert (n_desc > 3 * describe_capacity) == (describe_capacity == 40)
    assert int(kps.valid.sum()) == min(n_desc, 3 * describe_capacity)


def test_describe_capacity_zero_equals_compact(frames):
    """describe_capacity=0 describes every slot; a covering budget gives the
    same valid keypoints and descriptors (tests/test_ast_parity.py:171)."""
    det = BriskFeatureDetector(**KW, device="cpu")
    a = AstFramePipeline(det, device="cpu", describe_capacity=0).step(torch.from_numpy(frames))
    b = AstFramePipeline(det, device="cpu", describe_capacity=1024).step(torch.from_numpy(frames))
    va, vb = a[0].valid, b[0].valid
    assert torch.equal(va, vb) and int(va.sum()) > 100
    assert torch.equal(a[1][va], b[1][vb])
    for f in FIELDS:
        assert torch.equal(getattr(a[0], f)[va], getattr(b[0], f)[vb]), f


def test_step_marks_every_stage(frames):
    seen = []
    pipe = AstFramePipeline(BriskFeatureDetector(**KW, device="cpu"), device="cpu")
    pipe.step(torch.from_numpy(frames), mark=seen.append)
    assert seen == ["pyramid", "layers", "candidates", "pass1", "aux", "pass2", "describe",
                    "match"]


def test_detect_and_compute_angle_exact(frames, jax_det):
    """The facade on one (H, W) image with ``angle_exact``: every field and
    descriptor bit for bit against the JAX detection described by the JAX
    extractor with the same knob (its patch sampler, as the step's)."""
    det = BriskFeatureDetector(**KW, angle_exact=True, device="cpu")
    kps, desc = det.detect_and_compute(torch.from_numpy(frames[0]))
    assert kps.x.shape == (4 * 2048,) and desc.shape == (4 * 2048, 12)
    ext = JaxBriskExtractor(angle_exact=True, sampler="patch_ms", patch_h=PATCH, patch_w=PATCH)
    with jax.enable_x64(True):
        one = jax.tree_util.tree_map(lambda a: a[0], jax_det)
        ref_kps, ref_desc = ext(jnp.asarray(frames[0]), one)
    _same_kps(kps, ref_kps)
    _same(desc, np.asarray(ref_desc).view(np.int32), "descriptors")
    assert int(kps.valid.sum()) > 50


def test_detect_single_image_and_diagnostics(frames, jax_det):
    det = BriskFeatureDetector(**KW, device="cpu")
    kps, diag = det.detect_with_diagnostics(torch.from_numpy(frames[1]))
    one = jax.tree_util.tree_map(lambda a: a[1], jax_det)
    _same_kps(kps, one)
    assert diag.ok.dim() == 0 and bool(diag.ok) and diag.corner_counts.shape == (4,)
    batch = det.detect(torch.from_numpy(frames))
    assert torch.equal(batch.x[1], kps.x) and batch.x.shape == (3, 4 * 2048)


def test_compute_scale_bitwise(frames, jax_det, jax_detector):
    """ComputeScale on frame 0's valid keypoints, carried in through
    ``KeyPoints.from_numpy`` on both sides (2048 slots)."""
    v = np.asarray(jax_det.valid[0])
    cols = {f: np.asarray(getattr(jax_det, f)[0])[v] for f in ("x", "y", "size")}
    with jax.enable_x64(True):
        ref = jax_compute_scale(jax_detector, jnp.asarray(frames[0]),
                                JaxKeyPoints.from_numpy(**cols, capacity=2048))
    det = BriskFeatureDetector(**KW, device="cpu")
    got = compute_scale(det, torch.from_numpy(frames[0]),
                        KeyPoints.from_numpy(**cols, capacity=2048, device="cpu"))
    _same_kps(got, ref)
    assert got.x.shape == (4 * 2048,) and int(got.valid.sum()) >= int(v.sum()) // 2


def test_bench_keywords_build_a_port_detector(frames):
    """bench.py's AST keywords build a port detector and pipeline as they
    are; ``dense`` runs the candidates engine (the JAX package holds the two
    bitwise equal, tests/test_ast_dense.py)."""
    det = BriskFeatureDetector(**BENCH_DETECTOR, device="cpu")
    pipe = AstFramePipeline(det, device="cpu", **BENCH_PIPELINE)
    cand = BriskFeatureDetector(**dict(BENCH_DETECTOR, detect_impl="candidates"), device="cpu")
    a, b = det.detect(torch.from_numpy(frames)), cand.detect(torch.from_numpy(frames))
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert pipe.describe_capacity == 384 and det.descriptor_bytes == 48


@pytest.mark.parametrize("kw,exc", [
    (dict(detect_impl="sparse"), ValueError),
    (dict(raw_cache_model="fresh"), ValueError),
    (dict(detect_impl="dense", raw_cache_model="exact"), ValueError),
    (dict(detect_impl="dense", suppress_scale_nonmaxima=False), ValueError),
    (dict(eager_exact="yes"), ValueError),
    (dict(version="V1"), ValueError),
    (dict(version="v3"), ValueError),
])
def test_detector_rejects_bad_selectors(kw, exc):
    with pytest.raises(exc):
        BriskFeatureDetector(**kw, device="cpu")


def test_pipeline_rejects_bad_selectors_and_devices():
    det = BriskFeatureDetector(device="cpu")
    with pytest.raises(ValueError, match="sampler"):
        AstFramePipeline(det, device="cpu", sampler="bogus")
    with pytest.raises(ValueError, match="patch_h"):
        AstFramePipeline(det, device="cpu", patch_h=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AstFramePipeline(det)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BriskFeatureDetector()

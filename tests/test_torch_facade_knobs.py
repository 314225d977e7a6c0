"""Port parity: the facade's leftovers against the JAX package.

``KeyPoints.empty``/``to_numpy``/``from_numpy``, the golden-set reader and
writer (``core/golden.py``), ``refine_dtype="float64"`` (end to end at
octaves 0, and the refine tail with every layer's scale and offset),
``angle_exact``,
``descriptor_bytes`` and the JAX-only selectors, which the port takes as
checked no-ops (bench.py's keywords build a port feature; a value the JAX
package does not name raises; ``version="v1"`` builds the v1 engine).

The golden round trip: the JAX package detects and describes two 96 x 128
frames with the parity knobs of ``tools/parity.py`` (refine float64,
``angle_exact``, ``eager_exact``, under ``jax.enable_x64(True)``) and
writes them with its ``write_set``; the port reads that set with its own
``read_set``, reproduces every keypoint bit for bit and every descriptor
byte with the same knobs, and its ``write_set`` writes the same bytes.
Tolerance everywhere: bit for bit (the angle of slots that leave describe
invalid lies outside parity; see ``_describe_core``).
"""
import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core import golden as jgolden  # noqa: E402
from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.detect import scale_space as jss  # noqa: E402
from ethzasl_brisk_tpu.pipeline import BriskFeature as JaxBriskFeature  # noqa: E402
from ethzasl_brisk_tpu_torch import BriskFeature, KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch.core import golden  # noqa: E402
from ethzasl_brisk_tpu_torch.describe.extractor import BriskExtractor  # noqa: E402
from ethzasl_brisk_tpu_torch.detect import scale_space as tss  # noqa: E402
from ethzasl_brisk_tpu_torch.detect.refine import refine_fused  # noqa: E402
from ethzasl_brisk_tpu_torch.detect.scale_space import DetectorConfig  # noqa: E402
from ethzasl_brisk_tpu_torch.frames import bench_frames  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = ("x", "y", "size", "angle", "response", "octave", "valid")
PARITY = dict(octaves=0, uniformity_radius=10.0, absolute_threshold=20.0,
              max_candidates=2048, max_keypoints=512, refine_dtype="float64",
              angle_exact=True)
# bench.py's BriskFeature keywords (bench.py:99-158) at their defaults.
BENCH_KEYWORDS = dict(
    octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
    max_candidates=(7168, 3072, 1792, 1024), max_keypoints=1024,
    sampler="patch_pallas", patch_h=128, patch_w=128, topk_impl="block",
    topk_block_size=2048, topk_block_r=96, uniformity_block=256,
    refine_capacity=(352, 160, 96, 56), fused_mask=False, describe_capacity=448,
)


def _bits_equal(got, ref, err_msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (err_msg, got.dtype, ref.dtype)
    if got.dtype.kind == "f":
        got, ref = got.view(np.int32), ref.view(np.int32)
    np.testing.assert_array_equal(got, ref, err_msg=err_msg)


@pytest.mark.parametrize("n,cap,given", [
    (10, None, ("y", "size", "angle", "response", "octave")),
    (7, 12, ("y",)),
    (15, 9, ("y", "size", "angle")),
], ids=["full", "padded", "truncated"])
def test_keypoints_numpy_round_trip_matches_jax(n, cap, given):
    rng = np.random.default_rng(n)
    cols = dict(x=rng.uniform(0, 100, n), y=rng.uniform(0, 80, n), size=rng.uniform(8, 40, n),
                angle=rng.uniform(-180, 180, n), response=rng.uniform(0, 1e4, n),
                octave=rng.integers(0, 3, n))
    kw = {name: cols[name] for name in given}
    got = KeyPoints.from_numpy(cols["x"], capacity=cap, device="cpu", **kw)
    ref = JaxKeyPoints.from_numpy(cols["x"], capacity=cap, **kw)
    for name in FIELDS:
        _bits_equal(getattr(got, name).numpy(), getattr(ref, name), name)
    g, r = got.to_numpy(), ref.to_numpy()
    assert set(g) == set(r) == set(FIELDS) - {"valid"}
    for name in r:
        _bits_equal(g[name], r[name], name)
    assert len(g["x"]) == min(n, cap or n)
    empty, jempty = KeyPoints.empty(cap or n, device="cpu"), JaxKeyPoints.empty(cap or n)
    for name in FIELDS:
        _bits_equal(getattr(empty, name).numpy(), getattr(jempty, name), name)
    assert all(len(v) == 0 for v in empty.to_numpy().values())


@pytest.fixture(scope="module")
def golden_pair(tmp_path_factory):
    """The JAX package's parity run on two frames, written as a set."""
    frames = bench_frames(2, 96, 128, seed=5)
    entries = []
    with jax.enable_x64(True):
        jf = JaxBriskFeature(**PARITY, eager_exact=True)
        outs = [jf.detect_and_compute(jnp.asarray(f)) for f in frames]
        outs = [(jax.tree.map(np.asarray, k), np.asarray(d)) for k, d in outs]
    for i, (frame, (kps, desc)) in enumerate(zip(frames, outs)):
        host = kps.to_numpy()
        entries.append(jgolden.GoldenEntry(
            path=f"frame{i}.pgm", image=frame,
            keypoints=[jgolden.GoldenKeyPoint(float(a), -1, int(o), float(x), float(y),
                                              float(r), float(s))
                       for a, o, x, y, r, s in zip(host["angle"], host["octave"], host["x"],
                                                   host["y"], host["response"], host["size"])],
            descriptors=desc[kps.valid].view(np.uint8).reshape(int(kps.valid.sum()), -1),
            userdata={"config": b"parity"},
        ))
    path = tmp_path_factory.mktemp("golden") / "jax.set"
    jgolden.write_set(str(path), entries)
    return path, outs


def test_golden_round_trip(golden_pair, tmp_path):
    path, _ = golden_pair
    entries = golden.read_set(str(path))
    assert [e.path for e in entries] == ["frame0.pgm", "frame1.pgm"]
    feature = BriskFeature(**PARITY, device="cpu")
    mine = []
    for e in entries:
        kps, desc = feature.detect_and_compute(torch.from_numpy(e.image))
        host = kps.to_numpy()
        want = e.keypoint_array()  # x y size angle response octave class_id
        assert len(want) == len(host["x"]) > 20
        for col, name in enumerate(("x", "y", "size", "angle", "response")):
            _bits_equal(host[name], want[:, col].astype(np.float32), name)
        np.testing.assert_array_equal(host["octave"], want[:, 5].astype(np.int32))
        got = golden.descriptor_bytes(desc, kps.valid)
        assert got.shape == e.descriptors.shape == (len(want), feature.descriptor_bytes)
        np.testing.assert_array_equal(got, e.descriptors)
        mine.append(golden.golden_entry(e.path, e.image, kps, desc, e.userdata))
    golden.write_set(str(tmp_path / "port.set"), mine)
    assert (tmp_path / "port.set").read_bytes() == path.read_bytes()


def test_refine_float64_and_angle_exact_match_jax(golden_pair):
    """Every slot of both frames: all fields bit for bit (angle on valid
    slots), and the float32 chain is not what was compared."""
    _, outs = golden_pair
    feature = BriskFeature(**PARITY, device="cpu")
    plain = BriskFeature(**dict(PARITY, refine_dtype="float32", angle_exact=False), device="cpu")
    differs = 0
    for frame, (jkp, jdesc) in zip(bench_frames(2, 96, 128, seed=5), outs):
        kps, desc = feature.detect_and_compute(torch.from_numpy(frame))
        valid = jkp.valid
        for name in ("x", "y", "size", "response", "octave", "valid"):
            _bits_equal(getattr(kps, name).numpy(), getattr(jkp, name), name)
        _bits_equal(kps.angle.numpy()[valid], jkp.angle[valid], "angle")
        np.testing.assert_array_equal(desc.numpy(), jdesc.view(np.int32))
        k32, _ = plain.detect_and_compute(torch.from_numpy(frame))
        differs += int((k32.x != kps.x).sum() + (k32.y != kps.y).sum()
                       + (k32.angle != kps.angle)[kps.valid].sum())
    assert differs > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_refine_tail_matches_jax_on_every_layer(dtype):
    """The sub-pixel tail with each layer's scale and offset, on random
    integer score maps of four pyramid layers (the JAX tail run eagerly;
    float64 under ``jax.enable_x64(True)``)."""
    rng = np.random.default_rng(2)
    shapes, cap = [(40, 52), (26, 34), (20, 26), (13, 17)], 64
    scores = [rng.integers(-2**29, 2**30, s).astype(np.int32) for s in shapes]
    comp = []
    for h, w in shapes:
        xs, ys = rng.integers(0, w, cap).astype(np.int32), rng.integers(0, h, cap).astype(np.int32)
        comp.append((xs, ys, rng.integers(0, 2**30, cap).astype(np.int32),
                     np.ones(cap, bool), rng.random(cap) < 0.8))
    geoms = [jss.layer_geometry(i) for i in range(4)]
    with jax.enable_x64(dtype == "float64"):
        ref = jss._refine_keypoints_fused(
            [jnp.asarray(sc) for sc in scores], [tuple(jnp.asarray(c) for c in t) for t in comp],
            geoms, jss.DetectorConfig(refine_dtype=dtype))
        ref = jax.tree.map(np.asarray, ref)
    got = refine_fused(
        [torch.from_numpy(sc)[None] for sc in scores],
        [tuple(torch.from_numpy(c)[None] for c in t) for t in comp],
        [tss.layer_geometry(i) for i in range(4)], tss.REFINE_DTYPES[dtype])
    for name in FIELDS:
        _bits_equal(getattr(got, name)[0].numpy(), getattr(ref, name), name)


def test_compute_from_numpy_keypoints_matches_jax():
    """Caller keypoints handed in through from_numpy, with and without
    preset angles."""
    frame = bench_frames(1, 96, 128, seed=9)[0]
    rng = np.random.default_rng(9)
    n = 40
    # Mostly inside the pattern border, a few outside.
    x, y = rng.uniform(16, 112, n), rng.uniform(16, 80, n)
    size = rng.uniform(8, 16, n)
    angle = np.where(rng.random(n) < 0.5, rng.uniform(-180, 180, n), -1.0)
    feature = BriskFeature(angle_exact=True, device="cpu")
    jf = JaxBriskFeature(angle_exact=True)
    got_kp, got = feature.compute(torch.from_numpy(frame),
                                  KeyPoints.from_numpy(x, y, size, angle, capacity=48,
                                                       device="cpu"))
    ref_kp, ref = jf.compute(jnp.asarray(frame),
                             JaxKeyPoints.from_numpy(x, y, size, angle, capacity=48))
    valid = np.asarray(ref_kp.valid)
    for name in ("x", "y", "size", "response", "octave", "valid"):
        _bits_equal(getattr(got_kp, name).numpy(), getattr(ref_kp, name), name)
    _bits_equal(got_kp.angle.numpy()[valid], np.asarray(ref_kp.angle)[valid], "angle")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).view(np.int32))
    assert valid.sum() > 10


def test_bench_keywords_build_a_port_feature():
    """Every keyword bench.py passes is a port keyword; its literal set
    builds a feature whose outputs equal the default selectors'."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    calls = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "BriskFeature"]
    names = {k.arg for c in calls for k in c.keywords}
    assert names == set(BENCH_KEYWORDS)
    assert names <= set(inspect.signature(BriskFeature).parameters)

    feature = BriskFeature(**BENCH_KEYWORDS, device="cpu")
    assert feature.descriptor_bytes == JaxBriskFeature(**BENCH_KEYWORDS).descriptor_bytes == 48
    plain = {k: v for k, v in BENCH_KEYWORDS.items()
             if k not in ("sampler", "patch_h", "patch_w", "topk_impl", "topk_block_size",
                          "topk_block_r")}
    assert feature.config == BriskFeature(**plain, device="cpu").config
    frames = torch.from_numpy(bench_frames(2, 96, 128, seed=3))
    kps, diag = feature.detect_with_diagnostics(frames)
    # The JAX block top-k can certify itself inexact; the port's sort cannot be.
    assert bool(diag.topk_exact.all())
    ref = BriskFeature(**plain, device="cpu").detect_and_compute(frames)
    for a, b in zip(feature.detect_and_compute(frames)[0].fields(), ref[0].fields()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,value", [
    ("sampler", "gather"), ("sampler", "patch"), ("sampler", "patch_ms"),
    ("topk_impl", "sort"), ("topk_impl", "select"), ("topk_impl", "compact"),
    ("eager_exact", True), ("refine_dtype", "float32"), ("version", "v2"),
])
def test_accepted_selectors_change_nothing(name, value):
    feature = BriskFeature(**{name: value}, device="cpu")
    assert feature.config == BriskFeature(device="cpu").config
    JaxBriskFeature(**{name: value})  # the JAX package takes it too


@pytest.mark.parametrize("name,value", [
    ("sampler", "mxu"), ("topk_impl", "heap"), ("patch_h", 0), ("patch_w", -128),
    ("topk_block_size", 0), ("topk_block_r", 2.5), ("eager_exact", "yes"),
    ("refine_dtype", "float16"), ("version", "v3"),
])
def test_rejected_selector_raises(name, value):
    with pytest.raises(ValueError, match=name if name != "refine_dtype" else "refine"):
        BriskFeature(**{name: value}, device="cpu")
    if name in ("sampler", "patch_h", "patch_w", "version"):
        with pytest.raises(ValueError):
            BriskExtractor(**{name: value}, device="cpu")
    if name == "refine_dtype":
        with pytest.raises(ValueError):
            DetectorConfig(refine_dtype=value)


@pytest.mark.parametrize("build", [
    lambda: BriskFeature(version="v1", device="cpu"),
    lambda: BriskExtractor(version="v1", device="cpu"),
    lambda: BriskExtractor(pattern_file="brisk.ptn", device="cpu"),
], ids=["feature", "extractor", "pattern_file"])
def test_v1_raises_not_implemented(build):
    """The v1 engine and pattern files are ported now (the test keeps the
    name it had while they raised): a v1 feature or extractor describes
    with 64-byte descriptors and v1 rounding; a pattern file is read at
    build time, so a missing one raises ``FileNotFoundError``."""
    try:
        made = build()
    except FileNotFoundError:
        return
    ext = getattr(made, "extractor", made)
    assert ext.descriptor_bytes == 64 and ext.v1_rounding

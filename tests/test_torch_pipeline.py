"""Port parity: pattern tables, uniformity, keypoints, matching and the
whole FramePipeline.step against the JAX package.

The step runs 3 frames of 120x160 through the bench configuration with
its capacities scaled down. The JAX reference is its ``_pipeline_step``
assembled with detection run eagerly, frame by frame (as
``BriskFeature(eager_exact=True)`` runs it: jitted XLA:CPU may
FMA-contract the sub-pixel float chain), and the reference-exact
``gather`` sampler (the patch samplers need frames taller than their
128-row patch).

Tolerances: integer outputs and descriptors are bit for bit; x/y within
1 ULP, the bar the JAX package's TPU-vs-CPU parity uses (NOTES round 4);
the angle of every valid slot bit for bit (the port takes JAX's float32
``atan2``, ``core/atan2f.py``).
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_tpu.core.keypoints import KeyPoints as JaxKeyPoints  # noqa: E402
from ethzasl_brisk_tpu.core.pattern import brisk_v2_pattern as jax_v2_pattern  # noqa: E402
from ethzasl_brisk_tpu.describe.extractor import (  # noqa: E402
    DevicePattern as JaxDevicePattern,
    extract_descriptors_compact as jax_describe,
)
from ethzasl_brisk_tpu.detect import scale_space as jss  # noqa: E402
from ethzasl_brisk_tpu.describe.extractor import (  # noqa: E402
    describable_count as jax_describable_count,
)
from ethzasl_brisk_tpu.detect.uniformity import (  # noqa: E402
    bucket_keypoints as jax_bucket_keypoints,
    enforce_uniformity_sequential as jax_uniformity_sequential,
)
from ethzasl_brisk_tpu.match.matcher import hamming_distance_matrix_popcnt  # noqa: E402
from ethzasl_brisk_tpu.parallel.frames import _match_adjacent  # noqa: E402
from ethzasl_brisk_tpu.pipeline import BriskFeature as JaxBriskFeature  # noqa: E402
from ethzasl_brisk_tpu_torch import BriskFeature, FramePipeline, KeyPoints  # noqa: E402
from ethzasl_brisk_tpu_torch.core.pattern import brisk_v2_pattern  # noqa: E402
from ethzasl_brisk_tpu_torch.describe.extractor import (  # noqa: E402
    PATTERN_FIELDS,
    DevicePattern,
    describable_count,
    pattern_from_numpy,
)
from ethzasl_brisk_tpu_torch.detect import scale_space as tss  # noqa: E402
from ethzasl_brisk_tpu_torch.detect.uniformity import (  # noqa: E402
    bucket_keypoints,
    enforce_uniformity,
    enforce_uniformity_sequential,
)
from ethzasl_brisk_tpu_torch.frames import bench_frames  # noqa: E402
from ethzasl_brisk_tpu_torch.match.matcher import hamming_distance_matrix  # noqa: E402

# The bench configuration (bench.py:88-158) with capacities cut for 120x160.
CONFIG = dict(
    octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
    max_candidates=(704, 256, 192, 96), max_keypoints=128,
    refine_capacity=(64, 32, 24, 16),
)
DESCRIBE_CAP = 48


def _assert_ulp(a, b, ulps=1):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    gap = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    assert gap.max(initial=0) <= ulps, gap.max()


def test_pattern_tables_bit_equal():
    jpat = JaxDevicePattern.from_host(jax_v2_pattern())
    carried = pattern_from_numpy({f: np.asarray(getattr(jpat, f)) for f in PATTERN_FIELDS})
    built = DevicePattern.from_host(brisk_v2_pattern())
    for f in PATTERN_FIELDS:
        ref = np.asarray(getattr(jpat, f))
        for pat in (carried, built):
            got = getattr(pat, f).numpy()
            assert got.shape == ref.shape, f
            np.testing.assert_array_equal(got.astype(ref.dtype), ref, err_msg=f)
            if ref.dtype == np.float32:
                np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert built.descriptor_words == jpat.descriptor_words == 12


@pytest.mark.parametrize("seed,radius,cap,block", [
    (0, 30.0, 10**6, 256), (1, 30.0, 40, 64), (2, 12.0, 10**6, 32),
])
def test_uniformity_matches_sequential(seed, radius, cap, block):
    rng = np.random.default_rng(seed)
    n, k, rows, cols = 3, 700, 120, 160
    xs = rng.integers(0, cols, (n, k)).astype(np.int32)
    ys = rng.integers(0, rows, (n, k)).astype(np.int32)
    scores = -np.sort(-rng.integers(20, 5000, (n, k)), axis=1).astype(np.int32)
    valid = np.arange(k)[None, :] < np.array([[650], [700], [300]])
    scores = np.where(valid, scores, np.iinfo(np.int32).min)
    got = enforce_uniformity(
        torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(scores),
        torch.from_numpy(valid), radius=radius, max_num_kpt=cap, block=block,
    ).numpy()
    for r in range(n):
        kw = dict(rows=rows, cols=cols, radius=radius, max_num_kpt=cap)
        ref = np.asarray(jax_uniformity_sequential(
            jnp.asarray(xs[r]), jnp.asarray(ys[r]), jnp.asarray(scores[r]),
            jnp.asarray(valid[r]), **kw,
        ))
        np.testing.assert_array_equal(got[r], ref)
        oracle = enforce_uniformity_sequential(
            torch.from_numpy(xs[r]), torch.from_numpy(ys[r]),
            torch.from_numpy(scores[r]), torch.from_numpy(valid[r]), **kw,
        ).numpy()
        np.testing.assert_array_equal(oracle, ref)
        assert 0 < ref.sum() < valid[r].sum()


def test_single_bucket_matches_jax():
    """The uniformity_radius == 0 path: keep the first max_num_kpt valid."""
    rng = np.random.default_rng(3)
    valid = rng.random(300) < 0.6
    zeros = np.zeros(300, np.int32)
    ref = jax_bucket_keypoints(
        jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(valid), rows=1, cols=1,
        max_num_kpt=90, num_buckets_u=1, num_buckets_v=1,
    )
    got = bucket_keypoints(torch.from_numpy(valid[None]), 90)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.sum() == 90


def test_keypoints_top_k_ties_match_jax():
    rng = np.random.default_rng(4)
    k = 64
    f = dict(
        x=rng.random(k).astype(np.float32), y=rng.random(k).astype(np.float32),
        size=np.full(k, 12.0, np.float32), angle=np.full(k, -1.0, np.float32),
        response=rng.integers(0, 5, k).astype(np.float32),  # many ties
        octave=np.zeros(k, np.int32), valid=rng.random(k) < 0.7,
    )
    got = KeyPoints(**{n: torch.from_numpy(v) for n, v in f.items()}).top_k(20)
    ref = JaxKeyPoints(**{n: jnp.asarray(v) for n, v in f.items()}).top_k(20)
    for name in f:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))


def test_hamming_matches_popcount():
    rng = np.random.default_rng(5)
    q = rng.integers(0, 2**32, (33, 12), dtype=np.uint64).astype(np.uint32)
    t = rng.integers(0, 2**32, (41, 12), dtype=np.uint64).astype(np.uint32)
    got = hamming_distance_matrix(torch.from_numpy(q.view(np.int32)), torch.from_numpy(t.view(np.int32)))
    ref = hamming_distance_matrix_popcnt(jnp.asarray(q), jnp.asarray(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def step_pair():
    """(port outputs, JAX outputs) of one step on the same 3 frames."""
    frames = bench_frames(3, 120, 160)
    jf = JaxBriskFeature(**CONFIG)
    # The pattern tables travel from the JAX package as numpy arrays.
    carried = pattern_from_numpy(
        {f: np.asarray(getattr(jf.extractor.pattern, f)) for f in PATTERN_FIELDS}
    )
    feature = BriskFeature(**CONFIG, describe_capacity=DESCRIBE_CAP, pattern=carried,
                           device="cpu")
    port = FramePipeline(feature, device="cpu").step(torch.from_numpy(frames), with_diagnostics=True)

    dets, diags = zip(*(jf.detect_with_diagnostics(jnp.asarray(f)) for f in frames))
    det = jax.tree.map(lambda *a: jnp.stack(a), *dets)
    diag = jax.tree.map(lambda *a: jnp.stack(a), *diags)
    jkp, jdesc, jn = jax_describe(
        jf.extractor.pattern, jnp.asarray(frames), det, capacity=DESCRIBE_CAP * 3,
        sampler="gather", skip_small=jf.extractor.skip_small, with_diagnostics=True,
    )
    jmidx, jmdist = _match_adjacent(jkp, jdesc)
    n_jax = int(jax_describable_count(jf.extractor.pattern, jnp.asarray(frames), det))
    n_port = int(describable_count(
        feature.pattern, torch.from_numpy(frames), feature.detect(torch.from_numpy(frames))
    ))
    assert n_port == n_jax == int(jn)
    return frames, port, (det, diag, jkp, jdesc, jn, jmidx, jmdist)


def test_layers_match_jax(step_pair):
    """Scores, masks, candidate lists and accept masks of frame 1."""
    frames, _, _ = step_pair
    cfg = JaxBriskFeature(**CONFIG).config
    jscores, jmasks = jss.layer_score_masks(jnp.asarray(frames[1]), cfg)
    tcfg = BriskFeature(**CONFIG, device="cpu").config
    pyr = tss.build_pyramid(torch.from_numpy(frames[1:2]), 4)
    scores, masks = tss.layer_score_masks(pyr, tcfg)
    for i in range(4):
        np.testing.assert_array_equal(scores[i][0].numpy(), np.asarray(jscores[i]))
        np.testing.assert_array_equal(masks[i][0].numpy(), np.asarray(jmasks[i]))
        jc = jss._layer_candidates(jscores[i], jmasks[i], cfg, cfg.layer_cap(i))
        tc = tss._layer_candidates(scores[i], masks[i], tcfg.layer_cap(i))
        for a, b in zip(tc, jc[:4]):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
        ja = jss._layer_accept(jc, jscores[i].shape, cfg)
        np.testing.assert_array_equal(tss._layer_accept(tc, tcfg)[0].numpy(), np.asarray(ja))


def test_step_matches_jax(step_pair):
    _, port, ref = step_pair
    kps, desc, midx, mdist, dg = port
    det, diag, jkp, jdesc, jn, jmidx, jmdist = ref

    np.testing.assert_array_equal(dg["detect"].ok.numpy(), np.asarray(diag.ok))
    np.testing.assert_array_equal(dg["detect"].cand_counts.numpy(), np.asarray(diag.cand_counts))
    np.testing.assert_array_equal(
        dg["detect"].accepted_counts.numpy(), np.asarray(diag.accepted_counts)
    )
    assert bool(dg["detect"].ok.all())
    assert int(dg["describable"]) == int(jn) <= DESCRIBE_CAP * 3

    valid = np.asarray(jkp.valid)
    assert valid.sum(axis=1).min() > 10
    np.testing.assert_array_equal(kps.valid.numpy(), valid)
    for name in ("size", "response", "octave"):
        np.testing.assert_array_equal(getattr(kps, name).numpy(), np.asarray(getattr(jkp, name)))
    for name in ("x", "y"):
        _assert_ulp(getattr(kps, name).numpy(), np.asarray(getattr(jkp, name)))
    np.testing.assert_array_equal(kps.angle.numpy()[valid].view(np.int32),
                                  np.asarray(jkp.angle)[valid].view(np.int32))
    np.testing.assert_array_equal(desc.numpy(), np.asarray(jdesc).view(np.int32))
    np.testing.assert_array_equal(midx.numpy(), np.asarray(jmidx))
    np.testing.assert_array_equal(mdist.numpy(), np.asarray(jmdist))
    assert (mdist.numpy() < 385).sum() > 10


def test_invalid_slot_angle_outside_parity():
    """The angle of a slot that leaves describe invalid is outside parity:
    the JAX samplers disagree there. On a 240 x 320 bench frame the port's
    keypoints go through JAX's ``gather`` and ``patch_ms`` samplers and the
    port's describe: valid, descriptors and every valid angle agree across
    all three, the JAX samplers' angles differ on invalid slots, and the
    port equals JAX ``gather`` on every field but the invalid slots' angle."""
    frame = bench_frames(1, 240, 320)[0]
    cfg = dict(octaves=2, uniformity_radius=30.0, absolute_threshold=20.0, max_keypoints=256)
    feature = BriskFeature(**cfg, device="cpu")
    kps = feature.detect(torch.from_numpy(frame))
    jkps = JaxKeyPoints(**{f: jnp.asarray(getattr(kps, f).numpy()) for f in
                           ("x", "y", "size", "angle", "response", "octave", "valid")})
    ref = {s: JaxBriskFeature(**cfg, sampler=s).compute(jnp.asarray(frame), jkps)
           for s in ("gather", "patch_ms")}
    port_kp, port_desc = feature.compute(torch.from_numpy(frame), kps)
    (gk, gd), (pk, pd) = ref["gather"], ref["patch_ms"]
    valid = np.asarray(gk.valid)
    assert 50 < valid.sum() < kps.valid.sum()  # describe drops some detections
    np.testing.assert_array_equal(np.asarray(pk.valid), valid)
    np.testing.assert_array_equal(np.asarray(pd), np.asarray(gd))
    np.testing.assert_array_equal(np.asarray(pk.angle)[valid], np.asarray(gk.angle)[valid])
    assert (np.asarray(pk.angle) != np.asarray(gk.angle))[~valid].sum() > 10
    # The port against JAX gather: every field on every slot but the angle.
    np.testing.assert_array_equal(port_kp.valid.numpy(), valid)
    for name in ("x", "y", "size", "response", "octave"):
        np.testing.assert_array_equal(getattr(port_kp, name).numpy().view(np.int32),
                                      np.asarray(getattr(gk, name)).view(np.int32))
    np.testing.assert_array_equal(port_kp.angle.numpy()[valid].view(np.int32),
                                  np.asarray(gk.angle)[valid].view(np.int32))
    np.testing.assert_array_equal(port_desc.numpy(), np.asarray(gd).view(np.int32))


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['ethzasl_brisk_tpu'] = None\n"
        "sys.modules['orbax'] = None\n"
        "import ethzasl_brisk_tpu_torch, ethzasl_brisk_tpu_torch.frames\n"
        "import ethzasl_brisk_tpu_torch.core.image_io, ethzasl_brisk_tpu_torch.match.matcher\n"
        # The golden-set IO and the 16-bit and parity branches' modules.
        "from ethzasl_brisk_tpu_torch.core import golden, selectors\n"
        "from ethzasl_brisk_tpu_torch.kernels import downsample, harris, integral\n"
        "from ethzasl_brisk_tpu_torch.detect import scale_space, subpixel\n"
        "from ethzasl_brisk_tpu_torch.describe import extractor\n"
        # The AST path.
        "from ethzasl_brisk_tpu_torch.kernels import agast\n"
        "from ethzasl_brisk_tpu_torch.detect import ast_exact, ast_layer, ast_scale_space\n"
        "from ethzasl_brisk_tpu_torch.parallel import frames\n"
        # The v1 engine's modules and the camera-aware path.
        "from ethzasl_brisk_tpu_torch.core import pattern\n"
        "from ethzasl_brisk_tpu_torch.describe import sampler\n"
        "from ethzasl_brisk_tpu_torch.kernels import filters\n"
        "from ethzasl_brisk_tpu_torch.geometry import cameras, camera_aware\n"
        "import ethzasl_brisk_tpu_torch.geometry\n"
        # Geometry, VO and BA.
        "from ethzasl_brisk_tpu_torch.geometry import ransac\n"
        "from ethzasl_brisk_tpu_torch.ba import pose_graph, se3, window\n"
        "from ethzasl_brisk_tpu_torch.vo import evaluate, frontend, sequence, tracks\n"
        "import ethzasl_brisk_tpu_torch.ba, ethzasl_brisk_tpu_torch.vo\n"
        "import ethzasl_brisk_tpu_torch.vo.__main__\n"
        # The utilities, the sharded layer and the examples.
        "from ethzasl_brisk_tpu_torch.utils import checkpoint, roofline, timing\n"
        "from ethzasl_brisk_tpu_torch.parallel import dist_ba, dist_pg, multihost\n"
        "from ethzasl_brisk_tpu_torch.examples import cameras_demo, draw, live_pipeline\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'ethzasl_brisk_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py runs on a card only: without one it exits non-zero
    and prints no result line."""
    import os
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py")], cwd=root, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

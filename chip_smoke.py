"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels (K1 Harris, K2 sampler, K3 Harris +
2-D maxima) from ``ethzasl_brisk_tpu_torch/csrc`` and checks each against
its plain torch version at the main path's shapes (K1 and K3 on the four
pyramid layers in one launch, and on each alone). Then it drives three
paths, each with the launch counters set to 0 just before it and read
just after:

* the main path, ``FramePipeline.step`` with the benchmark configuration
  on 16 VGA frames (K1 1 launch for the four pyramid layers, K2 2),
  compared with the plain CPU step;
* the fused path, the same step with ``fused_mask=True`` (K3 1 launch for
  the four layers, K1 0, K2 2), bit-equal to the main path;
* the README quick start: two VGA frames written and read back as PGM,
  ``BriskFeature(octaves=0, ..., fused_mask=True).detect_and_compute`` on
  each host image (the entry point moves it to the card) and
  ``radius_match_best`` (K3 once per image), compared with the same calls
  on a ``device="cpu"`` feature;
* the 16-bit pipeline: ``detect_and_compute`` on one VGA uint16 frame (a
  bench frame in the high byte, a seeded low byte) with float Harris
  scores, float warps, the float integral and the float sampler, torch ops
  that launch none of the hand-written kernels (all counts stay 0),
  compared with a ``device="cpu"`` feature and timed per stage;
* the facade's knobs on a VGA uint8 frame: caller keypoints from
  ``KeyPoints.from_numpy`` through ``compute`` (K2 twice), then
  ``refine_dtype="float64"`` with ``angle_exact=True`` through
  ``detect_and_compute`` (K1 once, K2 twice), each bitwise against a
  ``device="cpu"`` feature, and a feature built from bench.py's keywords;
* the classic AST path (``[ast]``): ``AstFramePipeline.step`` with bench.py's
  AST configuration on 80 VGA bench frames, its capacity and describe
  certificates first (K2 2 launches, K1 and K3 none); 4 frames on the card
  against a ``device="cpu"`` pipeline, ``compute_scale`` of frame 0's
  keypoints and the ``exact`` cache model on frame 0, each against the CPU;
  the step timed at batch 16 and 80 per stage, and K2 at the AST shapes
  against its plain version and its bound;
* the v1 engine (``[v1]``): ``BriskFeatureDetector(version="v1")`` on VGA
  bench frames, its caps certified first; ``detect_and_compute`` on 4
  frames (K2's v1-rounding variant 2 launches each), ``AstFramePipeline`` at
  batch 16 (K2 with v2 rounding, as the JAX step, and a 512-bit match) and
  ``BriskFeature(version="v1")`` on one frame (K1 1, K2 v1 2), each against
  a ``device="cpu"`` twin; K2's v1 variant against its plain version and
  its bound, and the v1 step timed per stage;
* the camera-aware path (``[camera]``): ``CameraAwareFeatureGrid`` on a
  radial-tangential and an equidistant VGA camera and the single-view
  ``CameraAwareFeature``, with the benchmark's ``BriskFeature``, on a bench
  frame taken as the distorted image (K1 1, K2 2 an image), against
  ``device="cpu"`` twins and timed per stage;
* the keyframed VO + BA loop (``[vo]``): ``vo.sequence.run_keyframed``, the
  counterpart of ``tools/kitti_eval.py`` with its defaults but the ``lm``
  solver, on 48 VGA frames of the synthetic VO scene, its frame-0 capacity
  certificate first (K1 once a frame and once for the certificate, K2
  twice a frame, K3 none); the same loop on a ``device="cpu"`` twin with
  the same RANSAC draws (detection bitwise on every frame, keyframes and
  BA runs equal, poses within tolerance); the 8-point systems' SVD null
  vectors on the card; per-stage times a frame and a window, ATE and RPE;
* the keyframed loop's checkpoints (``[ckpt]``): ``run_keyframed`` on the
  first 24 frames of the ``[vo]`` scene with a checkpoint every 2
  keyframes, stopped by an exception after 14 frames and resumed from its
  latest checkpoint, bitwise equal to an uninterrupted run under
  deterministic algorithms (two plain runs differ in the last bits: the
  BA's ``index_add_`` adds with atomics); K1 and K2 counted on the resume;
* the utilities (``[utils]``): ``utils.roofline.measure_peaks`` on the card
  beside the data sheet's peaks, ``roofline.report`` over ``stage_times``'
  stages against both, and a ``utils.timing.timer`` in each mode around a
  B=16 step, its sample bracketing the step's CUDA-event time;
* the sharded layer (``[dist]``): one NCCL rank, a (1, 1) mesh: the sharded
  knn bitwise the dense knn, ``FramePipeline(mesh=...)`` counted (K1 1, K2
  2) and bitwise the plain step, the AST step over it (K2 2) bitwise the
  plain AST step, the distributed BA and pose graph within
  1e-9 of the single-card solvers in float64 and within the JAX tests' bars
  in float32, the ``worker`` command's run and the dry run;
* the examples (``[examples]``): ``live_pipeline`` over 9 VGA bench frames
  written as PGM (K1 3, K2 4), its ``batch`` lines equal to a
  ``--device cpu`` run's, and ``cameras_demo`` on the card;
* the gather probes (``ethzasl_brisk_tpu_torch.probes``): each of the 39
  calls through the 26 ``pallas_call`` sites of the TPU probes P1, P3 and
  P2 at full size, its kernel (G1, G2, C, W, T, X or S) launched once,
  counted, and held bitwise against its plain version; each kernel and its
  library yardstick timed by CUDA events and by the profiler's device time,
  and the kernels T, C and G1 summed against theirs (``t + 8``,
  ``.clone()`` and ``torch.gather``).

Both steps are timed at batch 16 and 128 with per-stage CUDA events, in
turns (default, fused, fused, default), and each kernel against its plain
version and beside its bound, by CUDA events and by its own device time. Any failed check raises; the last line is a
JSON object with ``"ok": true``. Needs one CUDA card; without one it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import torch

# bench.py's feature configuration (bench.py:88-158) with its capacities
# re-certified for the smoothed-noise frames. bench.py sized them on crops
# of the reference's test images; on these frames the per-frame maxima
# at batch 128 are 9604/1877/2887/952 candidates, 425/192/115/56 accepted
# and 575 describable, so bench.py's 7168/3072/1792/1024, 352/160/96/56
# and 448 would truncate. Each cap below keeps >= 6 % headroom.
BENCH_CONFIG = dict(
    octaves=2,
    uniformity_radius=30.0,
    absolute_threshold=20.0,
    max_candidates=(10240, 3072, 3072, 1024),
    max_keypoints=1024,
    refine_capacity=(480, 224, 128, 64),
    describe_capacity=640,
)
N_ROT = 1024
SENTINEL = 385
# The README's Harris quick start (README.md "Quick start"), with the
# fused mask; its candidate cap is certified on the frames before use.
QUICK_CONFIG = dict(octaves=0, uniformity_radius=30.0, absolute_threshold=20.0,
                    fused_mask=True)
QUICK_RADIUS = 90
# The 16-bit phase: bench.py's detector on a 16-bit frame; float Harris on
# 16 bits scales the 8-bit scores by ~257^4. The candidate cap is certified
# on the frame before use.
U16_CONFIG = dict(octaves=2, uniformity_radius=30.0, absolute_threshold=20.0 * 257.0**4,
                  max_keypoints=1024)
# bench.py's BriskFeature keywords (bench.py:99-158) at their defaults.
BENCH_KEYWORDS = dict(
    octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
    max_candidates=(7168, 3072, 1792, 1024), max_keypoints=1024,
    sampler="patch_pallas", patch_h=128, patch_w=128, topk_impl="block",
    topk_block_size=2048, topk_block_r=96, uniformity_block=256,
    refine_capacity=(352, 160, 96, 56), fused_mask=False, describe_capacity=448,
)
# bench.py's AST detector and pipeline (bench.py:_ast_detector_from_env
# defaults, :522-556; main_ast, :590-602; its AST batch, :76). Its caps hold
# on these frames (certified below before timing).
AST_DETECTOR = dict(threshold=70, octaves=3,
                    max_candidates_per_layer=(512, 384, 320, 160, 96, 48),
                    raw_cache_model="emulated", detect_impl="dense")
AST_PIPELINE = dict(sampler="patch_pallas", describe_capacity=384)
AST_BATCH = 80
AST_STAGES = ("pyramid", "layers", "candidates", "pass1", "aux", "pass2", "describe", "match")
SYSTEM_KERNELS = ("harris_score_i32", "harris_score_mask", "smoothed_intensity",
                  "smoothed_intensity_v1")
# The v1 engine on the bench frames. bench.py's AST threshold 70 finds no
# v1 corner on these smoothed-noise frames (their local contrast stays under
# 70; v2's threshold map lowers its effective threshold there), so [v1]
# prints that certificate and runs threshold 35, which finds about as many
# corners as v2 does at 70. Its caps are bench.py's AST caps, raised where
# the frames need it (certified at run time).
V1_THRESHOLD = 35
V1_BATCH = 16
# [camera]: the JAX camera-aware test's radial-tangential camera
# (tests/test_geometry.py:167-169) at twice its size, and an equidistant
# camera with the JAX round-trip test's coefficients (:50).
CAMERA = dict(fu=520.0, fv=520.0, cu=320.0, cv=240.0, width=640, height=480)
RADTAN = (-0.25, 0.06, 0.0, 0.0)
EQUIDISTANT = (-0.01, 0.005, -0.002, 0.001)
CAMERA_STAGES = ("detect", "warp", "describe", "angles")
STAGES = ("pyramid", "harris", "masks", "candidates", "uniformity", "refine", "describe")
# [vo]: tools/synthetic_vo_bench.py's clean scene (texture seed 11, its
# VGA camera) along its trajectory, through run_keyframed with
# tools/kitti_eval.py's defaults but the lm solver (kitti_eval's default is
# the trimmed one). Tolerances of the CPU twin: see vo_phase.
VO_FRAMES = 48
VO_SEED = 11
VO_CAMERA = (400.0, 400.0, 320.0, 240.0, 640, 480)
VO_FLAGS = dict(ba_solver="lm")
VO_DRAW_SEED = 3
# [ckpt]: the [vo] scene and flags over its first CKPT_FRAMES frames, a
# checkpoint every 2 keyframes, stopped after CKPT_CRASH_AFTER frames.
CKPT_FRAMES = 24
CKPT_CRASH_AFTER = 14
# [utils]: the published H100 SXM dense TF32 and bfloat16 matmul peaks
# (NVIDIA's data sheet, 700 W), printed beside the measured ones with the
# float32 and HBM peaks that measure.bound_ms keeps (datasheet_peaks).
DATASHEET_TENSOR_GFLOPS = dict(peak_gflops_tf32=495e3, peak_gflops_bf16=989e3)
# [examples]: live_pipeline over 9 bench frames in batches of 4 (two
# batches, the second with its boundary pair).
LIVE_FRAMES = 9
LIVE_BATCH = 4


# Integer operations per pixel of K1, counted from csrc/harris.cu's
# separable form: the gradients 11 (hd 1; hs 4; dx 4; dy 2), the three
# products 3 x 2 (multiply, shift), the smoothing 3 x 7 (horizontal and
# vertical [1, 2, 1] sums 3 each, the shift) and the score 8.
K1_OPS_PER_PIXEL = 11 + 3 * 2 + 3 * 7 + 8
# K3, counted from csrc/harris.cu's masked body: K1's, the separable 3 x 3
# maximum 4 (the horizontal max of 3; the carried pair of rows with the
# new row, and the new pair) and the mask 3 (the threshold, the compare
# with the maximum, their and).
K3_OPS_PER_PIXEL = K1_OPS_PER_PIXEL + 4 + 3
# K2 per (keypoint, point), counted from csrc/sampler.cu: (int32, float32)
# operations of the geometry shared by both branches (46, 10), plus the
# box branch (73, 20) or the small-sigma bilinear branch (38, 4).
K2_OPS_BOX = (46 + 73, 10 + 20)
K2_OPS_SMALL = (46 + 38, 10 + 4)
# The v1 variant adds one add to the bilinear branch and a halving and an
# add to the box branch.
K2_V1_EXTRA = {"box": 2, "small": 1}
# The 6 x 6 tap grid cells (row, column) each K2 branch reads
# (sampler.cu's tIJ); the box branch's corner c and d columns depend on
# ``big``.
_BOX_TAPS = {(0, 0), (0, 1), (1, 0), (1, 1), (0, 3), (0, 4), (1, 3), (1, 4), (2, 5), (3, 5),
             (2, 2), (3, 2), (4, 4), (4, 3), (5, 3), (5, 1), (4, 1), (4, 0)}
K2_TAPS = {
    "small": {(i, j) for i in range(3) for j in range(3)},
    "big": _BOX_TAPS | {(2, 4), (3, 4), (2, 1), (3, 1)},
    "box": _BOX_TAPS | {(2, 3), (3, 3), (2, 0), (3, 0)},
}


def k2_bound(calls) -> tuple[float, str]:
    """K2's bound over the describe phases' inputs: the integral sectors
    the taps read, the keypoint and pattern inputs and the output, and the
    operations of the branch each point takes."""
    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.describe.sampler import _tap_geometry

    used = {}
    for name, taps in K2_TAPS.items():
        used[name] = torch.zeros((6, 6), dtype=torch.bool, device=calls[0][0].device)
        for i, j in taps:
            used[name][i, j] = True
    nbytes = int_ops = fp_ops = 0
    for integral, key_x, key_y, pat_x, pat_y, pat_sigma, _, _, row_base, frame_rows, *v1 in calls:
        k, p = pat_x.shape
        cols = integral.shape[1] - 1
        g = _tap_geometry(key_x, key_y, pat_x, pat_y, pat_sigma)
        rows = torch.clamp(g["row_coords"], 0, frame_rows).to(torch.int64)
        rows = (rows + row_base.to(torch.int64)[:, None, None]) * (cols + 1)
        flat = rows[..., :, None] + torch.clamp(g["col_coords"], 0, cols).to(torch.int64)[..., None, :]
        small, big = g["small"][..., None, None], g["big"][..., None, None]
        need = torch.where(small, used["small"], torch.where(big, used["big"], used["box"]))
        n_small = int(g["small"].sum())
        nbytes += (3 * 4 * k + 6 * 4 * k * p
                   + measure.distinct_sector_bytes(flat[need], 4, integral.numel()))
        int_ops += K2_OPS_SMALL[0] * n_small + K2_OPS_BOX[0] * (k * p - n_small)
        if v1 and v1[0]:
            int_ops += K2_V1_EXTRA["small"] * n_small + K2_V1_EXTRA["box"] * (k * p - n_small)
        fp_ops += K2_OPS_SMALL[1] * n_small + K2_OPS_BOX[1] * (k * p - n_small)
    return measure.bound_ms(nbytes, int32_ops=int_ops, fp32_ops=fp_ops)


def capture_sampler_inputs(run):
    """The smoothed_intensity arguments of both describe phases of ``run()``."""
    from ethzasl_brisk_tpu_torch.describe import extractor

    calls = []
    real = extractor.smoothed_intensity_fused

    def record(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args)

    extractor.smoothed_intensity_fused = record
    try:
        run()
    finally:
        extractor.smoothed_intensity_fused = real
    assert len(calls) == 2, len(calls)
    return calls


def assert_same_step(a, b, what: str) -> None:
    """Two FramePipeline.step outputs bit for bit."""
    for name, x, y in zip(("x", "y", "size", "angle", "response", "octave", "valid"),
                          a[0].fields(), b[0].fields()):
        assert torch.equal(x, y), f"{what}: keypoint {name}"
    for name, x, y in zip(("descriptors", "match_idx", "match_dist"), a[1:4], b[1:4]):
        assert torch.equal(x, y), f"{what}: {name}"


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    ai = a.cpu().contiguous().view(torch.int32).to(torch.int64)
    bi = b.cpu().contiguous().view(torch.int32).to(torch.int64)
    return int((ai - bi).abs().max()) if ai.numel() else 0


def theta_of(angle: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotation bin as _describe_core computes it, and its raw value."""
    raw = N_ROT * angle / 360.0 + 0.5
    t = torch.trunc(raw).to(torch.int64)
    return torch.remainder(t, N_ROT), raw


def quick_start(dev: torch.device) -> dict:
    """The README's Harris quick start on the card, held against the same
    calls on a ``device="cpu"`` feature. Returns the path's kernel launches."""
    from ethzasl_brisk_tpu_torch import BriskFeature, _kernels, measure
    from ethzasl_brisk_tpu_torch.core.image_io import read_pgm, write_pgm
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.match.matcher import radius_match_best

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"img{i}.pgm") for i in range(2)]
        for path, frame in zip(paths, bench_frames(2)):
            write_pgm(path, frame)
        imgs = [torch.from_numpy(read_pgm(path)) for path in paths]
    gpu_imgs = [im.to(dev) for im in imgs]

    # Certify the candidate cap first: the default 4096 truncates here.
    probe = BriskFeature(**QUICK_CONFIG)
    counts = [int(probe.detect_with_diagnostics(im)[1].cand_counts.max()) for im in gpu_imgs]
    cap = -(-max(counts) * 11 // 10 // 1024) * 1024
    feature = BriskFeature(**QUICK_CONFIG, max_candidates=cap)
    assert feature.device == dev, feature.device
    for im in gpu_imgs:
        assert bool(feature.detect_with_diagnostics(im)[1].ok), "quick start cap"

    def run(f, images):
        out = [f.detect_and_compute(im) for im in images]
        match = radius_match_best(out[1][1], out[0][1], out[1][0].valid, out[0][0].valid,
                                  QUICK_RADIUS)
        return out, match

    torch.cuda.synchronize()
    _kernels.reset_launches()
    out, match = run(feature, imgs)  # host images, as the README passes them
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    assert all(t.device == dev for t in (*out[0][0].fields(), out[0][1], *match)), "outputs"
    assert launches["harris_score_mask"] == 2, launches
    assert launches["harris_score_i32"] == 0, launches
    assert launches["smoothed_intensity"] == 4, launches

    ref, ref_match = run(BriskFeature(**QUICK_CONFIG, max_candidates=cap, device="cpu"), imgs)
    flips, gap, n_valid = 0, 0, []
    for (kg, dg), (kc, dc) in zip(out, ref):
        assert kg.x.dim() == 1 and dg.shape == (kg.capacity, 12), "unbatched outputs"
        assert torch.equal(kg.valid.cpu(), kc.valid), "quick start valid"
        for name in ("size", "response", "octave"):
            assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
        gap = max(gap, ulp_gap(kg.x, kc.x), ulp_gap(kg.y, kc.y))
        th_g, _ = theta_of(kg.angle.cpu())
        th_c, raw_c = theta_of(kc.angle)
        agree = (th_g == th_c) | ~kc.valid
        flips += int((~agree).sum())
        edge = (raw_c - torch.round(raw_c)).abs() < 1e-3
        assert bool(edge[~agree].all()), "theta flip away from a bin edge"
        assert torch.equal(dg.cpu()[agree], dc[agree]), "descriptors where theta agrees"
        assert bool(torch.isfinite(kg.x).all())
        n_valid.append(int(kc.valid.sum()))
    assert gap <= 1, gap
    assert min(n_valid) > 0
    if flips == 0:
        for g, c in zip(match, ref_match):
            assert torch.equal(g.cpu(), c), "quick start matches"
    ms = measure.cuda_time(lambda: feature.detect_and_compute(gpu_imgs[0]), reps=5, warmup=1)
    print(
        f"[quick start] 2 VGA PGM images: candidates {counts} -> certified cap {cap}; "
        f"valid keypoints {n_valid}; launches {launches}; GPU vs CPU: valid bitwise, x/y "
        f"within {gap} ULP, {flips} theta bin-edge flips, descriptors bitwise where theta "
        f"agrees, matches {'bitwise' if flips == 0 else 'not compared'} "
        f"({int(match[2].sum())} under radius {QUICK_RADIUS}); detect_and_compute "
        f"{ms:.3f} ms per image (median of 5)",
        flush=True,
    )
    return launches


def certified_cap(feature_kw: dict, img: torch.Tensor) -> int:
    """A candidate cap with >= 10 % headroom over the frame's most
    populous layer, in steps of 1024 (the default 4096 truncates on noise)."""
    from ethzasl_brisk_tpu_torch import BriskFeature

    diag = BriskFeature(**feature_kw).detect_with_diagnostics(img)[1]
    return -(-int(diag.cand_counts.max()) * 11 // 10 // 1024) * 1024


def assert_same_image_outputs(got, ref, what: str, allow_flips: bool) -> tuple[int, int]:
    """One image's (KeyPoints, words) on the card against the CPU: every
    field bitwise; with ``allow_flips`` the angle may differ and theta flip
    at a bin edge, descriptors bitwise where theta agrees. Returns (valid
    count, flips)."""
    (kg, dg), (kc, dc) = got, ref
    for name, a, b in zip(("x", "y", "size", "response", "octave", "valid"),
                          (kg.x, kg.y, kg.size, kg.response, kg.octave, kg.valid),
                          (kc.x, kc.y, kc.size, kc.response, kc.octave, kc.valid)):
        assert torch.equal(a.cpu(), b), f"{what}: {name}"
    if not allow_flips:
        assert torch.equal(kg.angle.cpu(), kc.angle), f"{what}: angle"
        assert torch.equal(dg.cpu(), dc), f"{what}: descriptors"
        return int(kc.valid.sum()), 0
    th_g, _ = theta_of(kg.angle.cpu())
    th_c, raw_c = theta_of(kc.angle)
    agree = (th_g == th_c) | ~kc.valid
    edge = (raw_c - torch.round(raw_c)).abs() < 1e-3
    assert bool(edge[~agree].all()), f"{what}: theta flip away from a bin edge"
    assert torch.equal(dg.cpu()[agree], dc[agree]), f"{what}: descriptors where theta agrees"
    return int(kc.valid.sum()), int((~agree).sum())


def stage_times(feature, img: torch.Tensor, reps: int = 10, warmup: int = 3):
    """Medians (ms) of ``reps`` single-image detect_and_compute runs, total
    and per stage, by CUDA events at the stage boundaries."""
    for _ in range(warmup):
        feature.detect_and_compute(img)
    torch.cuda.synchronize()
    totals, stages = [], {n: [] for n in STAGES}
    for _ in range(reps):
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        feature.compute(img, feature.detect(img, mark=mark))
        mark("describe")
        torch.cuda.synchronize()
        prev = start
        for name, e in marks:
            stages[name].append(prev.elapsed_time(e))
            prev = e
        totals.append(start.elapsed_time(marks[-1][1]))
    return statistics.median(totals), {n: statistics.median(t) for n, t in stages.items()}


def u16_phase(dev: torch.device, card: str) -> None:
    """The 16-bit pipeline on one VGA frame, on the card against the CPU."""
    import numpy as np

    from ethzasl_brisk_tpu_torch import BriskFeature, _kernels
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    high = bench_frames(1)[0].astype(np.uint16)
    low = np.random.default_rng(16).integers(0, 256, high.shape).astype(np.uint16)
    # x * 257 with its low byte replaced by a seeded one: all 16 bits used.
    frame = torch.from_numpy(((high * 257) & 0xFF00) | low)
    img = frame.to(dev)
    cap = certified_cap(U16_CONFIG, img)
    feature = BriskFeature(**U16_CONFIG, max_candidates=cap)
    diag = feature.detect_with_diagnostics(img)[1]
    assert bool(diag.ok), f"[u16] cap {cap}: {diag.cand_counts.tolist()}"

    torch.cuda.synchronize()
    _kernels.reset_launches()
    got = feature.detect_and_compute(frame)  # the host image, as a user passes it
    torch.cuda.synchronize()
    launches = {k: _kernels.LAUNCHES[k] for k in SYSTEM_KERNELS}
    assert not any(_kernels.LAUNCHES.values()), f"[u16] runs no hand-written kernel: {launches}"
    assert got[0].x.device == dev and got[1].shape == (got[0].capacity, 12)
    assert bool(torch.isfinite(got[0].x).all())
    ref = BriskFeature(**U16_CONFIG, max_candidates=cap, device="cpu").detect_and_compute(frame)
    n_valid, flips = assert_same_image_outputs(got, ref, "[u16]", allow_flips=True)
    assert n_valid > 0
    ms, stages = stage_times(feature, img)
    stage_txt = ", ".join(f"{n} {t:.3f}" for n, t in stages.items())
    print(
        f"[u16] VGA uint16 frame: candidates {diag.cand_counts.tolist()} -> certified cap "
        f"{cap}; valid keypoints {n_valid}; launches {launches}; GPU vs CPU: every field "
        f"bitwise, {flips} theta bin-edge flips, descriptors bitwise where theta agrees; "
        f"detect_and_compute median {ms:.3f} ms of 10 (3 warm-up); stages ms: {stage_txt} "
        f"[{card}]",
        flush=True,
    )


def facade_phase(dev: torch.device, card: str) -> None:
    """Caller keypoints through compute, the float64 refine with exact
    angles, and bench.py's keywords, on one VGA uint8 frame."""
    import numpy as np

    from ethzasl_brisk_tpu_torch import BriskFeature, KeyPoints, _kernels
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    frame = torch.from_numpy(bench_frames(1, seed=11)[0])
    rng = np.random.default_rng(11)
    n = 800
    x, y = rng.uniform(0, 640, n), rng.uniform(0, 480, n)
    size = rng.uniform(8, 40, n)
    angle = np.where(rng.random(n) < 0.5, rng.uniform(-180, 180, n), -1.0)
    kw = dict(uniformity_radius=30.0, absolute_threshold=20.0, angle_exact=True)

    feature = BriskFeature(**kw)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    got = feature.compute(frame, KeyPoints.from_numpy(x, y, size, angle, capacity=1024))
    torch.cuda.synchronize()
    launches = {k: _kernels.LAUNCHES[k] for k in SYSTEM_KERNELS}
    assert launches["smoothed_intensity"] == 2, launches
    assert launches["harris_score_i32"] == launches["harris_score_mask"] == 0, launches
    ref = BriskFeature(**kw, device="cpu").compute(
        frame, KeyPoints.from_numpy(x, y, size, angle, capacity=1024, device="cpu"))
    n_given, _ = assert_same_image_outputs(got, ref, "[facade] from_numpy", allow_flips=False)
    assert n_given > 0

    parity = dict(kw, octaves=2, refine_dtype="float64")
    parity["max_candidates"] = certified_cap(parity, frame.to(dev))
    torch.cuda.synchronize()
    _kernels.reset_launches()
    got = BriskFeature(**parity).detect_and_compute(frame)
    torch.cuda.synchronize()
    launches64 = {k: _kernels.LAUNCHES[k] for k in SYSTEM_KERNELS}
    assert launches64["harris_score_i32"] == 1, launches64
    assert launches64["smoothed_intensity"] == 2, launches64
    ref = BriskFeature(**parity, device="cpu").detect_and_compute(frame)
    n64, _ = assert_same_image_outputs(got, ref, "[facade] float64", allow_flips=False)
    assert n64 > 0
    f32 = BriskFeature(**dict(parity, refine_dtype="float32")).detect_and_compute(frame)[0]
    moved = int((f32.x != got[0].x).sum() + (f32.y != got[0].y).sum())

    bench = BriskFeature(**BENCH_KEYWORDS)
    plain = BriskFeature(**{k: v for k, v in BENCH_KEYWORDS.items()
                            if k not in ("sampler", "patch_h", "patch_w", "topk_impl",
                                         "topk_block_size", "topk_block_r")})
    assert bench.descriptor_bytes == 48 and bench.config == plain.config
    (kb, db), (kp, dp) = bench.detect_and_compute(frame), plain.detect_and_compute(frame)
    assert all(torch.equal(a, b) for a, b in zip(kb.fields(), kp.fields())) and torch.equal(db, dp)
    print(
        f"[facade] VGA uint8: {n} from_numpy keypoints (capacity 1024) through compute, "
        f"launches {launches}, {n_given} described; refine_dtype float64 + angle_exact "
        f"through detect_and_compute (cap {parity['max_candidates']}), launches {launches64}, "
        f"{n64} valid, {moved} x/y values moved from the float32 refine; both bitwise "
        f"against the CPU; bench.py's keywords build a feature equal to the default "
        f"selectors' ({int(kb.valid.sum())} valid) [{card}]",
        flush=True,
    )


def timed_steps(pipe, frames, stage_names, reps=10, warmup=3):
    """(median, min) step ms of ``reps`` steps after ``warmup``, and the
    median ms of each stage, by CUDA events at the ``mark`` boundaries."""
    for _ in range(warmup):
        pipe.step(frames)
    torch.cuda.synchronize()
    totals, stages = [], {n: [] for n in stage_names}
    for _ in range(reps):
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        pipe.step(frames, mark=mark)
        torch.cuda.synchronize()
        prev = start
        for name, e in marks:
            stages[name].append(prev.elapsed_time(e))
            prev = e
        totals.append(start.elapsed_time(marks[-1][1]))
    return (statistics.median(totals), min(totals),
            {n: statistics.median(t) for n, t in stages.items()})


def assert_same_step_flips(got, ref, what: str) -> tuple[int, int, float]:
    """A step on the card against the CPU: every keypoint field but the
    angle bitwise on every slot; theta equal or flipped at a bin edge;
    descriptors bitwise where theta agrees, matches bitwise when it agrees
    everywhere. Returns (valid, flips, largest valid angle gap)."""
    kg, kc = got[0], ref[0]
    for name in ("x", "y", "size", "response", "octave", "valid"):
        assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), f"{what}: {name}"
    v = kc.valid
    th_g, _ = theta_of(kg.angle.cpu())
    th_c, raw_c = theta_of(kc.angle)
    agree = (th_g == th_c) | ~v
    edge = (raw_c - torch.round(raw_c)).abs() < 1e-3
    assert bool(edge[~agree].all()), f"{what}: theta flip away from a bin edge"
    assert torch.equal(got[1].cpu()[agree], ref[1][agree]), f"{what}: descriptors"
    flips = int((~agree).sum())
    if flips == 0:
        assert torch.equal(got[2].cpu(), ref[2]) and torch.equal(got[3].cpu(), ref[3]), \
            f"{what}: matches"
    gap = float((kg.angle.cpu() - kc.angle).abs()[v].max()) if bool(v.any()) else 0.0
    return int(v.sum()), flips, gap


def ast_phase(dev: torch.device, card: str, kind: str) -> None:
    """The classic AST path: bench.py's AST configuration on 80 VGA bench
    frames, certified, counted, against the CPU, and timed."""
    from ethzasl_brisk_tpu_torch import (
        AstFramePipeline,
        BriskFeatureDetector,
        KeyPoints,
        _kernels,
        compute_scale,
        measure,
    )
    from ethzasl_brisk_tpu_torch.describe.sampler import (
        smoothed_intensity,
        smoothed_intensity_cuda,
    )
    from ethzasl_brisk_tpu_torch.detect.ast_scale_space import ast_capacity_diagnostics
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    host = torch.from_numpy(bench_frames(AST_BATCH))
    frames = host.to(dev)
    det = BriskFeatureDetector(**AST_DETECTOR)
    pipe = AstFramePipeline(det, **AST_PIPELINE)
    assert det.device == pipe.device == dev, (det.device, pipe.device)
    caps = AST_DETECTOR["max_candidates_per_layer"]
    cert = ast_capacity_diagnostics(frames, AST_DETECTOR["threshold"], AST_DETECTOR["octaves"],
                                    caps)
    counts = cert.corner_counts.max(dim=0).values.tolist()
    assert bool(cert.ok.all()), f"[ast] caps {caps} against corners {counts}"

    # ---- The path, counted: the step on the 80 frames.
    torch.cuda.synchronize()
    _kernels.reset_launches()
    kps, desc, midx, mdist, diag = pipe.step(frames, with_diagnostics=True)
    torch.cuda.synchronize()
    launches = {k: _kernels.LAUNCHES[k] for k in SYSTEM_KERNELS}
    assert launches == {"harris_score_i32": 0, "harris_score_mask": 0,
                        "smoothed_intensity": 2, "smoothed_intensity_v1": 0}, launches
    b, k = kps.valid.shape
    n_desc = int(diag["describable"])
    assert bool(diag["detect"].ok.all()), diag["detect"]
    assert n_desc <= AST_PIPELINE["describe_capacity"] * b, n_desc
    per_frame = kps.valid.sum(dim=1)
    assert int(per_frame.min()) >= 1, per_frame
    assert tuple(midx.shape) == tuple(mdist.shape) == (b - 1, k) and desc.shape == (b, k, 12)
    assert int(midx.min()) >= 0 and int(midx.max()) < k
    assert torch.equal(mdist == SENTINEL, ~kps.valid[1:]), "[ast] sentinel where query valid"
    assert bool(torch.isfinite(kps.x).all() and torch.isfinite(kps.y).all())
    budget = AST_PIPELINE["describe_capacity"] * b
    print(f"[ast] step B={b} VGA: corners per layer (max over frames) {counts} under caps "
          f"{list(caps)}, certified; describable {n_desc} <= {budget}; "
          f"valid keypoints/frame min {int(per_frame.min())} max {int(per_frame.max())}; "
          f"launches {launches}", flush=True)

    # ---- 4 frames on the card against the CPU, counted.
    det_cpu = BriskFeatureDetector(**AST_DETECTOR, device="cpu")
    f4 = host[:4]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    got = pipe.step(f4)
    torch.cuda.synchronize()
    launches4 = {k: _kernels.LAUNCHES[k] for k in SYSTEM_KERNELS}
    assert launches4 == launches, launches4
    ref = AstFramePipeline(det_cpu, device="cpu", **AST_PIPELINE).step(f4)
    n_valid, flips, gap = assert_same_step_flips(got, ref, "[ast] gpu vs cpu")
    assert n_valid > 0 and (n_valid - flips) / n_valid >= 0.999, (flips, n_valid)

    # ---- compute_scale of frame 0's valid keypoints, and the exact model.
    v0 = ref[0].valid[0]
    cols = {f: getattr(ref[0], f)[0][v0].numpy() for f in ("x", "y", "size")}
    got_cs = compute_scale(det, host[0], KeyPoints.from_numpy(**cols))
    ref_cs = compute_scale(det_cpu, host[0], KeyPoints.from_numpy(**cols, device="cpu"))
    for name, a, c in zip(("x", "y", "size", "angle", "response", "octave", "valid"),
                          got_cs.fields(), ref_cs.fields()):
        assert torch.equal(a.cpu(), c), f"[ast] compute_scale {name}"
    cs_ms = measure.cuda_time(lambda: compute_scale(det, frames[0], KeyPoints.from_numpy(**cols)),
                              reps=5, warmup=1)
    exact_kw = dict(AST_DETECTOR, raw_cache_model="exact", detect_impl="candidates")
    det_exact = BriskFeatureDetector(**exact_kw)
    got_ex = det_exact.detect(host[0])
    ref_ex = BriskFeatureDetector(**exact_kw, device="cpu").detect(host[0])
    for name, a, c in zip(("x", "y", "size", "angle", "response", "octave", "valid"),
                          got_ex.fields(), ref_ex.fields()):
        assert torch.equal(a.cpu(), c), f"[ast] exact {name}"
    ex_ms = measure.cuda_time(lambda: det_exact.detect(frames[0]), reps=5, warmup=1)
    emu_ms = measure.cuda_time(lambda: det.detect(frames[0]), reps=5, warmup=1)
    n_diff = int((got_ex.valid != pipe.detector.detect(frames[0]).valid).sum())
    print(f"[ast] gpu vs cpu B=4: every keypoint field but the angle bitwise, {n_valid} valid, "
          f"{flips} theta bin-edge flips, largest valid angle gap {gap:.3g} deg, descriptors "
          f"and matches bitwise; launches {launches4}. compute_scale of frame 0's "
          f"{int(v0.sum())} keypoints: bitwise, {cs_ms:.3f} ms; exact cache model on frame 0: "
          f"bitwise, {int(got_ex.valid.sum())} valid ({n_diff} slots differ from emulated), "
          f"detect {ex_ms:.3f} ms against emulated {emu_ms:.3f} ms (median of 5) [{card}]",
          flush=True)

    # ---- Timing at batch 16 and 80.
    for batch in (16, AST_BATCH):
        fb = frames[:batch]
        torch.cuda.reset_peak_memory_stats()
        med, low, stages = timed_steps(pipe, fb, AST_STAGES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy = measure.device_busy_ms(lambda: pipe.step(fb))
        stage_txt = ", ".join(f"{n} {t:.3f}" for n, t in stages.items())
        print(f"[ast timing] step B={batch}: median {med:.3f} ms, min {low:.3f} ms of 10 "
              f"(3 warm-up), {batch / med * 1e3:.1f} frames/s; stages ms: {stage_txt}; "
              f"peak mem {peak:.2f} GiB; device busy {busy:.3f} ms a step in a profiled step, "
              f"{busy / med:.1%} of the median [{kind}; {card}]", flush=True)

    # ---- K2 at the AST shapes: against its plain version, timed, bounded.
    calls = capture_sampler_inputs(lambda: pipe.step(frames))
    for phase, args in enumerate(calls):
        assert torch.equal(smoothed_intensity_cuda(*args), smoothed_intensity(*args)), \
            f"[ast] K2 differs in phase {phase}"
    k2_ms = measure.cuda_time(lambda: [smoothed_intensity_cuda(*a) for a in calls])
    k2_plain = measure.cuda_time(lambda: [smoothed_intensity(*a) for a in calls])
    k2_dev = measure.device_time(lambda: [smoothed_intensity_cuda(*a) for a in calls], dev,
                                 ("k2_sampler_kernel",))
    k2_bnd = k2_bound(calls)
    print(f"[ast K2] B={AST_BATCH}, 2 phases, K x P = {tuple(calls[0][3].shape)}: bitwise vs "
          f"plain; {k2_ms:.3f} ms (device {k2_dev:.4f} ms) vs plain {k2_plain:.3f} ms, bound "
          f"{k2_bnd[0]:.4f} ms ({k2_bnd[1]}) [{kind}; {card}]", flush=True)


def counted(fn):
    """fn()'s result and the system kernels' launches during it, the
    counters set to 0 just before and read just after."""
    from ethzasl_brisk_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: _kernels.LAUNCHES[k] for k in SYSTEM_KERNELS}


def v1_caps(frames: torch.Tensor, threshold: int) -> tuple[tuple, list, list]:
    """bench.py's AST caps, each raised to 1.25 x the most corners any
    frame's layer holds (in steps of 32) where the frames need it, and
    certified: (caps, maxima at ``threshold``, maxima at bench.py's 70)."""
    from ethzasl_brisk_tpu_torch.detect.ast_scale_space import ast_capacity_diagnostics

    bench_caps = AST_DETECTOR["max_candidates_per_layer"]
    octaves = AST_DETECTOR["octaves"]
    at70 = ast_capacity_diagnostics(frames, AST_DETECTOR["threshold"], octaves, bench_caps,
                                    v1=True).corner_counts.max(dim=0).values.tolist()
    counts = ast_capacity_diagnostics(frames, threshold, octaves, bench_caps,
                                      v1=True).corner_counts.max(dim=0).values.tolist()
    caps = tuple(max(c, -(-n * 5 // 4 // 32) * 32) for c, n in zip(bench_caps, counts))
    cert = ast_capacity_diagnostics(frames, threshold, octaves, caps, v1=True)
    assert bool(cert.ok.all()), f"[v1] caps {caps} against corners {counts}"
    return caps, counts, at70


def v1_phase(dev: torch.device, card: str, kind: str) -> dict:
    """The v1 engine on VGA bench frames: the facade, the AST step and the
    Harris feature, each counted and against a CPU twin; K2's v1 variant
    against its plain version; the v1 step timed. Returns K2 v1's row."""
    from ethzasl_brisk_tpu_torch import AstFramePipeline, BriskFeature, BriskFeatureDetector, measure
    from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity, smoothed_intensity_cuda
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    host = torch.from_numpy(bench_frames(V1_BATCH))
    frames = host.to(dev)
    caps, counts, at70 = v1_caps(frames, V1_THRESHOLD)
    kw = dict(AST_DETECTOR, threshold=V1_THRESHOLD, max_candidates_per_layer=caps, version="v1")
    det, det_cpu = BriskFeatureDetector(**kw), BriskFeatureDetector(**kw, device="cpu")
    assert det.descriptor_bytes == 64 and det.extractor.v1_rounding
    print(f"[v1] B={V1_BATCH} VGA bench frames: v1 corners per layer (max over frames) at "
          f"threshold 70 {at70}; at {V1_THRESHOLD} {counts}, certified under caps {list(caps)}",
          flush=True)

    # ---- The facade on 4 frames: K2's v1 variant, 2 launches a frame.
    got, launches = counted(lambda: [det.detect_and_compute(host[i]) for i in range(4)])
    assert launches == {"harris_score_i32": 0, "harris_score_mask": 0, "smoothed_intensity": 0,
                        "smoothed_intensity_v1": 8}, launches
    n_fac, flips_fac = 0, 0
    for i, g in enumerate(got):
        assert g[1].shape == (g[0].capacity, 16), g[1].shape
        n, f = assert_same_image_outputs(g, det_cpu.detect_and_compute(host[i]),
                                         f"[v1] facade frame {i}", allow_flips=True)
        n_fac, flips_fac = n_fac + n, flips_fac + f
    assert n_fac > 0 and flips_fac <= n_fac // 1000, (flips_fac, n_fac)

    # ---- The AST step at B=16: v2 rounding (the JAX step passes no
    # v1_rounding), a 512-bit match with sentinel 513.
    pipe = AstFramePipeline(det, **AST_PIPELINE)
    step, launches_step = counted(lambda: pipe.step(frames, with_diagnostics=True))
    assert launches_step == {"harris_score_i32": 0, "harris_score_mask": 0,
                             "smoothed_intensity": 2, "smoothed_intensity_v1": 0}, launches_step
    kps, desc, midx, mdist, diag = step
    assert desc.shape[-1] == 16 and bool(diag["detect"].ok.all())
    assert int(diag["describable"]) <= AST_PIPELINE["describe_capacity"] * V1_BATCH
    assert torch.equal(mdist == 513, ~kps.valid[1:]), "[v1] sentinel 513 where query invalid"
    assert int(mdist.max()) <= 513
    ref = AstFramePipeline(det_cpu, device="cpu", **AST_PIPELINE).step(host)
    n_step, flips_step, gap = assert_same_step_flips(step[:4], ref, "[v1] step gpu vs cpu")
    assert n_step > 0 and flips_step <= n_step // 1000, (flips_step, n_step)

    # ---- The Harris feature with the v1 extractor on one frame.
    feat = BriskFeature(**BENCH_CONFIG, version="v1")
    hg, launches_h = counted(lambda: feat.detect_and_compute(host[0]))
    assert launches_h == {"harris_score_i32": 1, "harris_score_mask": 0, "smoothed_intensity": 0,
                          "smoothed_intensity_v1": 2}, launches_h
    n_h, flips_h = assert_same_image_outputs(
        hg, BriskFeature(**BENCH_CONFIG, version="v1", device="cpu").detect_and_compute(host[0]),
        "[v1] BriskFeature", allow_flips=True)
    assert n_h > 0
    print(f"[v1] detect_and_compute on 4 frames: launches {launches}, {n_fac} valid, {flips_fac} "
          f"theta bin-edge flips; AstFramePipeline B={V1_BATCH}: launches {launches_step}, "
          f"{n_step} valid, {flips_step} flips, largest valid angle gap {gap:.3g} deg, describable "
          f"{int(diag['describable'])}, 512-bit match; BriskFeature(version='v1') on frame 0: "
          f"launches {launches_h}, {n_h} valid, {flips_h} flips; each against a device='cpu' twin: "
          f"every other field bitwise, descriptors bitwise where theta agrees [{card}]", flush=True)

    # ---- K2's v1 variant at the facade's shapes, against its plain version.
    calls = capture_sampler_inputs(lambda: det.detect_and_compute(frames[0]))
    assert all(c[10] for c in calls), "the facade describes with v1 rounding"
    err = 0
    for phase, args in enumerate(calls):
        got_k2, ref_k2 = smoothed_intensity_cuda(*args), smoothed_intensity(*args)
        err = max(err, int((got_k2.to(torch.int64) - ref_k2).abs().max()))
        assert torch.equal(got_k2, ref_k2), f"[v1] K2 v1 differs in phase {phase}"
    small = sum(int((c[5] < 0.5).sum()) for c in calls)
    # The v1 ring's smallest sigma is 0.65 at pattern_scale 1, so the
    # bilinear branch is dead above; at 0.5 it is live.
    from ethzasl_brisk_tpu_torch.describe.extractor import BriskExtractor

    import numpy as np

    from ethzasl_brisk_tpu_torch import KeyPoints

    half = BriskExtractor(version="v1", pattern_scale=0.5)
    rng = np.random.default_rng(5)
    h, w = host.shape[1:]
    # Sizes from 4 px: scale index 0 (size under ~7.5) holds the sigmas < 0.5.
    kps05 = KeyPoints.from_numpy(rng.uniform(0, w, 1024), rng.uniform(0, h, 1024),
                                 rng.uniform(4, 24, 1024))
    calls05 = capture_sampler_inputs(lambda: half(frames[0], kps05))
    small05 = sum(int((c[5] < 0.5).sum()) for c in calls05)
    assert small05 > 0, "[v1] the bilinear branch is live at pattern_scale 0.5"
    for phase, args in enumerate(calls05):
        assert torch.equal(smoothed_intensity_cuda(*args), smoothed_intensity(*args)), \
            f"[v1] K2 v1 differs at pattern_scale 0.5, phase {phase}"
    k2_ms = measure.cuda_time(lambda: [smoothed_intensity_cuda(*a) for a in calls])
    k2_plain = measure.cuda_time(lambda: [smoothed_intensity(*a) for a in calls])
    k2_dev = measure.device_time(lambda: [smoothed_intensity_cuda(*a) for a in calls], dev,
                                 ("k2_sampler_kernel",))
    bnd = k2_bound(calls)
    print(f"[v1 K2] v1 rounding, 2 phases, K x P = {tuple(calls[0][3].shape)} ({small} "
          f"small-sigma points; at pattern_scale 0.5 {small05}, bitwise too): bitwise vs plain; "
          f"{k2_ms:.3f} ms (device {k2_dev:.4f} ms) vs "
          f"plain {k2_plain:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) [{kind}; {card}]", flush=True)

    # ---- The v1 step timed at B=16.
    torch.cuda.reset_peak_memory_stats()
    med, low, stages = timed_steps(pipe, frames, AST_STAGES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stage_txt = ", ".join(f"{n} {t:.3f}" for n, t in stages.items())
    print(f"[v1 timing] step B={V1_BATCH}: median {med:.3f} ms, min {low:.3f} ms of 10 (3 warm-up), "
          f"{V1_BATCH / med * 1e3:.1f} frames/s; stages ms: {stage_txt}; peak mem {peak:.2f} GiB "
          f"[{kind}; {card}]", flush=True)
    return dict(name="smoothed_intensity_v1", route="cuda",
                source="ethzasl_brisk_tpu_torch/csrc/sampler.cu",
                replaces="ethzasl_brisk_tpu/describe/pallas_sampler.py:46",
                launches=launches["smoothed_intensity_v1"], max_abs_err=err, ms=k2_ms,
                device_ms=k2_dev, plain_ms=k2_plain, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=None)


def assert_same_camera_outputs(got, ref, what: str) -> tuple[int, int, float]:
    """A camera-aware run on the card against the CPU: every keypoint field
    but the angle bitwise (x and y within 1 ULP, as the Harris detection's
    on the card); descriptors bitwise on at least 99.9 % of the valid
    keypoints (a view angle's theta may flip at a bin edge); the angle
    within 1e-2 degree. Returns (valid, descriptor rows that differ,
    largest valid angle gap)."""
    (kg, dg), (kc, dc) = got, ref
    for name in ("size", "response", "octave", "valid"):
        assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), f"{what}: {name}"
    assert max(ulp_gap(kg.x, kc.x), ulp_gap(kg.y, kc.y)) <= 1, f"{what}: x/y"
    v = kc.valid
    rows = int((dg.cpu() != dc).any(dim=1)[v].sum())
    n = int(v.sum())
    assert n > 0 and rows <= n // 1000, (what, rows, n)
    gap = float((kg.angle.cpu() - kc.angle).abs()[v].max())
    assert gap < 1e-2, (what, gap)
    return n, rows, gap


def camera_phase(dev: torch.device, card: str, kind: str) -> None:
    """The camera-aware path on a VGA bench frame taken as the distorted
    image: two grids and the single view, counted, against the CPU, timed."""
    from ethzasl_brisk_tpu_torch import BriskFeature, measure
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.geometry import (
        EquidistantDistortion,
        PinholeCamera,
        RadialTangentialDistortion,
    )
    from ethzasl_brisk_tpu_torch.geometry.camera_aware import (
        CameraAwareFeature,
        CameraAwareFeatureGrid,
    )

    host = torch.from_numpy(bench_frames(1, seed=13)[0])
    img = host.to(dev)
    feature, feature_cpu = BriskFeature(**BENCH_CONFIG), BriskFeature(**BENCH_CONFIG, device="cpu")
    diag = feature.detect_with_diagnostics(img)[1]
    assert bool(diag.ok), f"[camera] detect certificate: {diag}"
    cams = {
        "radtan": PinholeCamera(**CAMERA, distortion=RadialTangentialDistortion(*RADTAN)),
        "equidistant": PinholeCamera(**CAMERA, distortion=EquidistantDistortion(*EQUIDISTANT)),
    }
    expect = {"harris_score_i32": 1, "harris_score_mask": 0, "smoothed_intensity": 2,
              "smoothed_intensity_v1": 0}
    for name, cam in cams.items():
        t0 = time.perf_counter()
        grid = CameraAwareFeatureGrid(cam, feature)
        build_s = time.perf_counter() - t0
        grid_cpu = CameraAwareFeatureGrid(cam, feature_cpu, device="cpu")
        got, launches = counted(lambda: grid.detect_and_compute(host))
        assert launches == expect, (name, launches)
        assert got[1].shape == (got[0].capacity, 12) and bool(torch.isfinite(got[0].angle).all())
        n, rows, gap = assert_same_camera_outputs(got, grid_cpu.detect_and_compute(host),
                                                  f"[camera] {name} grid")
        for _ in range(3):
            grid.detect_and_compute(img)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        totals, stages = [], {s: [] for s in CAMERA_STAGES}
        for _ in range(10):
            marks = []

            def mark(stage):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append((stage, e))

            start = torch.cuda.Event(enable_timing=True)
            start.record()
            grid.detect_and_compute(img, mark=mark)
            torch.cuda.synchronize()
            prev = start
            for stage, e in marks:
                stages[stage].append(prev.elapsed_time(e))
                prev = e
            totals.append(start.elapsed_time(marks[-1][1]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        stage_txt = ", ".join(f"{s} {statistics.median(t):.3f}" for s, t in stages.items())
        print(f"[camera] {name} grid: {grid.n_views} views ({grid.n_x} x {grid.n_y}), padded view "
              f"{tuple(grid.dist_maps.shape[1:3])}, views built on the host in {build_s:.2f} s; "
              f"launches {launches}; {n} valid, GPU vs CPU: fields bitwise (x/y within 1 ULP), "
              f"{rows} descriptor rows differ, largest angle gap {gap:.3g} deg; "
              f"detect_and_compute median {statistics.median(totals):.3f} ms, min "
              f"{min(totals):.3f} of 10 (3 warm-up); stages ms: {stage_txt}; peak mem "
              f"{peak:.3f} GiB [{kind}; {card}]", flush=True)

    single = CameraAwareFeature(cams["radtan"], feature)
    got, launches = counted(lambda: single.detect_and_compute(host))
    assert launches == expect, launches
    ref = CameraAwareFeature(cams["radtan"], feature_cpu).detect_and_compute(host)
    assert torch.equal(got[2].cpu(), ref[2]), "[camera] single view warp"
    n, rows, gap = assert_same_camera_outputs(got[:2], ref[:2], "[camera] single view")
    ms = measure.cuda_time(lambda: single.detect_and_compute(img))
    print(f"[camera] single view (radtan): launches {launches}; warp bitwise, {n} valid, {rows} "
          f"descriptor rows differ, largest angle gap {gap:.3g} deg; detect_and_compute median "
          f"{ms:.3f} ms of 10 [{kind}; {card}]", flush=True)


def shared_draw(seed: int):
    """A RANSAC draw that hands the card and the CPU the same samples: the
    uniforms come from a CPU generator and go through the port's own
    inverse-CDF on the weights' device."""
    from ethzasl_brisk_tpu_torch.geometry.ransac import sample_indices

    gen = torch.Generator().manual_seed(seed)

    def draw(n_hyp, k, weights):
        u = torch.rand((n_hyp, k), generator=gen, dtype=torch.float64)
        return sample_indices(u.to(weights.device), weights)
    return draw


def vo_phase(dev: torch.device, card: str, kind: str) -> None:
    """The keyframed VO + window-BA loop on a VGA synthetic sequence,
    counted, against a CPU twin, timed per stage."""
    import numpy as np

    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.vo import frontend
    from ethzasl_brisk_tpu_torch.vo.sequence import FRAME_STAGES, WINDOW_STAGES, run_keyframed

    # The 8-point systems' null vectors: cuSOLVER's batched SVD must hand
    # back the 9th right singular vector of RANSAC's (512, 8, 9) and
    # (256, 8, 9) systems.
    rng = np.random.default_rng(VO_SEED)
    for shape in ((512, 8, 9), (256, 8, 9)):
        a = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        v = torch.linalg.svd(a.to(dev), full_matrices=True)[2][..., -1, :].cpu()
        ref = torch.linalg.svd(a.double(), full_matrices=True)[2][..., -1, :]
        resid = float(torch.linalg.vector_norm(a @ v[..., None], dim=(-2, -1)).max())
        align = float((v.double() * ref).sum(-1).abs().min())
        assert resid < 1e-4 and align > 1 - 1e-4, (shape, resid, align)
        print(f"[vo] SVD {shape} on the card: |A v| <= {resid:.2e}, |v . v_cpu64| >= "
              f"{align:.6f}", flush=True)

    t0 = time.perf_counter()
    frames, cam, gt = vo_scene(VO_FRAMES)
    render_s = time.perf_counter() - t0

    recorded = []
    process = frontend.VoFrontend.process_frame

    def recording(self, img):
        out = process(self, img)
        recorded.append(out)
        return out

    # Warm-up on the first frames (first calls of cuSOLVER and the jvp),
    # which checks the frame-0 capacity certificate first.
    warm = run_keyframed(frames[:8], cam, gt[:8], draw=shared_draw(VO_DRAW_SEED), **VO_FLAGS)
    assert warm["capacity_ok"], "[vo] frame-0 capacity certificate"
    marks = []

    def mark(stage):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((stage, e))

    frontend.VoFrontend.process_frame = recording
    try:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        got, launches = counted(lambda: run_keyframed(
            frames, cam, gt, draw=shared_draw(VO_DRAW_SEED), mark=mark, **VO_FLAGS))
        loop_s = time.perf_counter() - t0
        card_frames = list(recorded)
        recorded.clear()
        t0 = time.perf_counter()
        ref = run_keyframed(frames, cam, gt, draw=shared_draw(VO_DRAW_SEED), device="cpu",
                            **VO_FLAGS)
        cpu_s = time.perf_counter() - t0
        cpu_frames = list(recorded)
    finally:
        frontend.VoFrontend.process_frame = process
    assert got["capacity_ok"] and ref["capacity_ok"]
    # K1 once a frame and once for the frame-0 certificate, K2 twice a frame.
    expect = {"harris_score_i32": VO_FRAMES + 1, "harris_score_mask": 0,
              "smoothed_intensity": 2 * VO_FRAMES, "smoothed_intensity_v1": 0}
    assert launches == expect, launches
    assert len(card_frames) == len(cpu_frames) == VO_FRAMES
    n_valid, flips = [], 0
    for i, (g, c) in enumerate(zip(card_frames, cpu_frames)):
        n, f = assert_same_image_outputs(g, c, f"[vo] frame {i}", allow_flips=True)
        n_valid.append(n)
        flips += f
    for key in ("frames", "keyframes", "ba_runs", "ba_rejects"):
        assert got[key] == ref[key], (key, got[key], ref[key])
    assert got["keyframes"] >= VO_FRAMES // 8 and got["ba_runs"] >= 1, (got["keyframes"],
                                                                        got["ba_runs"])
    # The card's and the CPU's float32 SVDs differ in the last digits, as
    # torch's and JAX's do on the CPU (tests/test_torch_vo_keyframed.py),
    # so the trajectories agree to a tolerance: camera centres within 5 %
    # of the path, rotations within 0.02, ATE within 1 % of the path.
    path = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    centre_gap = float(np.abs(got["poses"][:, :3, 3] - ref["poses"][:, :3, 3]).max())
    rot_gap = float(np.abs(got["poses"][:, :3, :3] - ref["poses"][:, :3, :3]).max())
    assert np.isfinite(got["poses"]).all()
    assert centre_gap <= 0.05 * path and rot_gap <= 0.02, (centre_gap, rot_gap)
    assert abs(got["ate_rmse"] - ref["ate_rmse"]) <= 0.01 * path, (got["ate_rmse"],
                                                                    ref["ate_rmse"])
    assert got["ate_rmse"] < 0.05 * path, got["ate_rmse"]

    # The card's busy share over the first 16 frames (4-5 windows): the
    # device time of one profiled run against the wall time of one plain run.
    def head():
        return run_keyframed(frames[:16], cam, gt[:16], draw=shared_draw(VO_DRAW_SEED),
                             **VO_FLAGS)

    head()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    head()
    torch.cuda.synchronize()
    head_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = measure.device_busy_ms(head)

    torch.cuda.synchronize()
    times = {s: [] for s in FRAME_STAGES + WINDOW_STAGES}
    prev = start
    for stage, e in marks:
        times[stage].append(prev.elapsed_time(e))
        prev = e
    # Frame 0's detect also holds the certificate and the setup.
    times["detect"] = times["detect"][1:]
    stage_txt = ", ".join(f"{s} {statistics.median(t):.3f} (x{len(t)})"
                          for s, t in times.items() if t)
    print(f"[vo] {VO_FRAMES} VGA frames (synthetic_vo_bench scene, seed {VO_SEED}, rendered on "
          f"the host in {render_s:.2f} s), run_keyframed {VO_FLAGS}: launches {launches}; "
          f"valid keypoints/frame {min(n_valid)}-{max(n_valid)}; keyframes {got['keyframes']}, "
          f"BA runs {got['ba_runs']}, rejects {got['ba_rejects']}; ATE {got['ate_rmse']:.5f} "
          f"(CPU {ref['ate_rmse']:.5f}) on a {path:.3f} path, RPE {got['rpe_trans_rmse']:.5f} / "
          f"{got['rpe_rot_rmse_deg']:.4f} deg", flush=True)
    print(f"[vo] card vs CPU twin (same draws): detection bitwise on every frame, {flips} theta "
          f"bin-edge flips, descriptors bitwise where theta agrees; keyframes, BA runs and "
          f"rejects equal; camera centres within {centre_gap:.2e}, rotations within "
          f"{rot_gap:.2e}", flush=True)
    print(f"[vo timing] loop {loop_s:.2f} s on the card ({loop_s / VO_FRAMES * 1e3:.1f} ms a "
          f"frame), CPU twin {cpu_s:.2f} s; median ms a frame (detect, match, ransac, refine, "
          f"kf_verify) and a window (build_ba on the host, ba_solve) by CUDA events: "
          f"{stage_txt}; first 16 frames {head_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"(idle {1 - busy_ms / head_ms:.1%}) [{kind}; {card}]", flush=True)


def utils_phase(dev: torch.device, card: str, kind: str, feature, pipe, frames16) -> None:
    """The card's own peaks beside the data sheet's, the roofline report
    over stage_times' stages, and the timing registry around one step in
    each mode, whose samples must bracket the step's CUDA-event time."""
    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.utils import roofline, timing

    sheet = dict(DATASHEET_TENSOR_GFLOPS, peak_gflops=measure.FP32_OPS_PER_S / 1e9,
                 peak_gbs=measure.HBM_BYTES_PER_S / 1e9)
    peaks = roofline.measure_peaks(device=dev)
    print(f"[utils] measured peaks: float32 matmul {peaks['peak_gflops']:.1f} GFLOP/s at "
          f"matmul precision {peaks['f32_matmul_precision']!r}, bfloat16 matmul "
          f"{peaks['peak_gflops_bf16']:.1f} GFLOP/s, 64 MB read {peaks['peak_gbs']:.1f} GB/s; "
          f"data sheet float32 {sheet['peak_gflops']:.0f}, TF32 "
          f"{sheet['peak_gflops_tf32']:.0f}, bfloat16 "
          f"{sheet['peak_gflops_bf16']:.0f} GFLOP/s, HBM "
          f"{sheet['peak_gbs']:.0f} GB/s [{kind}; {card}]", flush=True)
    assert all(peaks[k] > 0 for k in ("peak_gflops", "peak_gflops_bf16", "peak_gbs")), peaks

    img = frames16[0]
    total, stages = stage_times(feature, img)
    caps = BENCH_CONFIG["max_candidates"]
    model = roofline.stage_model(batch=1, h=img.shape[0], w=img.shape[1], n_layers=4,
                                 max_candidates=sum(caps) // len(caps),
                                 max_keypoints=BENCH_CONFIG["max_keypoints"],
                                 describe_slots=BENCH_CONFIG["describe_capacity"])
    stage_ms = dict(scores=stages["harris"], masks=stages["masks"],
                    top_k=stages["candidates"], uniformity=stages["uniformity"],
                    refine=stages["refine"], describe=stages["describe"])
    for label, pk in (("measured", peaks), ("data-sheet", sheet)):
        rep = roofline.report(stage_ms, model, pk)
        txt = "; ".join(f"{n} {r['ms']} ms ({r['kind']}) mfu {r['mfu']} bw {r['bandwidth_frac']}"
                        for n, r in rep.items())
        print(f"[utils] roofline of one VGA detect_and_compute ({total:.3f} ms) against the "
              f"{label} peaks: {txt} [{kind}; {card}]", flush=True)

    timing.Timing.reset()
    pipe.step(frames16)
    torch.cuda.synchronize()
    for mode in ("checksum", "block", "checksum", "block"):
        box = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with timing.timer(f"utils/step-{mode}", block_on=box, mode=mode):
            start.record()
            box.append(pipe.step(frames16))
            end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end)
        sample_ms = timing.Timing.get(f"utils/step-{mode}").window[-1] * 1e3
        assert event_ms <= sample_ms <= 1.25 * event_ms + 5.0, (mode, event_ms, sample_ms)
        print(f"[utils] timer mode {mode} around one B=16 step: sample {sample_ms:.3f} ms, "
              f"CUDA events {event_ms:.3f} ms [{kind}; {card}]", flush=True)
    print("[utils] " + timing.Timing.print_timing().replace("\n", "\n[utils] "), flush=True)


def vo_scene(n: int):
    """The [vo] scene's first n VGA frames, its camera and ground truth."""
    import numpy as np

    from ethzasl_brisk_tpu_torch.frames import make_texture, render_scene, trajectory
    from ethzasl_brisk_tpu_torch.geometry import PinholeCamera

    cam = PinholeCamera(*VO_CAMERA)
    tex = make_texture(np.random.default_rng(VO_SEED))
    traj = trajectory(n)
    frames = [render_scene(tex, cam, r, t) for r, t in traj]
    gt = np.tile(np.eye(4), (n, 1, 1))
    for i, (r, t) in enumerate(traj):
        gt[i, :3, :3] = r.T
        gt[i, :3, 3] = -r.T @ t
    return frames, cam, gt


class _Crash(Exception):
    pass


def ckpt_phase(dev: torch.device, card: str, kind: str) -> None:
    """run_keyframed with checkpoints on the card: stopped partway as a
    crash would stop it, resumed from its latest checkpoint, bitwise equal
    to an uninterrupted run."""
    import warnings

    import numpy as np

    from ethzasl_brisk_tpu_torch.utils.checkpoint import CheckpointManager
    from ethzasl_brisk_tpu_torch.vo.sequence import run_keyframed

    frames, cam, gt = vo_scene(CKPT_FRAMES)
    # Two plain runs: the BA's index_add_ adds with atomics on the card,
    # so the last bits of a run need not repeat.
    runs = [run_keyframed(frames, cam, gt, device=dev, **VO_FLAGS) for _ in range(2)]
    repeat_gap = float(np.abs(runs[0]["poses"] - runs[1]["poses"]).max())
    # The three runs compared bitwise run with deterministic algorithms
    # (CUBLAS_WORKSPACE_CONFIG is set in main before the first cuBLAS call).
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as nondet:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            ref = run_keyframed(frames, cam, gt, device=dev, **VO_FLAGS)
            ref_s = time.perf_counter() - t0
            seen = []

            def crash(stage):
                if stage == "detect":
                    seen.append(1)
                    if len(seen) > CKPT_CRASH_AFTER:
                        raise _Crash

            with tempfile.TemporaryDirectory() as tmp:
                ckpt = dict(checkpoint_dir=os.path.join(tmp, "ck"), checkpoint_every=2)
                t0 = time.perf_counter()
                try:
                    run_keyframed(frames, cam, gt, device=dev, mark=crash, **ckpt, **VO_FLAGS)
                except _Crash:
                    pass
                else:
                    raise AssertionError("[ckpt] the stopped run ran to its end")
                crash_s = time.perf_counter() - t0
                mgr = CheckpointManager(ckpt["checkpoint_dir"])
                steps = mgr.all_steps()
                assert steps, "[ckpt] no checkpoint before the stop"
                size = os.path.getsize(mgr._path(steps[-1]))
                t0 = time.perf_counter()
                got, launches = counted(lambda: run_keyframed(frames, cam, gt, device=dev, **ckpt,
                                                              **VO_FLAGS))
                resume_s = time.perf_counter() - t0
                saved_state, _ = mgr.restore_latest()
                t0 = time.perf_counter()
                mgr.save(10**6, saved_state)
                save_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.use_deterministic_algorithms(False)
    nondet_ops = sorted({str(w.message).split(" does not have")[0] for w in nondet
                         if "deterministic" in str(w.message)})
    resumed_at = steps[-1]
    frames_run = CKPT_FRAMES - resumed_at
    expect = {"harris_score_i32": frames_run + 1, "harris_score_mask": 0,
              "smoothed_intensity": 2 * frames_run, "smoothed_intensity_v1": 0}
    assert launches == expect, (launches, expect)
    poses = got.pop("poses")
    assert np.array_equal(poses, ref.pop("poses")), "[ckpt] resumed trajectory"
    assert got == ref, (got, ref)
    assert ref["keyframes"] >= 3 and ref["ba_runs"] >= 1, ref
    print(f"[ckpt] run_keyframed on {CKPT_FRAMES} VGA frames of the [vo] scene {VO_FLAGS}, a "
          f"checkpoint every 2 keyframes (steps {steps}): stopped after {CKPT_CRASH_AFTER} "
          f"frames, resumed at frame {resumed_at} (launches {launches}); trajectory, "
          f"keyframes {got['keyframes']}, BA runs {got['ba_runs']} and rejects bitwise equal to "
          f"the uninterrupted run; uninterrupted {ref_s:.2f} s, stopped run {crash_s:.2f} s, "
          f"resumed run {resume_s:.2f} s; a checkpoint {size / 2**20:.2f} MiB, saved in "
          f"{save_ms:.1f} ms; under deterministic algorithms (ops without one: "
          f"{nondet_ops}); two plain runs' poses {repeat_gap:.3g} apart [{kind}; {card}]",
          flush=True)


def dense_window(seed: int, dtype):
    """tests/test_ba.py's dense window (6 poses along x, 200 landmarks seen
    from every pose, noisy start) as a BaProblem on the CPU."""
    import numpy as np

    from ethzasl_brisk_tpu_torch.ba.se3 import so3_exp
    from ethzasl_brisk_tpu_torch.ba.window import BaProblem

    rng = np.random.default_rng(seed)
    k, n_lm = 6, 200
    t_cam = -np.stack([np.linspace(0, 1.0, k), np.zeros(k), np.zeros(k)], 1)
    pts = rng.uniform([-3, -2, 4], [3, 2, 10], (n_lm, 3))
    kf, lm = np.repeat(np.arange(k), n_lm), np.tile(np.arange(n_lm), k)
    x_c = pts[lm] + t_cam[kf]
    uv = np.stack([400.0 * x_c[:, 0] / x_c[:, 2] + 320, 400.0 * x_c[:, 1] / x_c[:, 2] + 240], 1)
    w = rng.normal(0, 0.02, (k, 3)).astype(np.float32)
    w[0] = 0
    r0 = so3_exp(torch.from_numpy(w)).numpy().astype(np.float64)
    t0 = t_cam + rng.normal(0, 0.02, (k, 3))
    t0[0] = t_cam[0]
    pts0 = pts + rng.normal(0, 0.1, (n_lm, 3))
    return BaProblem.from_numpy(dict(
        r=r0.astype(dtype), t=t0.astype(dtype), points=pts0.astype(dtype), kf_idx=kf,
        lm_idx=lm, uv=uv.astype(dtype), valid=np.ones(len(kf), bool), fu=dtype(400.0),
        fv=dtype(400.0), cu=dtype(320.0), cv=dtype(240.0)), device="cpu")


def dist_phase(dev: torch.device, card: str, kind: str, feature, pipe, frames16) -> None:
    """The sharded layer on one rank of NCCL, mesh (1, 1): sharded knn, the
    data-parallel step (counted), distributed BA and pose graph against the
    single-card ones, the worker's run and the dry run."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from ethzasl_brisk_tpu_torch import (
        AstFramePipeline,
        BriskFeatureDetector,
        FramePipeline,
        measure,
    )
    from ethzasl_brisk_tpu_torch.ba.pose_graph import optimize_pose_graph
    from ethzasl_brisk_tpu_torch.ba.window import solve_window_ba
    from ethzasl_brisk_tpu_torch.match.matcher import knn_match
    from ethzasl_brisk_tpu_torch.parallel import (
        init_process_group,
        make_mesh,
        sharded_knn_match,
    )
    from ethzasl_brisk_tpu_torch.parallel.dist_ba import partition_problem, solve_window_ba_sharded
    from ethzasl_brisk_tpu_torch.parallel.dist_pg import (
        optimize_pose_graph_sharded,
        partition_edges,
    )
    from ethzasl_brisk_tpu_torch.parallel.multihost import circle_graph, run_dryrun, run_worker

    def close(got, ref, rel):
        gap = float((got - ref).abs().max())
        assert gap <= rel * float(ref.abs().max()), (gap, rel)
        return gap

    with tempfile.TemporaryDirectory() as tmp:
        rank_dev = init_process_group(0, 1, tmp, dev)
        try:
            backend = "nccl" if dev.type == "cuda" else "gloo"
            assert rank_dev == dev and dist.get_backend() == backend, (rank_dev, backend)
            mesh = make_mesh(1, 1, dev)
            kps, desc, midx, mdist = pipe.step(frames16)
            idx, dk = sharded_knn_match(mesh, desc[1], desc[0], kps.valid[0], k=2)
            ref_idx, ref_d = knn_match(desc[1], desc[0], torch.ones_like(kps.valid[1]),
                                       kps.valid[0], k=2)
            assert torch.equal(idx, ref_idx) and torch.equal(dk, ref_d), "[dist] sharded knn"

            sharded = FramePipeline(feature, dev, mesh)
            got, launches = counted(lambda: sharded.step(frames16, with_diagnostics=True))
            assert launches["harris_score_i32"] == 1 and launches["smoothed_intensity"] == 2, \
                launches
            assert_same_step(got[:4], (kps, desc, midx, mdist), "[dist] step over the mesh")
            assert bool(got[4]["detect"].ok.all())
            ast_det = BriskFeatureDetector(**AST_DETECTOR, device=dev)
            ast_plain = AstFramePipeline(ast_det, dev, **AST_PIPELINE).step(frames16[:4])
            ast_got, ast_launches = counted(lambda: AstFramePipeline(
                ast_det, dev, mesh=mesh, **AST_PIPELINE).step(frames16[:4]))
            assert ast_launches["smoothed_intensity"] == 2, ast_launches
            assert_same_step(ast_got, ast_plain, "[dist] AST step over the mesh")
            step_ms = measure.cuda_time(lambda: sharded.step(frames16))
            plain_ms = measure.cuda_time(lambda: pipe.step(frames16))
            print(f"[dist] NCCL, 1 rank, mesh (1, 1): sharded knn bitwise the dense knn; "
                  f"FramePipeline(mesh=...) B=16 launches {launches}, bitwise the plain step; "
                  f"AstFramePipeline(mesh=...) B=4 launches {ast_launches}, bitwise the plain "
                  f"AST step; "
                  f"step {step_ms:.3f} ms vs plain {plain_ms:.3f} ms (median of 10) "
                  f"[{kind}; {card}]", flush=True)

            gaps = []
            for dtype, rel in ((np.float64, 1e-9), (np.float32, None)):
                prob = dense_window(5, dtype)
                prob = dataclasses.replace(prob, **{f.name: getattr(prob, f.name).to(dev)
                                                    for f in dataclasses.fields(prob)})
                single, s_costs = solve_window_ba(prob, iterations=10, damping=1e-3)
                solved, d_costs = solve_window_ba_sharded(mesh, partition_problem(prob, 1),
                                                          iterations=10, damping=1e-3)
                if rel is not None:
                    gaps += [close(solved.t, single.t, rel), close(solved.r, single.r, rel),
                             close(solved.points, single.points, rel),
                             close(d_costs, s_costs, rel)]
                else:
                    ts, td = single.t.cpu().numpy(), solved.t.cpu().numpy()
                    scale = np.linalg.norm(ts[1:]) / np.linalg.norm(td[1:])
                    np.testing.assert_allclose(td * scale, ts, rtol=5e-3, atol=5e-3)
                graph, _ = circle_graph(12, 5.0, np.random.default_rng(7), 0.03, 0.2,
                                        dtype=dtype)
                graph = dataclasses.replace(graph, **{f.name: getattr(graph, f.name).to(dev)
                                                      for f in dataclasses.fields(graph)})
                pg1, pg1_costs = optimize_pose_graph(graph, iterations=15, damping=1e-5)
                pgd, pgd_costs = optimize_pose_graph_sharded(mesh, partition_edges(graph, 1),
                                                             iterations=15, damping=1e-5)
                if rel is not None:
                    gaps += [close(pgd.t, pg1.t, rel), close(pgd.r, pg1.r, rel),
                             close(pgd_costs, pg1_costs, rel)]
                else:
                    assert float((pgd.t - pg1.t).abs().max()) <= 1e-4
                    assert float((pgd.r - pg1.r).abs().max()) <= 1e-4
                assert float(pgd_costs[-1]) < 1e-6, pgd_costs
            ba_costs, pg_costs, t_err = run_worker(mesh)
            assert ba_costs[0] > 100.0 and ba_costs[-1] < 1e-4, ba_costs
            assert pg_costs[-1] < 1e-6 and t_err < 1e-2, (pg_costs, t_err)
            t0 = time.perf_counter()
            info = run_dryrun(mesh)
            dry_s = time.perf_counter() - t0
            print(f"[dist] distributed BA (dense window, 10 GN steps) and pose graph (12-node "
                  f"loop, 15 steps) in float64 within {max(gaps):.2e} of the single-card "
                  f"solvers (bar 1e-9 relative), float32 within JAX's bars; the worker's run: "
                  f"BA cost {ba_costs[0]:.3e} -> {ba_costs[-1]:.3e}, pose graph "
                  f"{pg_costs[-1]:.3e}, translation error {t_err:.2e}; the dry run {info} in "
                  f"{dry_s:.2f} s [{kind}; {card}]", flush=True)
        finally:
            dist.destroy_process_group()


def examples_phase(dev: torch.device, card: str, kind: str) -> None:
    """live_pipeline over bench frames on the card (counted) against a
    ``--device cpu`` run; cameras_demo on the card."""
    import contextlib
    import io

    from ethzasl_brisk_tpu_torch.core.image_io import write_pgm
    from ethzasl_brisk_tpu_torch.examples import cameras_demo, live_pipeline
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.utils.timing import Timing

    def run(fn):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            fn()
        return out.getvalue().splitlines()

    with tempfile.TemporaryDirectory() as tmp:
        for i, frame in enumerate(bench_frames(LIVE_FRAMES)):
            write_pgm(os.path.join(tmp, f"{i:03d}.pgm"), frame)
        argv = [tmp, str(LIVE_BATCH), os.path.join(tmp, "draw")]
        Timing.reset()
        t0 = time.perf_counter()
        card_lines, launches = counted(
            lambda: run(lambda: live_pipeline.main([*argv, "--device", dev.type])))
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_lines = run(lambda: live_pipeline.main([*argv, "--device", "cpu"]))
        cpu_s = time.perf_counter() - t0
        n_drawn = len(os.listdir(os.path.join(tmp, "draw")))
    n_batches = (LIVE_FRAMES - 1) // LIVE_BATCH
    assert launches["harris_score_i32"] == n_batches + 1, launches
    assert launches["smoothed_intensity"] == 2 * n_batches, launches
    card_batches = [ln for ln in card_lines if ln.startswith("batch ")]
    assert card_batches == [ln for ln in cpu_lines if ln.startswith("batch ")], \
        (card_batches, cpu_lines)
    assert len(card_batches) == n_batches + 1 and n_drawn == n_batches * (LIVE_BATCH - 1)
    timing_lines = [ln for ln in card_lines if "ms" in ln]
    print(f"[examples] live_pipeline, {LIVE_FRAMES} VGA bench frames in batches of "
          f"{LIVE_BATCH}: launches {launches}; batch lines equal to the CPU run's: "
          f"{card_batches}; {n_drawn} drawings; card {card_s:.2f} s, CPU {cpu_s:.2f} s; "
          f"registry: {timing_lines} [{kind}; {card}]", flush=True)
    demo, demo_launches = counted(lambda: run(lambda: cameras_demo.main(["--device", dev.type])))
    assert demo_launches["harris_score_i32"] == 1 and demo_launches["smoothed_intensity"] == 2
    print(f"[examples] cameras_demo on the card: {demo}; launches {demo_launches} "
          f"[{kind}; {card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from ethzasl_brisk_tpu_torch import BriskFeature, FramePipeline, _kernels, measure
    from ethzasl_brisk_tpu_torch.describe.sampler import (
        smoothed_intensity,
        smoothed_intensity_cuda,
    )
    from ethzasl_brisk_tpu_torch.detect import scale_space
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.kernels.harris import (
        harris_score_i32,
        harris_score_i32_cuda,
        harris_score_i32_layers,
        harris_score_mask_cuda,
        harris_score_mask_i32,
        harris_score_mask_layers,
    )
    from ethzasl_brisk_tpu_torch.kernels.nms import maxima2d_mask
    from ethzasl_brisk_tpu_torch.probes import cases as probe_cases
    cuda_time = measure.cuda_time

    t_start = time.perf_counter()
    # [ckpt] runs with deterministic algorithms, whose cuBLAS calls need
    # this set before the first one.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = measure.card_line(dev)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"[card] {card}", flush=True)

    t0 = time.perf_counter()
    lib_path = _kernels.build()
    _kernels.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    frames16 = torch.from_numpy(bench_frames(16)).to(dev)
    # The entry points run on the card by default.
    feature = BriskFeature(**BENCH_CONFIG)
    pipe = FramePipeline(feature)
    assert feature.device == pipe.device == dev, (feature.device, pipe.device)

    # ---- K1 against its plain version: the four pyramid layers in one
    # launch, and each layer alone.
    pyramid = scale_space.build_pyramid(frames16, 4)
    k1_err = 0
    _kernels.reset_launches()
    got_layers = harris_score_i32_layers(pyramid)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["harris_score_i32"] == 1, _kernels.LAUNCHES
    for layer, got in zip(pyramid, got_layers):
        ref = harris_score_i32(layer)
        torch.cuda.synchronize()
        k1_err = max(k1_err, int((got.to(torch.int64) - ref).abs().max()))
        assert torch.equal(got, ref), f"K1 differs on layer {tuple(layer.shape)}"
        assert torch.equal(harris_score_i32_cuda(layer), ref), f"K1 alone, {tuple(layer.shape)}"
    print(f"[K1] bitwise equal to plain on layers {[tuple(p.shape) for p in pyramid]} in one "
          f"launch and each alone", flush=True)

    # ---- K3 against its plain version on the same layers, threshold 20:
    # the four layers in one launch, and each layer alone.
    thr = int(BENCH_CONFIG["absolute_threshold"])
    k3_err = 0
    _kernels.reset_launches()
    got_pairs = harris_score_mask_layers(pyramid, thr)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["harris_score_mask"] == 1, _kernels.LAUNCHES
    for layer, (got_sc, got_mask) in zip(pyramid, got_pairs):
        ref_sc, ref_mask = harris_score_mask_i32(layer, thr)
        torch.cuda.synchronize()
        k3_err = max(k3_err, int((got_sc.to(torch.int64) - ref_sc).abs().max()),
                     int((got_mask != ref_mask).sum()))
        assert torch.equal(got_sc, ref_sc), f"K3 scores differ on layer {tuple(layer.shape)}"
        assert torch.equal(got_mask, ref_mask), f"K3 mask differs on layer {tuple(layer.shape)}"
        assert int(got_mask.view(torch.uint8).max()) == 1, "K3 mask bytes"
        alone_sc, alone_mask = harris_score_mask_cuda(layer, thr)
        assert torch.equal(alone_sc, ref_sc) and torch.equal(alone_mask, ref_mask), \
            f"K3 alone, {tuple(layer.shape)}"
    print(f"[K3] scores and mask bitwise equal to plain at thr {thr} on layers "
          f"{[tuple(p.shape) for p in pyramid]} in one launch and each alone", flush=True)

    # ---- K2 against its plain version on both describe phases.
    k2_calls = capture_sampler_inputs(
        lambda: feature.describe(frames16, feature.detect(frames16)))
    k2_err = 0
    for phase, args in enumerate(k2_calls):
        got = smoothed_intensity_cuda(*args)
        ref = smoothed_intensity(*args)
        torch.cuda.synchronize()
        k2_err = max(k2_err, int((got.to(torch.int64) - ref).abs().max()))
        assert torch.equal(got, ref), f"K2 differs in phase {phase}"
    print(f"[K2] bitwise equal to plain on both phases, K x P = {tuple(k2_calls[0][3].shape)}",
          flush=True)

    # ---- The main path, counted.
    torch.cuda.synchronize()
    _kernels.reset_launches()
    kps, desc, midx, mdist, diag = pipe.step(frames16, with_diagnostics=True)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    assert launches["harris_score_i32"] == 1, launches
    assert launches["smoothed_intensity"] == 2, launches
    b, k = kps.valid.shape
    print(
        f"[main path] counts per layer, max over frames: candidates "
        f"{diag['detect'].cand_counts.max(dim=0).values.tolist()}, accepted "
        f"{diag['detect'].accepted_counts.max(dim=0).values.tolist()}; "
        f"describable {int(diag['describable'])}",
        flush=True,
    )
    assert bool(diag["detect"].ok.all()), diag["detect"]
    assert int(diag["describable"]) <= BENCH_CONFIG["describe_capacity"] * b
    per_frame = kps.valid.sum(dim=1)
    assert int(per_frame.min()) >= 1, per_frame
    assert tuple(midx.shape) == tuple(mdist.shape) == (b - 1, k)
    assert int(midx.min()) >= 0 and int(midx.max()) < k
    assert int(mdist.min()) >= 0 and int(mdist.max()) <= SENTINEL
    assert torch.equal(mdist == SENTINEL, ~kps.valid[1:]), "sentinel where query valid"
    assert desc.shape == (b, k, 12) and bool(torch.isfinite(kps.x).all())
    print(
        f"[main path] step B={b}: launches {launches}; diagnostics ok; "
        f"describable {int(diag['describable'])} <= {BENCH_CONFIG['describe_capacity'] * b}; "
        f"valid keypoints/frame min {int(per_frame.min())} max {int(per_frame.max())}",
        flush=True,
    )

    # ---- The fused path (K3 for scores and 2-D maxima), counted.
    fused_feature = BriskFeature(**BENCH_CONFIG, fused_mask=True)
    fused_pipe = FramePipeline(fused_feature)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    fused_out = fused_pipe.step(frames16)
    torch.cuda.synchronize()
    fused_launches = dict(_kernels.LAUNCHES)
    assert fused_launches["harris_score_mask"] == 1, fused_launches
    assert fused_launches["harris_score_i32"] == 0, fused_launches
    assert fused_launches["smoothed_intensity"] == 2, fused_launches
    assert_same_step(fused_out, (kps, desc, midx, mdist), "fused vs default step")
    print(f"[fused path] step B={b}: launches {fused_launches}; keypoints, descriptors "
          f"and matches bitwise equal to the default step", flush=True)

    # ---- GPU step against the plain CPU step on the first 4 frames.
    f4 = frames16[:4]
    f4c = f4.cpu()
    feature_cpu = BriskFeature(**BENCH_CONFIG, device="cpu")
    cfg = feature.config
    pyr_g, pyr_c = scale_space.build_pyramid(f4, 4), scale_space.build_pyramid(f4c, 4)
    sc_g, mk_g = scale_space.layer_score_masks(pyr_g, cfg)
    sc_c, mk_c = scale_space.layer_score_masks(pyr_c, cfg)
    for i in range(4):
        assert torch.equal(pyr_g[i].cpu(), pyr_c[i]), f"pyramid layer {i}"
        assert torch.equal(sc_g[i].cpu(), sc_c[i]), f"scores layer {i}"
        assert torch.equal(mk_g[i].cpu(), mk_c[i]), f"masks layer {i}"
        cg = scale_space._layer_candidates(sc_g[i], mk_g[i], cfg.layer_cap(i))
        cc = scale_space._layer_candidates(sc_c[i], mk_c[i], cfg.layer_cap(i))
        for a, c in zip(cg, cc):
            assert torch.equal(a.cpu(), c), f"candidates layer {i}"
        assert torch.equal(
            scale_space._layer_accept(cg, cfg).cpu(), scale_space._layer_accept(cc, cfg)
        ), f"accept layer {i}"
    out_g = FramePipeline(feature).step(f4)
    out_c = FramePipeline(feature_cpu, device="cpu").step(f4c)
    kg, kc = out_g[0], out_c[0]
    assert torch.equal(kg.valid.cpu(), kc.valid), "valid"
    for name in ("size", "response", "octave"):
        assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
    gx, gy = ulp_gap(kg.x, kc.x), ulp_gap(kg.y, kc.y)
    assert gx <= 1 and gy <= 1, (gx, gy)
    v = kc.valid
    th_g, _ = theta_of(kg.angle.cpu())
    th_c, raw_c = theta_of(kc.angle)
    agree = (th_g == th_c) | ~v
    n_desc, n_flip = int(v.sum()), int((~agree).sum())
    assert n_desc > 0 and (n_desc - n_flip) / n_desc >= 0.999, (n_flip, n_desc)
    edge = (raw_c - torch.round(raw_c)).abs() < 1e-3
    assert bool(edge[~agree].all()), "theta flip away from a bin edge"
    dg, dc = out_g[1].cpu(), out_c[1]
    assert torch.equal(dg[agree], dc[agree]), "descriptors where theta agrees"
    if n_flip == 0:
        assert torch.equal(out_g[2].cpu(), out_c[2]) and torch.equal(out_g[3].cpu(), out_c[3])
    print(
        f"[gpu vs cpu] B=4: pyramid, scores, masks, candidates, accepts, valid bitwise; "
        f"x/y within {max(gx, gy)} ULP; theta agrees on {n_desc - n_flip}/{n_desc} "
        f"described keypoints ({n_flip} bin-edge flips); descriptors bitwise where theta agrees",
        flush=True,
    )

    # ---- The README quick start, through PGM files, counted.
    quick_start(dev)

    # ---- The 16-bit pipeline, the facade's knobs and the AST path, each counted.
    u16_phase(dev, card)
    facade_phase(dev, card)
    ast_phase(dev, card, kind)
    v1_row = v1_phase(dev, card, kind)
    camera_phase(dev, card, kind)
    vo_phase(dev, card, kind)
    ckpt_phase(dev, card, kind)
    utils_phase(dev, card, kind, feature, pipe, frames16)
    dist_phase(dev, card, kind, feature, pipe, frames16)
    examples_phase(dev, card, kind)

    # ---- The gather probes P1, P3 and P2: every call of the 26 pallas_call
    # sites at full size, its kernel counted (once per call) and bitwise
    # against its plain version.
    probe_records = probe_cases.run_all(dev, card)
    probe_rows = probe_cases.kernel_rows(probe_records)
    for row in probe_rows:
        if row["name"] in ("probe_transpose_chain", "probe_relayout", "probe_take"):
            lib = row["library_device_ms"]
            print(f"[probes] {row['name']}: device {row['device_ms']:.4f} ms against its "
                  f"library calls' {lib:.4f} ms ({row['device_ms'] / lib:.3f}x) over "
                  f"{row['launches']} calls [{card}]", flush=True)

    # ---- Timing.
    stage_names = ["pyramid", "harris", "masks", "candidates", "uniformity", "refine",
                   "describe", "match"]

    for batch in (16, 128):
        frames = torch.from_numpy(bench_frames(batch)).to(dev)
        # In turns (default, fused, fused, default), so the two compare in one call.
        for label, p in (("step", pipe), ("fused step", fused_pipe),
                         ("fused step", fused_pipe), ("step", pipe)):
            torch.cuda.reset_peak_memory_stats()
            ms, _, stages = timed_steps(p, frames, stage_names)
            peak = torch.cuda.max_memory_allocated() / 2**30
            stage_txt = ", ".join(f"{n} {t:.3f}" for n, t in stages.items())
            print(
                f"[timing] {label} B={batch}: median {ms:.3f} ms of 10 (3 warm-up), "
                f"{batch / ms * 1e3:.1f} frames/s; stages ms: {stage_txt}; "
                f"uniformity share {stages['uniformity'] / ms:.1%}; peak mem {peak:.2f} GiB "
                f"[{kind}; {card}]",
                flush=True,
            )
        pyr = scale_space.build_pyramid(frames, 4)
        calls = capture_sampler_inputs(lambda: feature.describe(frames, feature.detect(frames)))
        k1_ms = cuda_time(lambda: harris_score_i32_layers(pyr))
        k1_plain = cuda_time(lambda: [harris_score_i32(p) for p in pyr])
        k2_ms = cuda_time(lambda: [smoothed_intensity_cuda(*a) for a in calls])
        k2_plain = cuda_time(lambda: [smoothed_intensity(*a) for a in calls])
        k3_ms = cuda_time(lambda: harris_score_mask_layers(pyr, thr))
        k3_plain = cuda_time(lambda: [harris_score_mask_i32(p, thr) for p in pyr])
        k1_nms = cuda_time(lambda: [maxima2d_mask(s, thr) for s in harris_score_i32_layers(pyr)])
        # The kernels' own time on the card, each step's launches from a cold L2.
        k1_dev = measure.device_time(lambda: harris_score_i32_layers(pyr), dev,
                                     ("harris_rows_kernel",))
        k2_dev = measure.device_time(lambda: [smoothed_intensity_cuda(*a) for a in calls], dev,
                                     ("k2_sampler_kernel",))
        k3_dev = measure.device_time(lambda: harris_score_mask_layers(pyr, thr), dev,
                                     ("harris_mask_rows_kernel",))
        # Bounds: K1 reads 1 B and writes 4 B per pixel, K3 one more byte.
        pixels = sum(p.numel() for p in pyr)
        k1_bound = measure.bound_ms(5 * pixels, int32_ops=K1_OPS_PER_PIXEL * pixels)
        k3_bound = measure.bound_ms(6 * pixels, int32_ops=K3_OPS_PER_PIXEL * pixels)
        k2_bnd = k2_bound(calls)
        print(
            f"[timing] kernels B={batch}, per step (K1, K3: 4 layers, {pixels} pixels; K2: 2 "
            f"phases, K={calls[0][3].shape[0]}): K1 {k1_ms:.3f} ms (device {k1_dev:.4f} ms) vs "
            f"plain {k1_plain:.3f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]}); K2 "
            f"{k2_ms:.3f} ms (device {k2_dev:.4f} ms) vs plain {k2_plain:.3f} ms, bound "
            f"{k2_bnd[0]:.4f} ms ({k2_bnd[1]}); K3 {k3_ms:.3f} ms (device {k3_dev:.4f} ms) vs "
            f"plain {k3_plain:.3f} ms vs K1 + maxima2d_mask {k1_nms:.3f} ms, bound "
            f"{k3_bound[0]:.4f} ms ({k3_bound[1]}) [{kind}; {card}]",
            flush=True,
        )
        if batch == 16:
            kernel_ms = dict(k1=(k1_ms, k1_plain, *k1_bound, k1_dev),
                             k2=(k2_ms, k2_plain, *k2_bnd, k2_dev),
                             k3=(k3_ms, k3_plain, *k3_bound, k3_dev))
        del frames, pyr, calls
        torch.cuda.empty_cache()

    # K1-K3 at the main path's B=16 shapes. No one PyTorch call computes
    # any of them (library_ms null).
    kernels = [
        dict(name=name, route="cuda", source=f"ethzasl_brisk_tpu_torch/csrc/{src}",
             replaces=replaces, launches=n, max_abs_err=err, ms=kernel_ms[key][0],
             device_ms=kernel_ms[key][4], plain_ms=kernel_ms[key][1],
             bound_ms=kernel_ms[key][2], bound_by=kernel_ms[key][3], library_ms=None)
        for name, src, replaces, n, err, key in (
            ("harris_score_i32", "harris.cu", "ethzasl_brisk_tpu/kernels/pallas_harris.py:54",
             launches["harris_score_i32"], k1_err, "k1"),
            ("smoothed_intensity", "sampler.cu",
             "ethzasl_brisk_tpu/describe/pallas_sampler.py:46",
             launches["smoothed_intensity"], k2_err, "k2"),
            ("harris_score_mask", "harris.cu",
             "ethzasl_brisk_tpu/kernels/pallas_harris.py:177",
             fused_launches["harris_score_mask"], k3_err, "k3"),
        )
    ] + [v1_row] + probe_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[wall] {time.perf_counter() - t_start:.1f} s from start to the kernels line", flush=True)
    print(f"[card] {card}", flush=True)
    # The run uses one card, whatever the machine holds.
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

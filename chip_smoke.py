"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels (K1 Harris, K2 sampler, K3 Harris +
2-D maxima, and the port's own: the orientation step and the elementwise
``atan2f`` and ``sincosf`` of ``angle.cu``, the BA's ordered
``segment_sum``) from ``ethzasl_brisk_tpu_torch/csrc`` and checks each
against its plain torch version at the shapes of the path that runs it
(K1 and K3 on the four pyramid layers in one launch, and on each alone).
Every comparison of the card with the CPU holds angles, rotation bins,
descriptors and matches bitwise. Then it drives these paths, each with
the launch counters set to 0 just before it and read just after:

* the main path, ``FramePipeline.step`` with the benchmark configuration
  on 16 VGA frames (K1 1 launch for the four pyramid layers, K2 2, the
  orientation 1), compared with the plain CPU step;
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
  that launch none of K1-K3 (the orientation kernel once, on the op-by-op
  chain), compared with a ``device="cpu"`` feature and timed per stage;
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
  frame taken as the distorted image (K1 1, K2 2, the orientation 1 an
  image; the grids' angle back-transform ``atan2f`` 1 and ``sincosf`` 1),
  against ``device="cpu"`` twins and timed per stage;
* the keyframed VO + BA loop (``[vo]``): ``vo.sequence.run_keyframed``, the
  counterpart of ``tools/kitti_eval.py`` with its defaults but the ``lm``
  solver, on 48 VGA frames of the synthetic VO scene, its frame-0 capacity
  certificate first (K1 once a frame and once for the certificate, K2
  twice a frame, K3 none, ``segment_sum`` 60 a BA solve); the same loop on
  a ``device="cpu"`` twin with the same RANSAC draws (detection bitwise on
  every frame, keyframes and BA runs equal, poses within tolerance); the
  8-point systems' SVD null vectors on the card; per-stage times a frame
  and a window, ATE and RPE; then the loop's last BA window alone
  (``[vo ba]``): two plain solves bitwise, its ms and kernels with the
  segment sums and with the ``index_add_`` scatters they replaced, in turns;
* the synthetic-sequence VO tools (``[vo tools]``): ``vo.synthetic``'s clean
  and stressed scenes on 24 frames against ``device="cpu"`` twins with the
  same draws, its command on 8 stressed frames, and ``vo.gen_sequence``'s
  sequence through ``vo.sequence_eval``'s command;
* the keyframed loop's checkpoints (``[ckpt]``): ``run_keyframed`` on the
  first 24 frames of the ``[vo]`` scene with a checkpoint every 2
  keyframes, stopped by an exception after 14 frames and resumed from its
  latest checkpoint, bitwise equal to an uninterrupted run, and two plain
  runs bitwise, deterministic algorithms off throughout; K1 and K2 counted
  on the resume;
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
                  "smoothed_intensity_v1", "brisk_orientation", "atan2f_elementwise",
                  "sincosf_elementwise", "segment_sum")
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
# [vo tools]: vo.synthetic's clean and stressed scenes (tools/synthetic_vo_bench.py,
# 200 frames, cut to fit the call with their CPU twins), its command on a
# few stressed frames, and vo.gen_sequence's sequence through vo.sequence_eval.
VO_TOOLS_FRAMES = 24
VO_TOOLS_CLI_FRAMES = 8
# The BA window's segment sums: five a Gauss-Newton step (B, C, g_pose,
# g_point, E), one step an LM iteration, kitti_eval's 12 iterations.
SEGMENT_SUMS_PER_SOLVE = 5 * 12
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
# Float operations of the angle chain (csrc/angle.cu): atanf 31 (the
# argument reduction 4, z and w 2, the two polynomials 11 and 9, their sum
# 1, the hi/lo tail 4), atan2f 3 more (y / x, the quadrant's two); the
# orientation step 3 more (the multiply, the fused multiply-add as 2).
ATAN2F_OPS = 34
ORIENTATION_OPS = ATAN2F_OPS + 3
# sincosf in float64: the reduction 4, r * s and r * r 2, the sine
# polynomial 8, the cosine polynomial 10.
SINCOSF_FP64_OPS = 24
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


def record_calls(module, name: str, calls: list):
    """Wrap ``module.name`` so each call's tensor arguments are cloned into
    ``calls``; returns the function that undoes it."""
    real = getattr(module, name)

    def record(*args, **kwargs):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args, **kwargs)

    setattr(module, name, record)
    return lambda: setattr(module, name, real)


def capture_sampler_inputs(run):
    """The smoothed_intensity arguments of both describe phases of ``run()``."""
    from ethzasl_brisk_tpu_torch.describe import extractor

    calls = []
    undo = record_calls(extractor, "smoothed_intensity_fused", calls)
    try:
        run()
    finally:
        undo()
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


def launches_of(**counts) -> dict:
    """The system kernels' launch counts a path expects: ``counts``, 0 for
    every other kernel."""
    assert set(counts) <= set(SYSTEM_KERNELS), counts
    return {k: counts.get(k, 0) for k in SYSTEM_KERNELS}


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
    assert launches["brisk_orientation"] == 2, launches

    ref, ref_match = run(BriskFeature(**QUICK_CONFIG, max_candidates=cap, device="cpu"), imgs)
    gap, n_valid = 0, []
    for (kg, dg), (kc, dc) in zip(out, ref):
        assert kg.x.dim() == 1 and dg.shape == (kg.capacity, 12), "unbatched outputs"
        assert torch.equal(kg.valid.cpu(), kc.valid), "quick start valid"
        for name in ("size", "response", "octave"):
            assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
        gap = max(gap, ulp_gap(kg.x, kc.x), ulp_gap(kg.y, kc.y))
        assert torch.equal(kg.angle.cpu(), kc.angle), "quick start angle"
        assert torch.equal(dg.cpu(), dc), "quick start descriptors"
        assert bool(torch.isfinite(kg.x).all())
        n_valid.append(int(kc.valid.sum()))
    assert gap <= 1, gap
    assert min(n_valid) > 0
    for g, c in zip(match, ref_match):
        assert torch.equal(g.cpu(), c), "quick start matches"
    ms = measure.cuda_time(lambda: feature.detect_and_compute(gpu_imgs[0]), reps=5, warmup=1)
    print(
        f"[quick start] 2 VGA PGM images: candidates {counts} -> certified cap {cap}; "
        f"valid keypoints {n_valid}; launches {launches}; GPU vs CPU: valid bitwise, x/y "
        f"within {gap} ULP, angles, descriptors and matches bitwise "
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


def assert_same_image_outputs(got, ref, what: str) -> int:
    """One image's (KeyPoints, words) on the card against the CPU: every
    field, the angle included, and the descriptors bitwise. Returns the
    valid count."""
    (kg, dg), (kc, dc) = got, ref
    for name, a, b in zip(("x", "y", "size", "angle", "response", "octave", "valid"),
                          kg.fields(), kc.fields()):
        assert torch.equal(a.cpu(), b), f"{what}: {name}"
    assert torch.equal(dg.cpu(), dc), f"{what}: descriptors"
    return int(kc.valid.sum())


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
    # No K1-K3 (float maps, the float sampler): the orientation kernel only,
    # on the op-by-op chain.
    assert launches == launches_of(brisk_orientation=1), f"[u16] launches: {launches}"
    assert not any(v for k, v in _kernels.LAUNCHES.items() if k != "brisk_orientation")
    assert got[0].x.device == dev and got[1].shape == (got[0].capacity, 12)
    assert bool(torch.isfinite(got[0].x).all())
    ref = BriskFeature(**U16_CONFIG, max_candidates=cap, device="cpu").detect_and_compute(frame)
    n_valid = assert_same_image_outputs(got, ref, "[u16]")
    assert n_valid > 0
    ms, stages = stage_times(feature, img)
    stage_txt = ", ".join(f"{n} {t:.3f}" for n, t in stages.items())
    print(
        f"[u16] VGA uint16 frame: candidates {diag.cand_counts.tolist()} -> certified cap "
        f"{cap}; valid keypoints {n_valid}; launches {launches}; GPU vs CPU: every field, the "
        f"angle included, and the descriptors bitwise; "
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
    # angle_exact: the host's double atan2, no orientation kernel.
    assert launches["brisk_orientation"] == 0, launches
    ref = BriskFeature(**kw, device="cpu").compute(
        frame, KeyPoints.from_numpy(x, y, size, angle, capacity=1024, device="cpu"))
    n_given = assert_same_image_outputs(got, ref, "[facade] from_numpy")
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
    n64 = assert_same_image_outputs(got, ref, "[facade] float64")
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


def assert_same_step_outputs(got, ref, what: str) -> int:
    """A step on the card against the CPU: every keypoint field, the angle
    included, the descriptors and the matches bitwise. Returns the valid
    count."""
    kg, kc = got[0], ref[0]
    for name in ("x", "y", "size", "angle", "response", "octave", "valid"):
        assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), f"{what}: {name}"
    for i, name in ((1, "descriptors"), (2, "match index"), (3, "match distance")):
        assert torch.equal(got[i].cpu(), ref[i]), f"{what}: {name}"
    return int(kc.valid.sum())


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
    assert launches == launches_of(smoothed_intensity=2, brisk_orientation=1), launches
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
    n_valid = assert_same_step_outputs(got, ref, "[ast] gpu vs cpu")
    assert n_valid > 0

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
    print(f"[ast] gpu vs cpu B=4: every keypoint field, the angle included, descriptors and "
          f"matches bitwise, {n_valid} valid; launches {launches4}. compute_scale of frame 0's "
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
    assert launches == launches_of(smoothed_intensity_v1=8, brisk_orientation=4), launches
    n_fac = 0
    for i, g in enumerate(got):
        assert g[1].shape == (g[0].capacity, 16), g[1].shape
        n_fac += assert_same_image_outputs(g, det_cpu.detect_and_compute(host[i]),
                                           f"[v1] facade frame {i}")
    assert n_fac > 0

    # ---- The AST step at B=16: v2 rounding (the JAX step passes no
    # v1_rounding), a 512-bit match with sentinel 513.
    pipe = AstFramePipeline(det, **AST_PIPELINE)
    step, launches_step = counted(lambda: pipe.step(frames, with_diagnostics=True))
    assert launches_step == launches_of(smoothed_intensity=2, brisk_orientation=1), launches_step
    kps, desc, midx, mdist, diag = step
    assert desc.shape[-1] == 16 and bool(diag["detect"].ok.all())
    assert int(diag["describable"]) <= AST_PIPELINE["describe_capacity"] * V1_BATCH
    assert torch.equal(mdist == 513, ~kps.valid[1:]), "[v1] sentinel 513 where query invalid"
    assert int(mdist.max()) <= 513
    ref = AstFramePipeline(det_cpu, device="cpu", **AST_PIPELINE).step(host)
    n_step = assert_same_step_outputs(step[:4], ref, "[v1] step gpu vs cpu")
    assert n_step > 0

    # ---- The Harris feature with the v1 extractor on one frame.
    feat = BriskFeature(**BENCH_CONFIG, version="v1")
    hg, launches_h = counted(lambda: feat.detect_and_compute(host[0]))
    assert launches_h == launches_of(harris_score_i32=1, smoothed_intensity_v1=2,
                                     brisk_orientation=1), launches_h
    n_h = assert_same_image_outputs(
        hg, BriskFeature(**BENCH_CONFIG, version="v1", device="cpu").detect_and_compute(host[0]),
        "[v1] BriskFeature")
    assert n_h > 0
    print(f"[v1] detect_and_compute on 4 frames: launches {launches}, {n_fac} valid; "
          f"AstFramePipeline B={V1_BATCH}: launches {launches_step}, {n_step} valid, describable "
          f"{int(diag['describable'])}, 512-bit match; BriskFeature(version='v1') on frame 0: "
          f"launches {launches_h}, {n_h} valid; each against a device='cpu' twin: every field, "
          f"the angle included, descriptors and matches bitwise [{card}]", flush=True)

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


def own_kernel_row(name: str, source: str, replaces: str, launches: int, run, plain, library,
                   kernel_names: tuple, nbytes: float, fp32_ops: float = 0.0,
                   fp64_ops: float = 0.0) -> dict:
    """A kernels-line row for one of the port's own kernels (no TPU
    counterpart): ``run()`` on the card against ``plain()`` on the CPU,
    bit for bit (tuples of tensors, NaN equal to NaN), then the kernel,
    the plain version on the card and the library call (or None) timed by
    CUDA events, the kernel's device time, and the bound of ``nbytes`` and
    the operations."""
    from ethzasl_brisk_tpu_torch import measure

    got, ref = run(), plain(cpu=True)
    got, ref = (got if isinstance(got, tuple) else (got,)), (ref if isinstance(ref, tuple) else (ref,))
    err = 0.0
    for g, r in zip(got, ref):
        g = g.cpu()
        eq = g == r
        if g.dtype.is_floating_point:
            assert bool((eq | (g.isnan() & r.isnan())).all()), f"{name} differs from plain"
            bits = {4: torch.int32, 8: torch.int64}[g.element_size()]
            assert torch.equal(g.view(bits)[eq], r.view(bits)[eq]), f"{name}: signed zeros"
            fin = g.isfinite() & r.isfinite()
            if bool(fin.any()):
                err = max(err, float((g[fin].double() - r[fin].double()).abs().max()))
        else:
            assert bool(eq.all()), f"{name} differs from its plain version"
            err = max(err, float((g.double() - r.double()).abs().max()) if g.numel() else 0.0)
    bnd = measure.bound_ms(nbytes, fp32_ops=fp32_ops, fp64_ops=fp64_ops)
    dev = got[0].device
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=err, ms=measure.cuda_time(run),
                device_ms=measure.device_time(run, dev, kernel_names),
                plain_ms=measure.cuda_time(plain), bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=None if library is None else measure.cuda_time(library))


def camera_phase(dev: torch.device, card: str, kind: str) -> list:
    """The camera-aware path on a VGA bench frame taken as the distorted
    image: two grids and the single view, counted, against the CPU, timed.
    Returns the rows of the angle kernels the radial-tangential grid ran."""
    from ethzasl_brisk_tpu_torch import BriskFeature, measure
    from ethzasl_brisk_tpu_torch.core import atan2f as atan2f_mod
    from ethzasl_brisk_tpu_torch.core import sincosf as sincosf_mod
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.geometry import (
        EquidistantDistortion,
        PinholeCamera,
        RadialTangentialDistortion,
        camera_aware,
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
    expect = launches_of(harris_score_i32=1, smoothed_intensity=2, brisk_orientation=1,
                         atan2f_elementwise=1, sincosf_elementwise=1)
    atan2_calls, sincos_calls, grid_launches = [], [], {}
    for name, cam in cams.items():
        t0 = time.perf_counter()
        grid = CameraAwareFeatureGrid(cam, feature)
        build_s = time.perf_counter() - t0
        grid_cpu = CameraAwareFeatureGrid(cam, feature_cpu, device="cpu")
        undo = [record_calls(camera_aware, "atan2f", atan2_calls),
                record_calls(camera_aware, "sincosf", sincos_calls)]
        try:
            got, launches = counted(lambda: grid.detect_and_compute(host))
        finally:
            for u in undo:
                u()
        assert launches == expect, (name, launches)
        grid_launches[name] = launches
        assert got[1].shape == (got[0].capacity, 12) and bool(torch.isfinite(got[0].angle).all())
        n = assert_same_image_outputs(got, grid_cpu.detect_and_compute(host), f"[camera] {name} grid")
        assert n > 0
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
              f"launches {launches}; {n} valid, GPU vs CPU: every field, the angle included, "
              f"and the descriptors bitwise; detect_and_compute median "
              f"{statistics.median(totals):.3f} ms, min {min(totals):.3f} of 10 (3 warm-up); "
              f"stages ms: {stage_txt}; peak mem {peak:.3f} GiB [{kind}; {card}]", flush=True)

    single = CameraAwareFeature(cams["radtan"], feature)
    got, launches = counted(lambda: single.detect_and_compute(host))
    assert launches == launches_of(harris_score_i32=1, smoothed_intensity=2,
                                   brisk_orientation=1), launches
    ref = CameraAwareFeature(cams["radtan"], feature_cpu).detect_and_compute(host)
    assert torch.equal(got[2].cpu(), ref[2]), "[camera] single view warp"
    n = assert_same_image_outputs(got[:2], ref[:2], "[camera] single view")
    ms = measure.cuda_time(lambda: single.detect_and_compute(img))
    print(f"[camera] single view (radtan): launches {launches}; warp bitwise, {n} valid, every "
          f"field, the angle included, and the descriptors bitwise; detect_and_compute median "
          f"{ms:.3f} ms of 10 [{kind}; {card}]", flush=True)

    # The angle kernels at the radial-tangential grid's shapes (its calls come first).
    (y, x), (a_rad,) = atan2_calls[0], sincos_calls[0]
    n_el = x.numel()
    rows = [
        own_kernel_row(
            "atan2f_elementwise", "ethzasl_brisk_tpu_torch/csrc/angle.cu",
            "none: the port's own (glibc's float32 atan2, which jnp.arctan2 takes on the CPU; "
            "ethzasl_brisk_tpu/geometry/camera_aware.py:533)",
            grid_launches["radtan"]["atan2f_elementwise"],
            lambda: atan2f_mod.atan2f_cuda(y, x),
            lambda cpu=False: atan2f_mod.atan2f_plain(*((y.cpu(), x.cpu()) if cpu else (y, x))),
            lambda: torch.atan2(y, x), ("atan2f_elementwise_kernel",),
            nbytes=12 * n_el, fp32_ops=ATAN2F_OPS * n_el),
        own_kernel_row(
            "sincosf_elementwise", "ethzasl_brisk_tpu_torch/csrc/angle.cu",
            "none: the port's own (glibc's float32 sin and cos, which jnp.sin and jnp.cos take "
            "on the CPU; ethzasl_brisk_tpu/geometry/camera_aware.py:529-530)",
            grid_launches["radtan"]["sincosf_elementwise"],
            lambda: sincosf_mod.sincosf_cuda(a_rad),
            lambda cpu=False: sincosf_mod.sincosf_plain(a_rad.cpu() if cpu else a_rad),
            None, ("sincosf_elementwise_kernel",),
            nbytes=12 * n_el, fp64_ops=SINCOSF_FP64_OPS * n_el),
    ]
    for row in rows:
        print(f"[camera] {row['name']} on the grid's {n_el} keypoints: bitwise vs plain; "
              f"{row['ms']:.4f} ms (device {row['device_ms']:.4f} ms) vs plain "
              f"{row['plain_ms']:.4f} ms, library "
              f"{'none' if row['library_ms'] is None else format(row['library_ms'], '.4f') + ' ms'}, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}) [{kind}; {card}]", flush=True)
    return rows


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


def vo_phase(dev: torch.device, card: str, kind: str) -> dict:
    """The keyframed VO + window-BA loop on a VGA synthetic sequence,
    counted, against a CPU twin, timed per stage; then one of its BA windows
    alone (``ba_window``). Returns the segment_sum kernel's row."""
    import numpy as np

    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.vo import frontend, sequence
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

    windows = []
    undo = record_calls(sequence, "solve_window_ba_lm", windows)
    frontend.VoFrontend.process_frame = recording
    try:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        got, launches = counted(lambda: run_keyframed(
            frames, cam, gt, draw=shared_draw(VO_DRAW_SEED), mark=mark, **VO_FLAGS))
        loop_s = time.perf_counter() - t0
        undo()
        card_frames = list(recorded)
        recorded.clear()
        t0 = time.perf_counter()
        ref = run_keyframed(frames, cam, gt, draw=shared_draw(VO_DRAW_SEED), device="cpu",
                            **VO_FLAGS)
        cpu_s = time.perf_counter() - t0
        cpu_frames = list(recorded)
    finally:
        undo()
        frontend.VoFrontend.process_frame = process
    assert got["capacity_ok"] and ref["capacity_ok"]
    # K1 once a frame and once for the frame-0 certificate, K2 twice and
    # the orientation once a frame, the segment sums 60 a BA solve.
    expect = launches_of(harris_score_i32=VO_FRAMES + 1, smoothed_intensity=2 * VO_FRAMES,
                         brisk_orientation=VO_FRAMES,
                         segment_sum=SEGMENT_SUMS_PER_SOLVE * len(windows))
    assert launches == expect, launches
    assert len(card_frames) == len(cpu_frames) == VO_FRAMES
    n_valid = [assert_same_image_outputs(g, c, f"[vo] frame {i}")
               for i, (g, c) in enumerate(zip(card_frames, cpu_frames))]
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
    print(f"[vo] card vs CPU twin (same draws): detection, angles and descriptors bitwise on "
          f"every frame; keyframes, BA runs and rejects equal; camera centres within "
          f"{centre_gap:.2e}, rotations within {rot_gap:.2e}", flush=True)
    print(f"[vo timing] loop {loop_s:.2f} s on the card ({loop_s / VO_FRAMES * 1e3:.1f} ms a "
          f"frame), CPU twin {cpu_s:.2f} s; median ms a frame (detect, match, ransac, refine, "
          f"kf_verify) and a window (build_ba on the host, ba_solve) by CUDA events: "
          f"{stage_txt}; first 16 frames {head_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"(idle {1 - busy_ms / head_ms:.1%}) [{kind}; {card}]", flush=True)
    return ba_window(windows[-1], launches["segment_sum"], card, kind)


def device_kernels(fn) -> int:
    """The kernels the card ran in one call of fn() (after a warm-up call),
    counted in a ``torch.profiler`` trace (copies and sets not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return sum(1 for n in names if not n.startswith(("Memcpy", "Memset")))


def ba_window(window, segment_launches: int, card: str, kind: str) -> dict:
    """One LM window of the [vo] loop alone: two plain solves bitwise; its
    ms and kernels with the ordered segment sums and, in turns in this
    call, with the index_add_ scatters they replaced; the segment_sum
    kernel against its plain version on one Gauss-Newton step's five sums.
    Returns its kernels-line row."""
    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.ba import segment, window as bw

    (prob,) = window  # the loop passes the problem, and kitti_eval's settings as keywords
    solve_kw = dict(iterations=12, damping=1e-2, fix_poses=2, huber_delta=3.0)

    def solve():
        return bw.solve_window_ba_lm(prob, **solve_kw)

    runs = [solve() for _ in range(2)]
    for a, b in zip((runs[0][0].r, runs[0][0].t, runs[0][0].points, runs[0][1]),
                    (runs[1][0].r, runs[1][0].t, runs[1][0].points, runs[1][1])):
        assert torch.equal(a, b), "[vo ba] two plain solves differ"

    # The scatters the segment sums replaced: index_add_ over every
    # observation by the raw index (padded rows on keyframe and landmark 0).
    k, n_lm = prob.r.shape[0], prob.points.shape[0]
    raw = {k: prob.kf_idx, n_lm: prob.lm_idx, n_lm * k: prob.lm_idx * k + prob.kf_idx}

    def index_add(values, plan):
        out = torch.zeros((plan.n, *values.shape[1:]), dtype=values.dtype, device=values.device)
        return out.index_add_(0, raw[plan.n], values)

    real = bw.segment_sum
    res = {"segment sums": [], "index_add_": []}
    for label in ("segment sums", "index_add_", "index_add_", "segment sums"):
        bw.segment_sum = real if label == "segment sums" else index_add
        try:
            res[label].append((measure.cuda_time(solve), device_kernels(solve)))
        finally:
            bw.segment_sum = real
    bw.segment_sum = index_add
    try:
        old = [solve() for _ in range(2)]
    finally:
        bw.segment_sum = real
    old_gap = float((old[0][0].t - old[1][0].t).abs().max())
    # One Gauss-Newton step's five sums, for the kernel's row.
    calls = []
    undo = record_calls(bw, "segment_sum", calls)
    try:
        bw._gauss_newton_step(prob, 1e-2, 2, 3.0)
    finally:
        undo()
    assert len(calls) == 5, len(calls)

    def on_cpu(plan):
        return segment.SegmentPlan(plan.key.cpu(), plan.order.cpu(), plan.offsets.cpu(), plan.n)

    # The rows the sums read: the plans' kept observations (the padded,
    # invalid ones are dropped), each with its order entry; the offsets;
    # the sums written.
    nbytes = ops = 0
    for values, plan in calls:
        width, kept = values[0].numel(), int(plan.offsets[-1])
        nbytes += ((kept * width + plan.n * width) * values.element_size() + 8 * kept
                   + 8 * plan.offsets.numel())
        ops += kept * width
    row = own_kernel_row(
        "segment_sum", "ethzasl_brisk_tpu_torch/csrc/segment_sum.cu",
        "none: the port's own (the BA's scatter-adds, which the JAX package leaves to XLA; "
        "ethzasl_brisk_tpu/ba/window.py)",
        segment_launches,
        lambda: tuple(segment.segment_sum_cuda(v, p) for v, p in calls),
        lambda cpu=False: tuple(segment.segment_sum_plain(v.cpu(), on_cpu(p)) if cpu
                                else segment.segment_sum_plain(v, p) for v, p in calls),
        lambda: tuple(index_add(v, p) for v, p in calls), ("segment_sum_kernel",),
        nbytes=nbytes, fp32_ops=ops if calls[0][0].dtype == torch.float32 else 0.0,
        fp64_ops=ops if calls[0][0].dtype == torch.float64 else 0.0)
    txt = "; ".join(f"{label} {', '.join(f'{ms:.3f} ms / {n} kernels' for ms, n in v)}"
                    for label, v in res.items())
    print(f"[vo ba] the loop's last LM window ({prob.r.shape[0]} keyframes, "
          f"{prob.points.shape[0]} landmark slots, {prob.kf_idx.shape[0]} observation slots, "
          f"{prob.r.dtype}, 12 iterations): two plain solves bitwise (deterministic algorithms "
          f"off; with index_add_ they differ by {old_gap:.3g} in t); a solve by CUDA events "
          f"(median of 10) and its kernels, in turns: {txt}. segment_sum on one step's five "
          f"sums: bitwise vs the CPU's index_add_; {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f} ms) vs plain {row['plain_ms']:.4f} ms and index_add_ "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']}) "
          f"[{kind}; {card}]", flush=True)
    return row


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
    """run_keyframed with checkpoints on the card: two plain runs bitwise,
    then one stopped partway as a crash would stop it and resumed from its
    latest checkpoint, bitwise equal to an uninterrupted run."""
    import numpy as np

    from ethzasl_brisk_tpu_torch.utils.checkpoint import CheckpointManager
    from ethzasl_brisk_tpu_torch.vo.sequence import run_keyframed

    frames, cam, gt = vo_scene(CKPT_FRAMES)
    assert not torch.are_deterministic_algorithms_enabled()
    # Two plain runs, bitwise: the BA's segment sums add in one order.
    runs = [run_keyframed(frames, cam, gt, device=dev, **VO_FLAGS) for _ in range(2)]
    assert np.array_equal(runs[0]["poses"], runs[1]["poses"]), "[ckpt] two plain runs differ"
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
    resumed_at = steps[-1]
    frames_run = CKPT_FRAMES - resumed_at
    expect = launches_of(harris_score_i32=frames_run + 1, smoothed_intensity=2 * frames_run,
                         brisk_orientation=frames_run, segment_sum=launches["segment_sum"])
    assert launches == expect, (launches, expect)
    assert launches["segment_sum"] % SEGMENT_SUMS_PER_SOLVE == 0, launches
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
          f"{save_ms:.1f} ms; deterministic algorithms off throughout, and two plain runs' "
          f"poses bitwise equal [{kind}; {card}]", flush=True)


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


def vo_tools_phase(dev: torch.device, card: str, kind: str) -> None:
    """``vo.synthetic``'s clean and stressed runs on the card, counted,
    against CPU twins with the same draws; its command on a few stressed
    frames; ``vo.gen_sequence``'s sequence through ``vo.sequence_eval``'s
    command.

    Detection, angles and descriptors are held bitwise on every frame and
    every step's rotation within the [vo] phase's 0.02; both runs are held
    to the rest of that bar (aligned centres within 5 % of the path, the
    ATE within 1 %). On a weak pair of the stressed run the card's and the
    CPU's float32 SVDs (cuSOLVER, LAPACK), apart in the last digits, lead
    to another translation (step 11 of 24, measured: the sign flipped and
    0.25 off the CPU's step negated). So one step may be apart: its
    translation is printed, not bounded, and the bar holds the card's
    trajectory with the CPU's translation put in at that step alone."""
    import contextlib
    import io

    import numpy as np

    from ethzasl_brisk_tpu_torch.vo import frontend, gen_sequence, sequence_eval, synthetic
    from ethzasl_brisk_tpu_torch.vo.evaluate import umeyama_alignment

    recorded = []
    process = frontend.VoFrontend.process_frame

    def recording(self, img):
        out = process(self, img)
        recorded.append(out)
        return out

    n = VO_TOOLS_FRAMES
    for stress in (False, True):
        label = "stress, --normalize-exposure" if stress else "clean"
        t0 = time.perf_counter()
        frames, poses = synthetic.render_frames(n, stress=stress)
        render_s = time.perf_counter() - t0
        frontend.VoFrontend.process_frame = recording
        try:
            t0 = time.perf_counter()
            est, launches = counted(lambda: synthetic.run(
                frames, stress, dev, draw=shared_draw(VO_DRAW_SEED)))
            card_s = time.perf_counter() - t0
            card_frames = list(recorded)
            recorded.clear()
            t0 = time.perf_counter()
            ref = synthetic.run(frames, stress, "cpu", draw=shared_draw(VO_DRAW_SEED))
            cpu_s = time.perf_counter() - t0
            cpu_frames = list(recorded)
            recorded.clear()
        finally:
            frontend.VoFrontend.process_frame = process
        assert launches == launches_of(harris_score_i32=n, smoothed_intensity=2 * n,
                                       brisk_orientation=n), launches
        assert len(card_frames) == len(cpu_frames) == n
        for i, (g, c) in enumerate(zip(card_frames, cpu_frames)):
            assert_same_image_outputs(g, c, f"[vo tools] {label} frame {i}")
        got, exp = synthetic.evaluate(est, poses), synthetic.evaluate(ref, poses)
        path = got["path_length"]
        est_a, ref_a = np.stack(est), np.stack(ref)
        assert np.isfinite(est_a).all()
        # The tool's poses take unit steps: compare the camera centres as
        # its ATE does, each run similarity-aligned onto the ground truth.
        gt_c = np.stack([-(r.T @ t) for r, t in poses])
        aligned = []
        for a in (est_a, ref_a):
            sc, rot, tr = umeyama_alignment(a[:, :3, 3], gt_c)
            aligned.append((sc * (rot @ a[:, :3, 3].T)).T + tr)
        centre_gap = float(np.abs(aligned[0] - aligned[1]).max())
        # Each step's relative motion on the card against the CPU's.
        rel = [np.linalg.inv(a[:-1]) @ a[1:] for a in (est_a, ref_a)]
        rot_gap = float(np.abs(rel[0][:, :3, :3] - rel[1][:, :3, :3]).max())
        t_gap = np.linalg.norm(rel[0][:, :3, 3] - rel[1][:, :3, 3], axis=1)
        flips = [int(i) + 1 for i in np.flatnonzero(t_gap > 0.1)]
        assert rot_gap <= 0.02, (label, rot_gap)
        assert len(flips) <= int(stress), (label, flips)
        held, held_ate, neg = centre_gap, got["ate"], []
        if flips:
            # Every other step is held: the card's trajectory with the
            # CPU's translation at the step apart, to the bar.
            (j,) = [s - 1 for s in flips]
            neg = [round(float(np.linalg.norm(rel[0][j, :3, 3] + rel[1][j, :3, 3])), 4)]
            steps = rel[0].copy()
            steps[j, :3, 3] = rel[1][j, :3, 3]
            fixed = [est_a[0]]
            for m in steps:
                fixed.append(fixed[-1] @ m)
            sc, rot, tr = umeyama_alignment(np.stack(fixed)[:, :3, 3], gt_c)
            held = float(np.abs((sc * (rot @ np.stack(fixed)[:, :3, 3].T)).T + tr
                                - aligned[1]).max())
            held_ate = synthetic.evaluate(fixed, poses)["ate"]
        # The [vo] phase's bar.
        assert held <= 0.05 * path, (label, held, flips)
        assert abs(held_ate - exp["ate"]) <= 0.01 * path, (label, held_ate, exp["ate"], flips)
        print(f"[vo tools] vo.synthetic {label}, {n} VGA frames (rendered on the host in "
              f"{render_s:.2f} s): launches {launches}; detection, angles and descriptors "
              f"bitwise the CPU twin's (same draws) on every frame; steps' rotations within "
              f"{rot_gap:.2e}, translation directions within {float(t_gap.max()):.3g} "
              f"(steps apart by more than 0.1: {flips}, from the CPU's step negated {neg}); "
              f"aligned camera centres within {centre_gap:.2e}, {held:.2e} with the CPU's "
              f"translation at those steps; ATE "
              f"{got['ate']:.5f}, {held_ate:.5f} so (CPU {exp['ate']:.5f}) on a {path:.3f} "
              f"path, RPE-t {got['rpe_t']:.5f}; {card_s / n * 1e3:.1f} ms a frame on the card, "
              f"CPU twin {cpu_s:.2f} s [{kind}; {card}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        json_out = os.path.join(tmp, "line.json")
        argv = ["--frames", str(VO_TOOLS_CLI_FRAMES), "--stress", "--json-out", json_out]
        with contextlib.redirect_stdout(out):
            assert synthetic.main(argv) == 0
        lines = out.getvalue().splitlines()
        line = json.loads(lines[-1])
        assert set(line) == {"metric", "value", "unit", "frames", "path_length",
                             "ate_pct_of_path"}, line
        assert line["metric"] == "synthetic_vo_ate_rmse_simaligned_stress", line
        assert line["frames"] == VO_TOOLS_CLI_FRAMES and np.isfinite(line["value"]), line
        with open(json_out) as f:
            assert f.read() == lines[-1] + "\n"
        seq = os.path.join(tmp, "seq")
        with contextlib.redirect_stdout(io.StringIO()):
            assert gen_sequence.main([seq, "--frames", str(VO_TOOLS_CLI_FRAMES)]) == 0
        out = io.StringIO()
        eval_argv = [seq, "--gt", os.path.join(seq, "poses.txt"), "--gt-format", "kitti",
                     "--fu", "400", "--fv", "400", "--cu", "320", "--cv", "240"]
        with contextlib.redirect_stdout(out):
            _, eval_launches = counted(lambda: sequence_eval.main(eval_argv))
        evals = out.getvalue().splitlines()
        assert evals[0].startswith(f"integrated {VO_TOOLS_CLI_FRAMES} poses; path length "), evals
        assert evals[1].startswith("ATE RMSE (sim-aligned): "), evals
        assert np.isfinite(float(evals[1].split(": ")[1])), evals
        assert eval_launches == launches_of(
            harris_score_i32=VO_TOOLS_CLI_FRAMES, smoothed_intensity=2 * VO_TOOLS_CLI_FRAMES,
            brisk_orientation=VO_TOOLS_CLI_FRAMES), eval_launches
    print(f"[vo tools] python -m ethzasl_brisk_tpu_torch.vo.synthetic {' '.join(argv[:3])} on "
          f"the card: {lines[-1]}; vo.gen_sequence {VO_TOOLS_CLI_FRAMES} frames through "
          f"vo.sequence_eval on the card: {evals[0]}; {evals[1]}; launches {eval_launches} "
          f"[{kind}; {card}]", flush=True)


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
    from ethzasl_brisk_tpu_torch.describe import extractor, orientation
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

    # ---- The main path, counted; the orientation kernel's inputs kept.
    orient_calls = []
    undo = record_calls(extractor, "orientation", orient_calls)
    try:
        torch.cuda.synchronize()
        _kernels.reset_launches()
        kps, desc, midx, mdist, diag = pipe.step(frames16, with_diagnostics=True)
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
    finally:
        undo()
    assert launches["harris_score_i32"] == 1, launches
    assert launches["smoothed_intensity"] == 2, launches
    assert launches["brisk_orientation"] == 1 and len(orient_calls) == 1, launches
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
    assert torch.equal(kg.angle.cpu(), kc.angle), "angle"
    n_desc = int(kc.valid.sum())
    assert n_desc > 0
    for i, name in ((1, "descriptors"), (2, "match index"), (3, "match distance")):
        assert torch.equal(out_g[i].cpu(), out_c[i]), name
    print(
        f"[gpu vs cpu] B=4: pyramid, scores, masks, candidates, accepts, valid bitwise; "
        f"x/y within {max(gx, gy)} ULP; the angles of all {n_desc} described keypoints, "
        f"descriptors and matches bitwise",
        flush=True,
    )

    # ---- The README quick start, through PGM files, counted.
    quick_start(dev)

    # ---- The 16-bit pipeline, the facade's knobs and the AST path, each counted.
    u16_phase(dev, card)
    facade_phase(dev, card)
    ast_phase(dev, card, kind)
    v1_row = v1_phase(dev, card, kind)
    camera_rows = camera_phase(dev, card, kind)
    segment_row = vo_phase(dev, card, kind)
    vo_tools_phase(dev, card, kind)
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

    # ---- The orientation kernel at the main path's B=16 shapes.
    o_args = orient_calls[0]
    n_kp = o_args[0].numel()
    orientation_row = own_kernel_row(
        "brisk_orientation", "ethzasl_brisk_tpu_torch/csrc/angle.cu",
        "none: the port's own (the angle chain the JAX package leaves to XLA, jnp.arctan2; "
        "ethzasl_brisk_tpu/describe/extractor.py:1061-1068)",
        launches["brisk_orientation"],
        lambda: orientation.orientation_cuda(*o_args),
        lambda cpu=False: orientation.orientation_plain(
            *(t.cpu() if cpu and torch.is_tensor(t) else t for t in o_args)),
        lambda: torch.atan2(o_args[1].float(), o_args[0].float()), ("brisk_orientation_kernel",),
        nbytes=25 * n_kp, fp32_ops=ORIENTATION_OPS * n_kp)
    print(f"[orientation] B=16 step, {n_kp} keypoint slots: bitwise vs plain; "
          f"{orientation_row['ms']:.4f} ms (device {orientation_row['device_ms']:.4f} ms) vs plain "
          f"{orientation_row['plain_ms']:.4f} ms and torch.atan2 {orientation_row['library_ms']:.4f} "
          f"ms, bound {orientation_row['bound_ms']:.6f} ms ({orientation_row['bound_by']}) "
          f"[{kind}; {card}]", flush=True)

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
    ] + [v1_row, orientation_row] + camera_rows + [segment_row] + probe_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[wall] {time.perf_counter() - t_start:.1f} s from start to the kernels line", flush=True)
    print(f"[card] {card}", flush=True)
    # The run uses one card, whatever the machine holds.
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

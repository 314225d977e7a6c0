"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py
    cd TREE && python3 /path/to/chip_smoke.py --time-steps   # that tree's step only

Builds the hand-written CUDA kernels (K1 Harris, K2 sampler, K3 Harris +
2-D maxima, and the port's own: ``describe_rotated`` of ``describe.cu``,
the whole uint8 describe in one launch; the orientation
step, the elementwise ``atan2f`` and ``sincosf`` and the camera grid's
``walk_angles`` of ``angle.cu``; the BA's ordered segment sums, a call
site's sums in one launch, of ``segment_sum.cu``; greedy uniformity,
every layer of a detection in one launch, ``enforce_uniformity`` of
``uniformity.cu``; the integer candidate masks, the 2-D maxima and the
3-D checks of every layer of a detection in one launch, ``score_masks`` of
``masks.cu``; the score-ordered candidate lists of every layer in one
launch, ``layer_candidates`` of ``candidates.cu``; the compaction, taps,
sub-pixel fit and packing of every layer in one launch,
``refine_keypoints`` of ``refine.cu``; the batched steps' adjacent-frame
match, XOR, popcount and the first index of the minimum over every pair in
one launch, ``hamming_argmin`` of ``match.cu``; every derived uint8
pyramid layer in one launch, ``pyramid_u8`` of ``pyramid.cu``) from
``ethzasl_brisk_tpu_torch/csrc`` and checks each against its plain torch
version at the shapes of the path that runs it (K1 and K3 on the four
pyramid layers in one launch, and on each alone; K2 on the unrotated
and the rotated taps ``describe_rotated`` samples, the rotation from the
plain chain; ``describe_rotated`` in every phase that describes uint8
frames; ``enforce_uniformity`` in every counted run that detects with a
uniformity radius, against its blocked plain version on the card;
``score_masks``, ``layer_candidates`` and ``refine_keypoints`` at odd
shapes and at the main step's layers, default and fused;
``hamming_argmin`` on the B=16 and B=128 steps' descriptors, the AST step's
K, v1's 16 words at 512 and 384 bits and odd cases; ``pyramid_u8`` on the
steps' frames, the AST step's 6 layers and odd shapes). Beside them it
builds yardsticks that the port never calls:
the earlier two-launch describe's second kernel (a warp a keypoint, after
K2's unrotated samples) and ``describe.cu`` with its words a ballot a
word, each timed in turns against ``describe_rotated``, and an empty
kernel, whose device time is the floor under any launch's.
Every comparison of the card with the CPU holds angles, rotation bins,
descriptors and matches bitwise. Then it drives these paths, each with
the launch counters set to 0 just before it and read just after:

* the main path, ``FramePipeline.step`` with the benchmark configuration
  on 16 VGA frames (``pyramid_u8`` 1 launch for layers 1-3, K1 1 for the
  four pyramid layers, ``score_masks`` 1, ``layer_candidates`` 1,
  ``enforce_uniformity`` 1, ``refine_keypoints`` 1, ``describe_rotated`` 1,
  ``hamming_argmin`` 1 for the 15 pairs, K2 and the orientation kernel 0),
  compared with the plain CPU step;
* the fused path, the same step with ``fused_mask=True`` (K3 1 launch for
  the four layers, ``score_masks`` 1 on K3's masks, K1 0,
  ``describe_rotated`` 1, K2 0), bit-equal to the main path;
* the README quick start: two VGA frames written and read back as PGM,
  ``BriskFeature(octaves=0, ..., fused_mask=True).detect_and_compute`` on
  each host image (the entry point moves it to the card) and
  ``radius_match_best`` (K3 once per image; ``score_masks`` none: one
  layer, K3's mask is the answer), compared with the same calls on a
  ``device="cpu"`` feature;
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
  certificates first (``describe_rotated``, ``pyramid_u8`` and
  ``hamming_argmin`` 1 launch each, K1, K2 and K3 none);
  4 frames on the card
  against a ``device="cpu"`` pipeline, ``compute_scale`` of frame 0's
  keypoints and the ``exact`` cache model on frame 0, each against the CPU;
  the step timed at batch 16 and 80 per stage, and K2 at the AST shapes
  and ``describe_rotated`` against their plain versions, the latter in turns
  with the two-launch describe it replaced;
* the v1 engine (``[v1]``): ``BriskFeatureDetector(version="v1")`` on VGA
  bench frames, its caps certified first; ``detect_and_compute`` on 4
  frames (the v1-rounding variant of ``describe_rotated`` 1 launch a
  frame), ``AstFramePipeline`` at batch 16 (v2 rounding, as the JAX step,
  and a 512-bit match: ``hamming_argmin`` 1; v1's resamplers stay torch
  ops, so ``pyramid_u8`` 0), ``BriskFeature(version="v1")`` on one frame (K1 1,
  ``describe_rotated`` v1 1) and with ``angle_exact=True`` (K2 v1 2), each
  against a ``device="cpu"`` twin; K2's v1 variant against its plain
  version and its bound, and the v1 step timed per stage;
* the camera-aware path (``[camera]``): ``CameraAwareFeatureGrid`` on a
  radial-tangential and an equidistant VGA camera and the single-view
  ``CameraAwareFeature``, with the benchmark's ``BriskFeature``, on a bench
  frame taken as the distorted image (K1 1, ``describe_rotated`` 1 an
  image; the grids' angle back-transform ``walk_angles`` 1, the elementwise
  ``atan2f`` and ``sincosf`` 0), against ``device="cpu"`` twins and timed
  per stage, the angles stage in turns with the torch chain the kernel
  replaced;
* the keyframed VO + BA loop (``[vo]``): ``vo.sequence.run_keyframed``, the
  counterpart of ``tools/kitti_eval.py`` with its defaults but the ``lm``
  solver, on 48 VGA frames of the synthetic VO scene, its frame-0 capacity
  certificate first (K1 once a frame and once for the certificate,
  ``describe_rotated`` once a frame, K2 and K3 none, ``segment_sum`` 12 a
  BA solve); one frame's describe in turns with the two-launch describe;
  the same loop on
  a ``device="cpu"`` twin with the same RANSAC draws (detection bitwise on
  every frame, keyframes and BA runs equal, poses within tolerance); the
  8-point systems' SVD null vectors on the card; per-stage times a frame
  and a window, ATE and RPE; then the loop's last BA window alone
  (``[vo ba]``): two plain solves bitwise, its ms and kernels with the
  grouped segment sums, with the earlier staged body (a block a segment,
  a launch a sum) and with the ``index_add_`` scatters they replaced, in
  turns; the add-latency probe behind the sums' chain bound;
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
  knn bitwise the dense knn, ``FramePipeline(mesh=...)`` counted (K1 1,
  ``describe_rotated`` 1) and bitwise the plain step, the AST step over
  it (``describe_rotated`` 1) bitwise the
  plain AST step, the distributed BA and pose graph within
  1e-9 of the single-card solvers in float64 and within the JAX tests' bars
  in float32, the ``worker`` command's run and the dry run;
* the examples (``[examples]``): ``live_pipeline`` over 9 VGA bench frames
  written as PGM (K1 3, ``describe_rotated`` 2), its ``batch`` lines
  equal to a
  ``--device cpu`` run's, and ``cameras_demo`` on the card;
* the gather probes (``ethzasl_brisk_tpu_torch.probes``): each of the 39
  calls through the 26 ``pallas_call`` sites of the TPU probes P1, P3 and
  P2 at full size, its kernel (G1, G2, C, W, T, X or S) launched once,
  counted, and held bitwise against its plain version; each kernel and its
  library yardstick timed by CUDA events and by the profiler's device time,
  and the kernels T, C and G1 summed against theirs (``t + 8``,
  ``.clone()`` and ``torch.gather``).

Every uint8 Harris detection in these paths launches ``score_masks``
once, beside its K1 or K3 launch (the VO loop's, the tools', the
examples', the camera grid's and the facades' too); the 16-bit and AST
paths launch it never. Every uint8 detection of more than one layer, AST
but not v1 included, launches ``pyramid_u8`` once; every batched step,
``hamming_argmin`` once (the VO front-end, the quick start's and the
examples' other matchers keep the matmul). ``[match]`` holds the match
kernel bitwise against its plain version (the +-1 matmul route) on the
steps' descriptors and odd cases, prints each route's peak memory at
B=128, and times the two in turns beside the popcount bound and the int8
tensor-core figure; ``[pyramid]`` holds the pyramid kernel bitwise against
the resamplers on the steps' frames, the AST step's 6 layers, odd shapes
and unaligned and strided frames, and times the two in turns beside the
bytes bound; ``[floor]`` times an empty kernel. ``[masks]`` holds it bitwise against the plain
chain at 61 x 83 and 96 x 130 (noise, flat, sharp boxes; thresholds 0 and
20) and at the B=16 and B=128 step's layers, default and fused, prints its
staged bytes and CTAs an SM, and times the two in turns beside the bound. Every Harris detection, the
16-bit one included, launches ``layer_candidates`` and ``refine_keypoints``
once each; the AST paths never. ``[candidates]`` holds the first bitwise
against its plain version at odd shapes, at the B=16 and B=128 step's
layers (default, fused, its device-memory route, a tenth of the caps,
C = 1) and on VGA maps at a cluster of 16, prints each check's plan (C,
routes, radix passes run and skipped, shared bytes, CTAs an SM), and times
it in turns with its other cluster sizes, the plain version and
``torch.sort``; ``[refine]`` holds the second bitwise in float32 and
float64 at odd shapes, on the steps' refine inputs (without compaction,
with no and with every accept, and with accepts only in the last 1,024
flags of each list too) and on a VGA list past a chunk, prints its plan
(threads, chunks a list and chunks ranked, the shared slot table, shared
bytes, registers, spill and CTAs an SM), and times it in turns with its
tail case and the plain version, with the wrapper's host time split.
Both steps are timed at batch 16 and 128 with per-stage CUDA events, in
turns (default, fused, blocked, blocked, fused, default; "blocked" is the
default step with the blocked uniformity path in the kernel's place), and
each kernel against its plain version and beside its bound, by CUDA events
and by its own device time; ``[uniformity]`` sets the kernel's routes
(the grid route as the main path takes it, the candidates route it
replaced) against the
blocked path in turns at B=16, B=128, B=16 at radius 10 (the candidates
route's own traffic), ``[u16]`` and a camera-grid image,
each bitwise (and the grid twin on the card too), with each route's
rounds, cycles a round, shared memory and CTAs an SM, the round-latency
probe, the chain bound and the host time of a call. Any failed check raises; the last line is a
JSON object with ``"ok": true``. Needs one CUDA card; without one it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import threading
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
                  "smoothed_intensity_v1", "describe_rotated", "describe_rotated_v1",
                  "brisk_orientation", "atan2f_elementwise", "sincosf_elementwise",
                  "walk_angles", "segment_sum", "enforce_uniformity", "score_masks",
                  "layer_candidates", "refine_keypoints", "hamming_argmin", "pyramid_u8")
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
# The BA window's segment sums: one launch a Gauss-Newton step for its
# five sums (B, C, g_pose, g_point, E), one step an LM iteration,
# kitti_eval's 12 iterations.
SEGMENT_SUMS_PER_SOLVE = 12
# [utils]: the published H100 SXM dense TF32 and bfloat16 matmul peaks
# (NVIDIA's data sheet, 700 W), printed beside the measured ones with the
# float32 and HBM peaks that measure.bound_ms keeps (datasheet_peaks).
DATASHEET_TENSOR_GFLOPS = dict(peak_gflops_tf32=495e3, peak_gflops_bf16=989e3)
# Every enforce_uniformity launch inside a counted run is held bitwise
# against enforce_uniformity_plain on the card (install_uniformity_check);
# one detection's problem sets a configuration, for the [uniformity] turns.
UNIFORMITY_CHECKS = {"on": False, "launches": 0, "masks": 0, "grid layers": 0}
UNIFORMITY_INPUTS = {}
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
# walk_angles a keypoint (csrc/angle.cu): degrees to radians 1, the walk 4,
# the fractions 2, six lerps of 3, the offsets 2, atan2f, the scale 1; and
# sincosf's float64 operations where it walks along an angle.
WALK_FP32_OPS = 1 + 4 + 2 + 6 * 3 + 2 + ATAN2F_OPS + 1
# Integer operations of kernel score_masks (csrc/masks.cu): a pixel's 2-D
# test 25 (the threshold and four border compares, 8 neighbour compares,
# their 12 ands); a 2-D survivor's probes 275 (six axis terms of 7: multiply,
# add, divide, multiply-subtract, two compares, and; ten bilinear sums of 11
# int64 operations, each counted as 2; the maximum of 9; two scalings and
# compares 4).
MASKS_OPS_PER_PIXEL = 25
MASKS_OPS_PER_SURVIVOR = 6 * 7 + 10 * 11 * 2 + 9 + 4
# Float operations of a slot of kernel refine_keypoints (csrc/refine.cu),
# in the refine type: the coefficients 55 (tmp1 5, coeff1 and coeff2 6
# each, tmp2-tmp4 5, coeff3 and coeff4 3 each, coeff5 4, coeff6 12, h_det
# 4, its guards 2), the corner 18 (four values of 3, three offsets, three
# compares), the interior and boundary deltas 32 (dx0 and dy0 7 each, four
# compares, two divisors of 3, two boundary deltas of 6), two quadratics of
# 14 and their compare 29, the selects 6, the un-mapping 8.
REFINE_OPS_PER_SLOT = 55 + 18 + 32 + 29 + 6 + 8
# An empty kernel, built beside the kernels as a yardstick the port never
# calls: its device time is the floor under any launch's.
EMPTY_KERNEL_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
# The earlier segment_sum body, the staged one (a block a segment, tiles
# of rows staged in shared memory, a launch a sum), built beside the
# kernels as the yardstick [vo ba] times the grouped kernel against; the
# port never calls it.
STAGED_SEGMENT_SUM_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 128;
constexpr int kTileBytes = 40 * 1024;  // under the 48 KB a block takes without opting in

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void staged_segment_sum_kernel(const T* __restrict__ values, const int64_t* __restrict__ order,
                                   const int64_t* __restrict__ offsets, T* __restrict__ out,
                                   int width, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int64_t seg = blockIdx.x;
  const int c0 = blockIdx.y * kThreads;                      // this block's first component
  const int cw = width - c0 < kThreads ? width - c0 : kThreads;  // and its count
  const int64_t begin = offsets[seg], end = offsets[seg + 1];
  const int c = threadIdx.x;  // the component this thread adds (c < cw)
  T acc = T(0);
  for (int64_t base = begin; base < end; base += tile_rows) {
    const int rows = static_cast<int>(end - base < tile_rows ? end - base : tile_rows);
    for (int e = threadIdx.x; e < rows * cw; e += kThreads) {
      const int r = e / cw;
      tile[e] = values[order[base + r] * width + c0 + (e - r * cw)];
    }
    __syncthreads();
    if (c < cw) {
      for (int r = 0; r < rows; ++r) acc = add_rn(acc, tile[r * cw + c]);
    }
    __syncthreads();
  }
  if (c < cw) out[seg * width + c0 + c] = acc;
}

}  // namespace

extern "C" int staged_segment_sum(const void* values, const void* order, const void* offsets,
                                 void* out, int n_seg, int width, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ord = static_cast<const int64_t*>(order);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int elem = is_double ? 8 : 4;
  const int cw = width < kThreads ? width : kThreads;
  const int tile_rows = kTileBytes / (cw * elem) < kTileRows ? kTileBytes / (cw * elem) : kTileRows;
  const size_t smem = static_cast<size_t>(tile_rows) * cw * elem;
  const dim3 grid(static_cast<unsigned>(n_seg), static_cast<unsigned>((width + kThreads - 1) / kThreads));
  if (is_double) {
    staged_segment_sum_kernel<double><<<grid, kThreads, smem, s>>>(
        static_cast<const double*>(values), ord, off, static_cast<double*>(out), width, tile_rows);
  } else {
    staged_segment_sum_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(values), ord, off, static_cast<float*>(out), width, tile_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
# The earlier describe's second kernel (a warp a keypoint after K2's
# unrotated samples, vals0; the int64 pair tables staged by every CTA; a
# persistent grid of 8 CTAs an SM), built beside the kernels with
# csrc/ on the include path: with K2's phase-1 launch and its five LUT-row
# gathers it is the two-launch describe that [timing], [ast] and [vo] time
# describe_rotated against. The port never calls it.
WARP_DESCRIBE_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

#include "angle.cuh"
#include "launch.cuh"
#include "sampler.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // what a block can opt in to on Hopper

size_t smem_bytes(int P, int L, int n_bits) {
  return sizeof(int32_t) * (2 * (size_t)L + (size_t)kWarps * P) +
         sizeof(int16_t) * (2 * (size_t)L + 2 * (size_t)n_bits);
}

template <bool V1>
__global__ void __launch_bounds__(kThreads) warp_describe_kernel(
    const int32_t* __restrict__ integral, int cols, int frame_rows,
    const int32_t* __restrict__ vals0, const int64_t* __restrict__ scale_idx,
    const uint8_t* __restrict__ valid, const float* __restrict__ given,
    const float* __restrict__ key_x, const float* __restrict__ key_y,
    const int32_t* __restrict__ row_base, const float* __restrict__ lut_x,
    const float* __restrict__ lut_y, const float* __restrict__ lut_sigma,
    const int32_t* __restrict__ lut_scaling, const int32_t* __restrict__ lut_scaling2,
    const int64_t* __restrict__ long_i, const int64_t* __restrict__ long_j,
    const int32_t* __restrict__ long_wdx, const int32_t* __restrict__ long_wdy, int L,
    const int64_t* __restrict__ short_i, const int64_t* __restrict__ short_j, int n_bits,
    float* __restrict__ angle_out, int32_t* __restrict__ desc, int K, int P, int n_rot, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_wdx = reinterpret_cast<int32_t*>(smem);
  int32_t* s_wdy = s_wdx + L;
  int32_t* s_vals = s_wdy + L;
  int16_t* s_li = reinterpret_cast<int16_t*>(s_vals + kWarps * P);
  int16_t* s_lj = s_li + L;
  int16_t* s_si = s_lj + L;
  int16_t* s_sj = s_si + n_bits;
  const bool rotate = vals0 != nullptr;
  if (rotate) {
    for (int l = threadIdx.x; l < L; l += kThreads) {
      s_li[l] = static_cast<int16_t>(long_i[l]);
      s_lj[l] = static_cast<int16_t>(long_j[l]);
      s_wdx[l] = long_wdx[l];
      s_wdy[l] = long_wdy[l];
    }
  }
  for (int b = threadIdx.x; b < n_bits; b += kThreads) {
    s_si[b] = static_cast<int16_t>(short_i[b]);
    s_sj[b] = static_cast<int16_t>(short_j[b]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = cols + 1;
  int32_t* buf = s_vals + warp * P;
  for (int k = blockIdx.x * kWarps + warp; k < K; k += gridDim.x * kWarps) {
    const float g = given[k];
    float a = g;
    int64_t theta = 0;
    if (rotate) {
      const int32_t* v0 = vals0 + (size_t)k * P;
      for (int p = lane; p < P; p += 32) buf[p] = v0[p];
      __syncwarp();
      uint32_t s0 = 0, s1 = 0;
      for (int l = lane; l < L; l += 32) {
        const uint32_t dt = (uint32_t)buf[s_li[l]] - (uint32_t)buf[s_lj[l]];
        s0 += (uint32_t)((int32_t)(dt * (uint32_t)s_wdx[l]) / 1024);
        s1 += (uint32_t)((int32_t)(dt * (uint32_t)s_wdy[l]) / 1024);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s0 += __shfl_xor_sync(kFull, s0, o);
        s1 += __shfl_xor_sync(kFull, s1, o);
      }
      if (g == -1.0f) a = orientation_angle((int32_t)s0, (int32_t)s1, false);
      theta = rotation_bin(a, n_rot, false);
      __syncwarp();  // every lane has read the phase-1 values
    }
    const int th = (int)(theta < 0 ? 0 : (theta >= n_rot ? n_rot - 1 : theta));
    const int64_t s = scale_idx[k];
    const float kx = key_x[k], ky = key_y[k];
    const int32_t* frame = integral + (size_t)row_base[k] * stride;
    const float* px = lut_x + ((size_t)s * n_rot + th) * P;
    const float* py = lut_y + ((size_t)s * n_rot + th) * P;
    for (int p = lane; p < P; p += 32) {
      const size_t sp = (size_t)s * P + p;
      const Geom geo = geometry(kx, ky, __ldg(px + p), __ldg(py + p), __ldg(lut_sigma + sp));
      buf[p] = point_value<V1>(frame, stride, geo, frame_rows, cols, __ldg(lut_scaling + sp),
                               __ldg(lut_scaling2 + sp));
    }
    __syncwarp();
    const bool ok = valid[k] != 0;
    uint32_t mine = 0;
    for (int w = 0; w < W; ++w) {
      const int b = 32 * w + lane;
      const uint32_t word = __ballot_sync(kFull, b < n_bits && buf[s_si[b]] > buf[s_sj[b]]);
      if (lane == (w & 31)) mine = word;
      if ((w & 31) == 31 || w == W - 1) {
        const int first = w & ~31;
        if (lane <= w - first) desc[(size_t)k * W + first + lane] = ok ? (int32_t)mine : 0;
      }
    }
    if (lane == 0) angle_out[k] = a;
    __syncwarp();  // every lane has read the rotated values
  }
}

int resident_blocks() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return (sms[dev] > 0 ? sms[dev] : 1) * (2048 / kThreads);
}

}  // namespace

extern "C" int warp_describe_rotated(
    const void* integral, int cols, int frame_rows, const void* vals0, const void* scale_idx,
    const void* valid, const void* given, const void* key_x, const void* key_y,
    const void* row_base, const void* lut_x, const void* lut_y, const void* lut_sigma,
    const void* lut_scaling, const void* lut_scaling2, const void* long_i, const void* long_j,
    const void* long_wdx, const void* long_wdy, int L, const void* short_i, const void* short_j,
    int n_bits, void* angle, void* desc, int K, int P, int n_rot, int W, int v1_rounding,
    void* stream) {
  const size_t smem = smem_bytes(P, L, n_bits);
  if (n_rot != 1024 || P < 1 || P > 32767 || L < 0 || n_bits < 0 || W * 32 < n_bits ||
      smem > (size_t)kMaxSmem || (long long)(frame_rows + 1) * (cols + 1) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const int want = (K + kWarps - 1) / kWarps;
  const int cap = resident_blocks();
  const int grid = want < cap ? want : cap;
  auto kernel = v1_rounding ? warp_describe_kernel<true> : warp_describe_kernel<false>;
  return (int)launch(kernel, grid, kThreads, (int)smem, (cudaStream_t)stream,
                     (const int32_t*)integral, cols, frame_rows, (const int32_t*)vals0,
                     (const int64_t*)scale_idx, (const uint8_t*)valid, (const float*)given,
                     (const float*)key_x, (const float*)key_y, (const int32_t*)row_base,
                     (const float*)lut_x, (const float*)lut_y, (const float*)lut_sigma,
                     (const int32_t*)lut_scaling, (const int32_t*)lut_scaling2,
                     (const int64_t*)long_i, (const int64_t*)long_j, (const int32_t*)long_wdx,
                     (const int32_t*)long_wdy, L, (const int64_t*)short_i,
                     (const int64_t*)short_j, n_bits, (float*)angle, (int32_t*)desc, K, P,
                     n_rot, W);
}
"""
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


def k2_taps(call) -> tuple[torch.Tensor, int, int]:
    """One K2 call's (flat integral indices of the taps its points read,
    int32 operations, float32 operations), from the branch each point
    takes."""
    from ethzasl_brisk_tpu_torch.describe.sampler import _tap_geometry

    integral, key_x, key_y, pat_x, pat_y, pat_sigma, _, _, row_base, frame_rows, *v1 = call
    used = {}
    for name, taps in K2_TAPS.items():
        used[name] = torch.zeros((6, 6), dtype=torch.bool, device=integral.device)
        for i, j in taps:
            used[name][i, j] = True
    k, p = pat_x.shape
    cols = integral.shape[1] - 1
    g = _tap_geometry(key_x, key_y, pat_x, pat_y, pat_sigma)
    rows = torch.clamp(g["row_coords"], 0, frame_rows).to(torch.int64)
    rows = (rows + row_base.to(torch.int64)[:, None, None]) * (cols + 1)
    flat = rows[..., :, None] + torch.clamp(g["col_coords"], 0, cols).to(torch.int64)[..., None, :]
    small, big = g["small"][..., None, None], g["big"][..., None, None]
    need = torch.where(small, used["small"], torch.where(big, used["big"], used["box"]))
    n_small = int(g["small"].sum())
    int_ops = K2_OPS_SMALL[0] * n_small + K2_OPS_BOX[0] * (k * p - n_small)
    if v1 and v1[0]:
        int_ops += K2_V1_EXTRA["small"] * n_small + K2_V1_EXTRA["box"] * (k * p - n_small)
    fp_ops = K2_OPS_SMALL[1] * n_small + K2_OPS_BOX[1] * (k * p - n_small)
    return flat[need], int_ops, fp_ops


def k2_work(call) -> tuple[int, int, int]:
    """One K2 call's (distinct integral sector bytes its taps read, int32
    operations, float32 operations)."""
    from ethzasl_brisk_tpu_torch import measure

    flat, int_ops, fp_ops = k2_taps(call)
    return measure.distinct_sector_bytes(flat, 4, call[0].numel()), int_ops, fp_ops


def k2_bound(calls) -> tuple[float, str]:
    """K2's bound over the describe phases' inputs: the integral sectors
    the taps read, the keypoint and pattern inputs and the output, and the
    operations of the branch each point takes."""
    from ethzasl_brisk_tpu_torch import measure

    nbytes = int_ops = fp_ops = 0
    for call in calls:
        k, p = call[3].shape
        taps, ints, fps = k2_work(call)
        nbytes += 3 * 4 * k + 6 * 4 * k * p + taps
        int_ops += ints
        fp_ops += fps
    return measure.bound_ms(nbytes, int32_ops=int_ops, fp32_ops=fp_ops)


def phase1_args(rot) -> tuple:
    """K2's arguments at the unrotated pattern of a ``describe_rotated``
    call, ``lut_x[scale_idx, 0]``: what the two-launch describe's K2 launch
    sampled, and where ``describe_rotated`` samples phase 1."""
    from ethzasl_brisk_tpu_torch.describe.rotated import rotated_sampler_args

    pat, integral, rows, _, sidx, _, _, key_x, key_y, row_base, v1 = rot
    return rotated_sampler_args(pat, integral, rows, sidx, 0, key_x, key_y, row_base, v1)


def plain_rotation_of(rot):
    """The plain chain's (angle, theta) for a ``describe_rotated`` call's
    keypoints, on the CPU, from the phase-1 values K2 gives on the card
    (bitwise its plain version's, checked in every phase that calls this)."""
    from ethzasl_brisk_tpu_torch.describe.rotated import plain_rotation
    from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity_fused

    vals0 = smoothed_intensity_fused(*phase1_args(rot)) if rot[3] else None
    pat, vals0, sidx, angle = to_cpu((rot[0], vals0, rot[4], rot[6]))
    return plain_rotation(pat, vals0, sidx, angle)


def rotated_k2_args(rot) -> tuple:
    """K2's arguments at the rotated pattern of a ``describe_rotated`` call,
    ``lut_x[scale_idx, theta]`` with theta from the plain chain: the taps
    the kernel samples, for holding K2 against its plain version there."""
    from ethzasl_brisk_tpu_torch.describe.rotated import rotated_sampler_args

    pat, integral, rows, _, sidx, _, _, key_x, key_y, row_base, v1 = rot
    theta = plain_rotation_of(rot)[1].to(sidx.device)
    return rotated_sampler_args(pat, integral, rows, sidx, theta, key_x, key_y, row_base, v1)


def describe_rotated_work(rot) -> tuple[int, int, int]:
    """``describe_rotated``'s work on a call's inputs, for its bound: bytes of the keypoints'
    inputs, the packed pair tables, the distinct LUT rows its keypoints take
    (theta 0 where phase 1 runs, and theta), the distinct integral sectors
    both samplings touch (their union, as ``k2_bound`` counts one call's)
    and the outputs; operations of the sampling (K2's per branch, phase 1
    only where the angle is computed), the gradient and the chain there, and
    the comparisons. Returns (bytes, int32 ops, float32 ops)."""
    from ethzasl_brisk_tpu_torch import measure

    pat, integral, rotate, sidx, angle = rot[0], rot[1], rot[3], rot[4], rot[6]
    k = sidx.numel()
    n_rot, p = pat.lut_x.shape[1:]
    n_long, n_bits = pat.long_i.numel(), pat.short_i.numel()
    words = pat.descriptor_words
    theta = plain_rotation_of(rot)[1]
    flat, int_ops, fp_ops = k2_taps(rotated_k2_args(rot))
    rows = sidx.cpu() * n_rot + theta
    if rotate:
        need = angle == -1.0
        p1 = phase1_args(rot)  # the integral, 8 per-keypoint tensors, frame_rows, v1
        flat1, ints1, fps1 = k2_taps((p1[0], *(a[need] for a in p1[1:9]), *p1[9:]))
        flat = torch.cat([flat, flat1])
        n_need = int(need.sum())
        int_ops += ints1 + 7 * n_long * n_need  # a difference, two products, two divisions, two adds
        fp_ops += fps1 + ORIENTATION_OPS * n_need
        rows = torch.cat([rows, sidx[need].cpu() * n_rot])
    taps = measure.distinct_sector_bytes(flat, 4, integral.numel())
    lut_rows = int(torch.unique(rows).numel())
    scales = int(torch.unique(sidx.cpu()).numel())
    nbytes = (25 * k + 4 * (3 * n_long + n_bits) + 8 * p * lut_rows + 12 * p * scales + taps
              + (4 + 4 * words) * k)
    int_ops += n_bits * k  # the comparisons
    return nbytes, int_ops, fp_ops


def record_calls(module, name: str, calls: list):
    """Wrap ``module.name`` so each call's tensor arguments are cloned into
    ``calls``; returns the function that undoes it."""
    real = getattr(module, name)

    def record(*args, **kwargs):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return real(*args, **kwargs)

    setattr(module, name, record)
    return lambda: setattr(module, name, real)


def capture_describe(run):
    """The ``describe_rotated`` call of ``run()``'s describe (its arguments)
    and K2's arguments at the taps it samples: phase 1 (``phase1_args``) and
    the rotated pattern (``rotated_k2_args``)."""
    from ethzasl_brisk_tpu_torch.describe import extractor

    rot_calls = []
    undo = record_calls(extractor, "describe_rotated", rot_calls)
    try:
        run()
    finally:
        undo()
    assert len(rot_calls) == 1, len(rot_calls)
    rot = rot_calls[0]
    return [phase1_args(rot), rotated_k2_args(rot)], rot


def install_uniformity_check():
    """Wrap ``detect.uniformity.enforce_uniformity_cuda`` so that, while
    ``uniformity_checked()`` is on, each call's masks are held bitwise
    against ``enforce_uniformity_plain`` on the same inputs on the card.
    Returns the kernel's own wrapper, which the timings call."""
    from ethzasl_brisk_tpu_torch.detect import uniformity

    real = uniformity.enforce_uniformity_cuda

    def checked(problems, *, radius, shapes=None, rounds=False, route="auto"):
        problems = list(problems)
        out = real(problems, radius=radius, shapes=shapes, rounds=rounds, route=route)
        if UNIFORMITY_CHECKS["on"]:
            for mask, (xs, ys, scores, valid, cap) in zip(out[0] if rounds else out, problems):
                ref = uniformity.enforce_uniformity_plain(xs, ys, scores, valid, radius=radius,
                                                          max_num_kpt=cap)
                assert torch.equal(mask, ref), "enforce_uniformity differs from its plain version"
                UNIFORMITY_CHECKS["masks"] += 1
            UNIFORMITY_CHECKS["launches"] += 1
            UNIFORMITY_CHECKS["grid layers"] += sum(
                uniformity.layer_plan(p[0].shape[1], shape, radius, route,
                                      uniformity.launch_staging(problems))[0] == "grid"
                for p, shape in zip(problems, shapes or [None] * len(problems)))
        return out

    uniformity.enforce_uniformity_cuda = checked
    return real


@contextlib.contextmanager
def uniformity_checked():
    """Hold every ``enforce_uniformity`` launch of the block against its
    plain version (``install_uniformity_check``)."""
    UNIFORMITY_CHECKS["on"] = True
    try:
        yield
    finally:
        UNIFORMITY_CHECKS["on"] = False


def capture_uniformity(run):
    """(problem sets, cloned; radius; the layers' shapes) of the one
    uniformity call of ``run()``'s detection
    (``scale_space.enforce_uniformity_layers``)."""
    from ethzasl_brisk_tpu_torch.detect import scale_space

    calls = []
    real = scale_space.enforce_uniformity_layers

    def record(problems, *, radius, block=256, shapes=None):
        problems = list(problems)
        calls.append(([tuple(t.clone() if torch.is_tensor(t) else t for t in p)
                       for p in problems], radius, shapes))
        return real(problems, radius=radius, block=block, shapes=shapes)

    scale_space.enforce_uniformity_layers = record
    try:
        run()
    finally:
        scale_space.enforce_uniformity_layers = real
    assert len(calls) == 1, len(calls)
    return calls[0]


def blocked_uniformity(problems, *, radius, block=256, shapes=None):
    """The blocked plain version in ``enforce_uniformity_layers``' place:
    the step as it ran before the kernel, for the timing turns."""
    from ethzasl_brisk_tpu_torch.detect import uniformity

    return [uniformity.enforce_uniformity_plain(xs, ys, sc, v, radius=radius, max_num_kpt=cap,
                                                block=block)
            for xs, ys, sc, v, cap in problems]


def uniformity_work(problems, masks) -> tuple[int, int, int, int, int]:
    """(bytes, int32 ops, float32 ops, candidates, accepts) of one call:
    each candidate's x, y, score and valid read and its mask byte written
    once; the reference's paint of each accept."""
    from ethzasl_brisk_tpu_torch.utils.roofline import (
        UNIFORMITY_BYTES_PER_CANDIDATE,
        UNIFORMITY_PAINT_FP32_OPS,
        UNIFORMITY_PAINT_INT32_OPS,
    )

    cands = sum(p[0].numel() for p in problems)
    accepts = sum(int(m.sum()) for m in masks)
    return (UNIFORMITY_BYTES_PER_CANDIDATE * cands, UNIFORMITY_PAINT_INT32_OPS * accepts,
            UNIFORMITY_PAINT_FP32_OPS * accepts, cands, accepts)


# The kernel's routes in the [uniformity] turns, by the wrapper's keywords:
# the grid route as the main path takes it (its candidates staged in shared
# memory while the launch's CTAs fit the SMs, as at B=16, in device memory
# past that, as at B=128: launch_staging), and the candidates route, the
# kernel's earlier design, which the grid replaced.
UNIFORMITY_LAYOUTS = {"grid": dict(), "candidates": dict(route="candidates")}


def ctas_an_sm(shared: int, regs: int, dev, threads: int | None = None) -> int:
    """Resident CTAs of a kernel an SM (enforce_uniformity's unless
    ``threads`` is given): its threads, its registers and its shared
    memory (plus the 1 KB the card keeps a CTA) against the SM's."""
    from ethzasl_brisk_tpu_torch.detect import uniformity

    threads = threads or uniformity.WINDOW
    props = torch.cuda.get_device_properties(dev)
    smem_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
    limits = [props.max_threads_per_multi_processor // threads, smem_sm // (shared + 1024)]
    if regs:
        limits.append(65536 // (regs * threads))
    return min(limits)


def ptxas_numbers(regs: list) -> tuple[int, int]:
    """The largest register count and static shared bytes in ptxas lines."""
    import re

    def most(pattern):
        return max([int(m) for line in regs for m in re.findall(pattern, line)] or [0])

    return most(r"Used (\d+) registers"), most(r"(\d+) bytes smem")


def uniformity_turns(kernel, problems, radius, shapes, dev, regs: int) -> dict:
    """The kernel (one launch) on each route and the blocked plain version
    on the card on one detection's problem sets: bitwise (and against the
    grid twin on the card), then event / device ms of each in turns; each
    route's longest CTA's rounds, dynamic shared memory and CTAs an SM;
    the work and its bound."""
    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.detect import uniformity

    ref = blocked_uniformity(problems, radius=radius)
    for (xs, ys, sc, v, cap), shape, r in zip(problems, shapes, ref):
        twin = uniformity.enforce_uniformity_grid_plain(xs, ys, sc, v, rows=shape[0],
                                                        cols=shape[1], radius=radius,
                                                        max_num_kpt=cap)
        assert torch.equal(twin, r), "the grid twin differs from the blocked plain version"
    layouts, runs = {}, {}
    staging = uniformity.launch_staging(problems)
    for label, kw in UNIFORMITY_LAYOUTS.items():
        masks, rounds = kernel(problems, radius=radius, shapes=shapes, rounds=True, **kw)
        assert all(torch.equal(a, b) for a, b in zip(masks, ref)), \
            f"enforce_uniformity ({label}) differs from its plain version"
        plans = [uniformity.layer_plan(p[0].shape[1], shape, radius, kw.get("route", "auto"),
                                       staging) for p, shape in zip(problems, shapes)]
        shared = max(p[4] for p in plans)
        layouts[label] = dict(rounds=int(rounds.max()), shared=shared,
                              routes=[p[0] + ("" if p[3] else " (device-staged)") for p in plans],
                              ctas=ctas_an_sm(shared, regs, dev))
        runs[label] = lambda kw=kw: kernel(problems, radius=radius, shapes=shapes, **kw)
    runs["blocked"] = lambda: blocked_uniformity(problems, radius=radius)
    order = [*UNIFORMITY_LAYOUTS, "blocked"]
    times = {label: [] for label in order}
    for label in order + order[::-1]:
        names = None if label == "blocked" else ("uniformity_kernel",)
        times[label].append((measure.cuda_time(runs[label], reps=5, warmup=2),
                             measure.device_time(runs[label], dev, names, reps=5, warmup=1,
                                                 per_call=names and 1)))
    nbytes, int_ops, fp_ops, cands, accepts = uniformity_work(problems, ref)
    return dict(times=times, layouts=layouts, cands=cands, accepts=accepts,
                ks=[p[0].shape[1] for p in problems], frames=problems[0][0].shape[0],
                bound=measure.bound_ms(nbytes, int32_ops=int_ops, fp32_ops=fp_ops))


def uniformity_phase(dev, card: str, kind: str, kernel, launches: int, regs: list) -> dict:
    """[uniformity]: the kernel on each route against the blocked path in
    turns at each captured configuration (B=16, B=128, B=16 at radius 10,
    [u16], a camera-grid image), the round-latency probe and the chain bound, cycles a round, the
    checks made in the counted runs, the host time of a call; returns the
    kernel's row at the B=16 step's shapes."""
    import re

    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.detect import uniformity

    cycles = measure.round_latency_cycles(dev)
    assert 1.0 <= cycles <= 5000.0, cycles
    clock = measure.sm_clock_hz(dev)
    n_regs = max([int(m) for line in regs for m in re.findall(r"Used (\d+) registers", line)]
                 or [0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[uniformity] kernel enforce_uniformity ({uniformity.WINDOW} threads a CTA) ptxas: "
          f"{regs}; round-latency probe: {cycles:.2f} SM cycles a round with no accept (a "
          f"shared read, the ballot, a barrier, the reduction), SM clock max "
          f"{clock / 1e6:.0f} MHz, {sms} SMs; held bitwise against enforce_uniformity_plain on "
          f"the card in {UNIFORMITY_CHECKS['launches']} counted launches "
          f"({UNIFORMITY_CHECKS['masks']} layer masks, {UNIFORMITY_CHECKS['grid layers']} on "
          f"the grid route) [{kind}; {card}]", flush=True)
    assert UNIFORMITY_CHECKS["grid layers"] > 0, "no counted launch took the grid route"
    for label in ("B=16", "B=128", "B=16, radius 10", "[u16]", "[camera] radtan grid"):
        problems, radius, shapes = UNIFORMITY_INPUTS[label]
        t = uniformity_turns(kernel, problems, radius, shapes, dev, n_regs)
        txt = "; ".join(f"{lab} " + ", ".join(f"{e:.4f} / {d:.4f}" for e, d in v)
                        for lab, v in t["times"].items())
        lay = "; ".join(
            f"{lab}: longest CTA {v['rounds']} rounds, "
            f"{statistics.median(d for _, d in t['times'][lab]) * 1e-3 * clock / v['rounds']:.0f} "
            f"cycles a round (median device ms x clock / rounds), chain "
            f"{measure.chain_bound_ms(v['rounds'], cycles, clock):.6f} ms, dynamic shared "
            f"{v['shared']} B, {v['ctas']} CTAs an SM, routes {v['routes']}"
            for lab, v in t["layouts"].items())
        print(f"[uniformity] {label}: {len(problems)} layers x {t['frames']} frames "
              f"({len(problems) * t['frames']} CTAs), shapes {shapes}, K {t['ks']}, "
              f"{t['cands']} candidates, {t['accepts']} accepted; every layout and the grid twin "
              f"bitwise vs blocked; {lay}; event / device ms in turns: {txt}; bound "
              f"{t['bound'][0]:.6f} ms ({t['bound'][1]}) [{kind}; {card}]", flush=True)
        if label == "B=16":
            rounds16 = t["layouts"]["grid"]["rounds"]
            chain16 = measure.chain_bound_ms(rounds16, cycles, clock)
            problems16, radius16, shapes16 = problems, radius, shapes
            work = uniformity_work(problems16, kernel(problems16, radius=radius16,
                                                      shapes=shapes16))

    def on_cpu(problems):
        return [tuple(t.cpu() if torch.is_tensor(t) else t for t in p) for p in problems]

    row = own_kernel_row(
        "enforce_uniformity", "ethzasl_brisk_tpu_torch/csrc/uniformity.cu",
        "none: the port's own (greedy uniformity, which the JAX package does in XLA: "
        "ethzasl_brisk_tpu/detect/uniformity.py:69-318)",
        launches, lambda: kernel(problems16, radius=radius16, shapes=shapes16),
        lambda cpu=False: blocked_uniformity(on_cpu(problems16) if cpu else problems16,
                                             radius=radius16),
        None, ("uniformity_kernel",), nbytes=work[0], int32_ops=work[1], fp32_ops=work[2],
        chain_ms=chain16)
    host = {lab: host_us(lambda kw=kw: kernel(problems16, radius=radius16, shapes=shapes16,
                                               **kw), 200)
            for lab, kw in UNIFORMITY_LAYOUTS.items()}
    print(f"[uniformity] B=16 step's four layers: bitwise vs plain; {row_text(row)}; host us a "
          f"call (mean of 200, launches queued; the cells computed in the kernel): "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items()) + f" [{kind}; {card}]",
          flush=True)
    return row


def mask_frames(b: int, h: int, w: int) -> torch.Tensor:
    """(b, h, w) uint8, b >= 3: smoothed noise, then a flat frame (ties; at
    threshold 0 the zero fill decides) and sharp boxes (large negative
    scores along their edges)."""
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    frames = bench_frames(b, h, w, seed=h + w)
    frames[1] = 77
    frames[2] = 40
    for k in range(4):
        y, x = (h * (2 * k + 1)) // 9, (w * (3 * k + 1)) // 13
        frames[2, y : y + 4 + 3 * k, x : x + 5 + 2 * k] = 220
    return torch.from_numpy(frames)


def masks_phase(dev, card: str, kind: str, launches: int, regs: list) -> dict:
    """[masks]: kernel score_masks bitwise against its plain version on the
    card, at odd shapes (61 x 83, 96 x 130; noise, flat, boxes; thresholds
    0 and 20) and at the main step's four layers at B=16 and B=128,
    default and fused, one counted launch each; the plan (staged bytes a
    CTA, CTAs an SM); at the step's shapes the kernel and the plain chain
    in turns, event and device ms, beside the bound. Returns the kernel's
    row at the B=16 step's shapes (default path)."""
    from ethzasl_brisk_tpu_torch import _kernels, measure
    from ethzasl_brisk_tpu_torch.detect import scale_space
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.kernels import masks
    from ethzasl_brisk_tpu_torch.kernels.harris import (
        harris_score_i32_layers,
        harris_score_mask_layers,
    )
    from ethzasl_brisk_tpu_torch.kernels.nms import maxima2d_mask

    def inputs(frames, thr, fused, n_layers=4):
        pyr = scale_space.build_pyramid(frames, n_layers)
        maps = [(g.above_map, g.below_map)
                for g in map(scale_space.layer_geometry, range(n_layers))]
        if fused:
            pairs = harris_score_mask_layers(pyr, thr)
            return [p[0] for p in pairs], thr, maps, [p[1] for p in pairs]
        return harris_score_i32_layers(pyr), thr, maps, None

    def plain(scores, thr, maps, base):
        # The plain chain ANDs into K3's masks in place: it takes a copy.
        return masks.score_masks_plain(scores, thr, maps,
                                       None if base is None else [m.clone() for m in base])

    def check(args, what: str) -> int:
        _kernels.reset_launches()
        got = masks.score_masks_cuda(*args)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["score_masks"] == 1, (what, _kernels.LAUNCHES)
        ref = plain(*args)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert torch.equal(g, r), f"[masks] {what}: layer {i} differs from plain"
            assert int(g.view(torch.uint8).max()) <= 1, f"[masks] {what}: mask bytes"
        return sum(int(g.sum()) for g in got)

    odd = []
    for h, w in ((61, 83), (96, 130)):
        frames = mask_frames(3, h, w).to(dev)
        for thr in (0, 20):
            for fused in (False, True):
                what = f"{h}x{w} thr {thr} {'fused' if fused else '2-D'}"
                args = inputs(frames, thr, fused)
                odd.append(f"{what} {check(args, what)}")
    n_regs, static = ptxas_numbers(regs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = []
    for lab, fused in (("default", False), ("fused", True)):
        dyn = masks.staged_bytes(fused)
        ctas = ctas_an_sm(dyn + static, n_regs, dev, masks.THREADS)
        plan.append(f"{lab}: {dyn} B staged (scores {masks.SCORE_BYTES}"
                    + (f", K3's mask {masks.MASK_BYTES}" if fused else "")
                    + f"), {dyn + static} B a CTA, {ctas} CTAs an SM")
    print(f"[masks] kernel score_masks ptxas: {regs}; plan: {'; '.join(plan)}; {sms} SMs; "
          f"bitwise vs plain, one launch each, candidates: {'; '.join(odd)} "
          f"[{kind}; {card}]", flush=True)

    thr = int(BENCH_CONFIG["absolute_threshold"])
    row = None
    for batch in (16, 128):
        frames = torch.from_numpy(bench_frames(batch)).to(dev)
        for fused in (False, True):
            args = inputs(frames, thr, fused)
            scores, base = args[0], args[3]
            n_cand = check(args, f"B={batch} {'fused' if fused else '2-D'}")
            survivors = sum(int((base[i] if fused else maxima2d_mask(sc, thr)).sum())
                            for i, sc in enumerate(scores))
            pixels = sum(sc.numel() for sc in scores)
            bnd = measure.bound_ms((6 if fused else 5) * pixels,
                                   int32_ops=MASKS_OPS_PER_PIXEL * pixels
                                   + MASKS_OPS_PER_SURVIVOR * survivors)
            runs = {"kernel": lambda: masks.score_masks_cuda(*args),
                    "plain": lambda: plain(*args)}
            turns = turns_of(runs, ("kernel", "plain", "plain", "kernel"), dev,
                             {"kernel": ("score_masks_kernel",)})
            txt = "; ".join(f"{lab} " + ", ".join(f"{e:.4f} / {d:.4f}" for e, d in v)
                            for lab, v in turns.items())
            host = host_us(runs["kernel"], 200)
            print(f"[masks] B={batch} {'fused (K3 masks in)' if fused else 'default'}: "
                  f"{pixels} pixels, {survivors} pass the 2-D test, {n_cand} candidates; "
                  f"bitwise vs plain; event / device ms in turns: {txt}; bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]}); host us a call (mean of 200, launches "
                  f"queued) {host:.1f} [{kind}; {card}]", flush=True)
            if batch == 16 and not fused:
                (ev, dv), plain_ev = turns["kernel"][0], turns["plain"][0][0]
                row = dict(name="score_masks", route="cuda",
                           source="ethzasl_brisk_tpu_torch/csrc/masks.cu",
                           replaces="none: the port's own (the integer 2-D and 3-D masks, which "
                                    "the JAX package does in XLA: ethzasl_brisk_tpu/detect/"
                                    "scale_space.py:429-550, kernels/nms.py:29-37)",
                           launches=launches, max_abs_err=0.0, ms=ev, device_ms=dv,
                           plain_ms=plain_ev, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)
        del frames, args, scores, base
        torch.cuda.empty_cache()
    return row


def turns_of(runs: dict, order: tuple, dev, names: dict) -> dict:
    """Each run's (event ms, device ms) in the turns ``order``: the
    device time of the kernels whose names ``names[label]`` gives (one
    launch a call), or of a call's whole work where that is None."""
    from ethzasl_brisk_tpu_torch import measure

    turns = {label: [] for label in runs}
    for label in order:
        kernel = names.get(label)
        turns[label].append((measure.cuda_time(runs[label]),
                             measure.device_time(runs[label], dev, kernel,
                                                 per_call=kernel and 1)))
    return turns


def candidates_phase(dev, card: str, kind: str, launches: int, regs: list) -> dict:
    """[candidates]: kernel layer_candidates bitwise against its plain
    version on the card, one counted launch each: the odd shapes (61 x 83,
    96 x 130; noise, flat, boxes; thresholds 0 and 20) at caps 7, 150 and
    the whole map, each route; the B=16 and B=128 step's four layers at the
    main path's caps, default and fused, on the device-memory route, at a
    tenth of the caps (survivors over the cap: the radix select) and at
    C = 1; a flat and a noise VGA frame's whole map (the device route).
    Each with its plan: the CTAs a list (C), the routes, the radix passes
    run and skipped (the kernel's own count), a CTA's shared bytes and CTAs
    an SM. At the step's shapes the kernel, its device-memory route, the
    other cluster sizes, the plain version and ``torch.sort`` (stable, a
    layer's masked map a call: the library yardstick) in turns, event and
    device ms, beside the bound; host us a call. Then one VGA layer a
    detection (the quick start's at its certified cap, the flat and noise
    frames' whole maps, a map of which every pixel survives at that cap
    and at k = h*w), bitwise at the plan's cluster and at C = 8, and in
    turns with the plain version and ``torch.sort``. Returns the kernel's
    row at the B=16 step's shapes."""
    from ethzasl_brisk_tpu_torch import _kernels, measure
    from ethzasl_brisk_tpu_torch.detect import scale_space
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.kernels import candidates as kc

    def layers(frames, thr, fused=False, octaves=2):
        cfg = scale_space.DetectorConfig(octaves=octaves, absolute_threshold=float(thr),
                                         fused_mask=fused)
        return scale_space.layer_score_masks(scale_space.build_pyramid(frames, cfg.n_layers), cfg)

    def list_bytes(scores, masks, caps) -> int:
        # Each mask byte, each masked-in pixel's score sector, the lists
        # (13 B a slot) and the counts.
        return sum(m.numel() + measure.distinct_sector_bytes(m.reshape(-1).nonzero(), 4,
                                                             m.numel())
                   + 13 * sc.shape[0] * min(c, sc[0].numel()) + 4 * sc.shape[0]
                   for sc, m, c in zip(scores, masks, caps))

    n_regs, _ = ptxas_numbers(regs)

    def check(scores, masks, caps, what, routes=None, cluster=None) -> str:
        passes = torch.empty((scores[0].shape[0], len(scores)), dtype=torch.int32, device=dev)
        _kernels.reset_launches()
        got, counts = kc.layer_candidates_cuda(scores, masks, caps, routes, cluster, passes)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["layer_candidates"] == 1, (what, _kernels.LAUNCHES)
        ref, ref_counts = kc.layer_candidates_plain(scores, masks, caps)
        assert torch.equal(counts, ref_counts), f"[candidates] {what}: counts"
        for i, (g, r) in enumerate(zip(got, ref)):
            for name, a, b in zip(("xs", "ys", "scores", "valid"), g, r):
                assert torch.equal(a, b), f"[candidates] {what}: layer {i} {name} differs"
        # The plan as the wrapper makes it, and the kernel's own pass count.
        c = cluster or kc.cluster_size(scores[0].shape[0], len(scores),
                                       max(sc[0].numel() for sc in scores))
        ks = [min(cap, sc[0].numel()) for cap, sc in zip(caps, scores)]
        used = routes or [kc.layer_route(k, c) for k in ks]
        bits = passes.cpu().reshape(-1).tolist()
        ran = sum(bin(b & 0xF).count("1") for b in bits)
        skipped = sum(bin((b >> 4) & 0xF).count("1") for b in bits)
        shared = kc.shared_bytes([k for k, r in zip(ks, used) if r == "shared"], c)
        return (f"{what} (C {c}, {'/'.join(used)}, radix passes run {ran} / skipped {skipped} "
                f"over {len(bits)} lists, {shared} B shared a CTA, "
                f"{ctas_an_sm(shared, n_regs, dev, kc.THREADS)} CTAs an SM; mask counts up to "
                f"{int(counts.max())})")

    lines = []
    for h, w in ((61, 83), (96, 130)):
        frames = mask_frames(3, h, w).to(dev)
        for thr in (0, 20):
            scores, masks = layers(frames, thr)
            whole = [sc[0].numel() for sc in scores]
            for caps in ([7] * 4, [150] * 4, whole):
                lines.append(check(scores, masks, caps, f"{h}x{w} thr {thr} caps {caps}"))
            lines.append(check(scores, masks, whole, f"{h}x{w} thr {thr} whole maps",
                               ["device"] * 4))
    flat = torch.full((2, 480, 640), 77, dtype=torch.uint8, device=dev)
    flat[1] = torch.from_numpy(bench_frames(1)[0]).to(dev)
    scores, masks = layers(flat, 0, octaves=0)
    lines.append(check(scores, masks, [480 * 640], "flat and noise VGA frames, whole map"))
    print(f"[candidates] kernel layer_candidates ptxas: {regs}; bitwise vs plain, one launch "
          f"each: {'; '.join(lines)} [{kind}; {card}]", flush=True)

    caps = list(BENCH_CONFIG["max_candidates"])
    thr = int(BENCH_CONFIG["absolute_threshold"])
    row = None
    for batch in (16, 128):
        frames = torch.from_numpy(bench_frames(batch)).to(dev)
        lines = []
        for fused in (True, False):
            scores, masks = layers(frames, thr, fused)
            lines.append(check(scores, masks, caps, "fused" if fused else "default"))
        lines.append(check(scores, masks, caps, "device route", ["device"] * 4))
        lines.append(check(scores, masks, [c // 10 for c in caps], "caps / 10"))
        lines.append(check(scores, masks, caps, "C = 1", cluster=1))
        plan_c = kc.cluster_size(batch, 4, 480 * 640)
        others = [c for c in (1, 2, 4, 8) if c != plan_c]
        counts = kc.mask_counts(masks)
        masked = [torch.where(m, sc, torch.full_like(sc, kc.INT32_MIN)).reshape(sc.shape[0], -1)
                  for sc, m in zip(scores, masks)]
        # "caps / 10": survivors past the lists, so the radix select's five
        # more passes over the maps and sorts of at most 1024 keys, against
        # the kernel's sort of up to 16,384 (padded) keys.
        runs = {"kernel": lambda: kc.layer_candidates_cuda(scores, masks, caps),
                "device route": lambda: kc.layer_candidates_cuda(scores, masks, caps,
                                                                 ["device"] * 4),
                "caps / 10": lambda: kc.layer_candidates_cuda(scores, masks,
                                                              [c // 10 for c in caps]),
                "plain": lambda: kc.layer_candidates_plain(scores, masks, caps),
                "torch.sort": lambda: [torch.sort(x, dim=1, descending=True, stable=True)
                                       for x in masked]}
        for c in others:
            runs[f"C {c}"] = lambda c=c: kc.layer_candidates_cuda(scores, masks, caps, cluster=c)
        cs = tuple(f"C {c}" for c in others)
        names = {label: ("candidates_kernel",)
                 for label in ("kernel", "device route", "caps / 10", *cs)}
        turns = turns_of(runs, ("kernel", "device route", "caps / 10", *cs, "plain", "torch.sort",
                                "torch.sort", "plain", *cs[::-1], "caps / 10", "device route",
                                "kernel"),
                         dev, names)
        nbytes = list_bytes(scores, masks, caps)
        bnd = measure.bound_ms(nbytes)
        # The wrapper's host time, and its parts: launch_plan (the checks,
        # the outputs' allocations, the tables), as many torch.empty calls
        # as it makes, and the C entry through _kernels.launch on a table
        # made once.
        _, cnts, tables, _keep, (c_plan, _) = kc.launch_plan(scores, masks, caps)
        n_alloc = 4 * len(caps) + 1 + len(_keep) - _keep.count(None)

        def entry():
            for table, n in tables:
                _kernels.launch("layer_candidates", "layer_candidates", dev, table, n, batch,
                                len(scores), 0, c_plan, cnts.data_ptr(), 0)

        host = {"call": host_us(runs["kernel"], 200),
                "launch_plan": host_us(lambda: kc.launch_plan(scores, masks, caps), 200),
                f"its {n_alloc} torch.empty": host_us(
                    lambda: [torch.empty((batch, 64), dtype=torch.int32, device=dev)
                             for _ in range(n_alloc)], 200),
                "the C entry": host_us(entry, 200)}
        txt = "; ".join(f"{lab} " + ", ".join(f"{e:.4f} / {d:.4f}" for e, d in v)
                        for lab, v in turns.items())
        print(f"[candidates] B={batch} step's four layers, caps {caps}: mask counts up to "
              f"{counts.max(dim=0).values.tolist()} a frame; bitwise vs plain: "
              f"{'; '.join(lines)}; event / device ms in turns: {txt}; bound {bnd[0]:.4f} ms "
              f"({bnd[1]}, {nbytes} B); host us (mean of 200, launches queued): "
              + ", ".join(f"{lab} {v:.1f}" for lab, v in host.items())
              + f" [{kind}; {card}]", flush=True)
        if batch == 16:
            (ev, dv), lib = turns["kernel"][0], turns["torch.sort"][0]
            row = dict(name="layer_candidates", route="cuda",
                       source="ethzasl_brisk_tpu_torch/csrc/candidates.cu",
                       replaces="none: the port's own (the score-ordered candidate lists, which "
                                "the JAX package does in XLA: lax.top_k, ethzasl_brisk_tpu/"
                                "detect/scale_space.py:704-751; kernels/topk.py:30)",
                       launches=launches, max_abs_err=0.0, ms=ev, device_ms=dv,
                       plain_ms=turns["plain"][0][0], bound_ms=bnd[0], bound_by=bnd[1],
                       library_ms=lib[0], library_device_ms=lib[1])
        del frames, scores, masks, masked, runs, tables, _keep
        torch.cuda.empty_cache()

    # One VGA layer a detection, a cluster of 16 a list (and of 8 in the
    # turns, against it): the quick start's layer at its certified cap (the
    # shared route), the flat and noise frames' whole maps (the device
    # route), and a map of which every pixel survives at the quick start's
    # cap (the radix select over the cluster, then its keys sorted in shared
    # memory) and at k = h*w (307,200 keys sorted in device memory).
    qframes = torch.from_numpy(bench_frames(2)).to(dev)
    q_layers = [layers(qframes[i : i + 1], QUICK_CONFIG["absolute_threshold"], True, 0)
                for i in (0, 1)]
    q_cap = -(-max(int(m[0].sum()) for _, m in q_layers) * 11 // 10 // 1024) * 1024
    dense = torch.randint(-(2**31) + 1, 2**31 - 1, (1, 480, 640), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(23)).to(dev)
    every = ([dense], [torch.ones_like(dense, dtype=torch.bool)])
    configs = (("quick start", *q_layers[0], [q_cap]),
               ("whole maps", *layers(flat, 0, octaves=0), [480 * 640]),
               ("every pixel survives, the quick start's cap", *every, [q_cap]),
               ("every pixel survives, whole map", *every, [480 * 640]))
    for what, scores, masks, caps in configs:
        line = check(scores, masks, caps, what)
        sc, m, k = scores[0], masks[0], min(caps[0], scores[0][0].numel())
        surv = (m & (sc > kc.INT32_MIN)).sum(dim=(1, 2)).tolist()
        sorts = [("a radix select, then " if n > k else "") + f"{min(n, k)} keys"
                 for n in surv]
        masked = torch.where(m, sc, torch.full_like(sc, kc.INT32_MIN)).reshape(sc.shape[0], -1)
        line = f"{line}; {check(scores, masks, caps, f'{what}, C = 8', cluster=8)}"
        runs = {"kernel": lambda: kc.layer_candidates_cuda(scores, masks, caps),
                "C 8": lambda: kc.layer_candidates_cuda(scores, masks, caps, cluster=8),
                "plain": lambda: kc.layer_candidates_plain(scores, masks, caps),
                "torch.sort": lambda: torch.sort(masked, dim=1, descending=True, stable=True)}
        turns = turns_of(runs, ("kernel", "C 8", "plain", "torch.sort", "torch.sort", "plain",
                                "C 8", "kernel"), dev,
                         {"kernel": ("candidates_kernel",), "C 8": ("candidates_kernel",)})
        nbytes = list_bytes(scores, masks, caps)
        bnd = measure.bound_ms(nbytes)
        txt = "; ".join(f"{lab} " + ", ".join(f"{e:.4f} / {d:.4f}" for e, d in v)
                        for lab, v in turns.items())
        print(f"[candidates] VGA {what}: {line}; B={sc.shape[0]}, k {k}, survivors a frame "
              f"{surv}, sorted {', '.join(sorts)}; event / device ms in turns: {txt}; bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}, {nbytes} B) [{kind}; {card}]", flush=True)
        del runs, masked
    del configs, every, q_layers, qframes, dense, flat
    torch.cuda.empty_cache()
    return row


def capture_refine(run) -> tuple:
    """The arguments, cloned, of the one ``refine_keypoints`` call of
    ``run()``'s detection: (scores, cands, accepts, caps, geoms), rdt."""
    from ethzasl_brisk_tpu_torch.detect import scale_space

    calls = []
    real = scale_space.refine_keypoints

    def record(scores, cands, accepts, caps, geoms, rdt=torch.float32):
        calls.append(([s.clone() for s in scores], [tuple(t.clone() for t in c) for c in cands],
                      [a.clone() for a in accepts], list(caps), geoms))
        return real(scores, cands, accepts, caps, geoms, rdt)

    scale_space.refine_keypoints = record
    try:
        run()
    finally:
        scale_space.refine_keypoints = real
    assert len(calls) == 1, len(calls)
    return calls[0]


def refine_ptxas(regs: list) -> dict:
    """Registers and spill bytes of each refine kernel from its ptxas
    lines: {"float32": (registers, spill bytes), "float64": ...}, by the
    fit's type."""
    import re

    out, key = {}, None
    for line in regs:
        m = re.search(r"refine_kernelILb[01]E([fd])E", line)
        if "Compiling entry" in line and m:
            key = "float32" if m.group(1) == "f" else "float64"
        elif key:
            r, spill = out.get(key, (0, 0))
            r = max([r] + [int(v) for v in re.findall(r"Used (\d+) registers", line)])
            spill = max([spill] + [int(v) for v in re.findall(r"(\d+) bytes spill", line)])
            out[key] = (r, spill)
    return out


def tail_accepts(accepts, seed: int = 25) -> list:
    """Accept flags only in the last 1,024 of each list (a seeded half of
    them; ``tests/_candidate_cases.py``'s ``tail``): the walk of a cut list
    must reach its end."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for a in accepts:
        t = torch.zeros(a.shape, dtype=torch.bool)
        n = min(1024, a.shape[1])
        t[:, -n:] = torch.rand((a.shape[0], n), generator=g) < 0.5
        out.append(t.to(a.device))
    return out


def refine_phase(dev, card: str, kind: str, launches: int, regs: list, feature,
                 fused_feature) -> dict:
    """[refine]: kernel refine_keypoints bitwise against its plain version
    on the card, one counted launch each, in float32 and float64: the odd
    shapes' detections (61 x 83, 96 x 130; thresholds 0 and 20; refine caps
    24), the B=16 and B=128 steps' refine (default and fused, accepts only
    in the last 1,024 flags of each list), and at B=16 without compaction
    (caps = k), with no accept and with every accept; one VGA list past a
    chunk (k = 307,195, the second frame's row 11 bytes into a 16-byte
    word) at caps 64, one past the slot table, k / 2 and k. The plan: the
    CTA's threads, chunks a list and chunks the walk ranks, the slot table,
    shared bytes, and each type's registers, spill and CTAs an SM. At the
    steps' inputs the kernel, its tail case and the plain version in turns,
    event and device ms, beside the bound; host us a call and its parts. Returns the kernel's row at the B=16 step's
    inputs (float32)."""
    from ethzasl_brisk_tpu_torch import _kernels, measure
    from ethzasl_brisk_tpu_torch.detect import refine, scale_space
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.kernels import candidates as kc

    types = refine_ptxas(regs)
    _, shared = ptxas_numbers(regs)

    def check(args, rdt, what) -> str:
        _kernels.reset_launches()
        got, counts = refine.refine_keypoints_cuda(*args, rdt)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["refine_keypoints"] == 1, (what, _kernels.LAUNCHES)
        ref, ref_counts = refine.refine_keypoints_plain(*args, rdt)
        assert torch.equal(counts, ref_counts), f"[refine] {what}: counts"
        for name, a, b in zip(("x", "y", "size", "angle", "response", "octave", "valid"),
                              got.fields(), ref.fields()):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f"[refine] {what}: {name} differs from plain"
        return f"{what} ({int(ref.valid.sum())} valid of {ref.valid.numel()})"

    def walk(accepts, caps) -> str:
        # Each list's chunks and the chunks the walk ranks (the twin's walk
        # on the card's rows), summed over the frames.
        parts = []
        for a, cap in zip(accepts, caps):
            k = a.shape[1]
            n = int(((refine.row_offsets(a) + k + refine.CHUNK - 1) // refine.CHUNK).max())
            if cap >= k:
                parts.append(f"k {k}: {n} chunk(s), no compaction")
            else:
                ranked = refine.chunk_walk(a, cap)[1]
                parts.append(f"k {k}: {n} chunk(s), {int(ranked.sum())} of "
                             f"{ranked.numel()} ranked")
        return "; ".join(parts)

    plan = (f"{refine.THREADS} threads a CTA, chunks of {refine.CHUNK} flags, a run of "
            f"{refine.RUN} a thread; the slot table in shared memory ({refine.CHUNK} 16-bit "
            f"entries, a chunk's); {shared} B shared a CTA; "
            + "; ".join(f"{t}: {r} registers, {sp} B spill, "
                        f"{ctas_an_sm(shared, r, dev, refine.THREADS)} CTAs an SM"
                        for t, (r, sp) in sorted(types.items())))
    lines = []
    for h, w in ((61, 83), (96, 130)):
        frames = mask_frames(3, h, w).to(dev)
        for thr in (0, 20):
            cfg = scale_space.DetectorConfig(octaves=2, absolute_threshold=float(thr),
                                             max_candidates=150, refine_capacity=24)
            args = capture_refine(lambda: scale_space.detect_keypoints(frames, cfg))
            for rdt in (torch.float32, torch.float64):
                lines.append(check(args, rdt, f"{h}x{w} thr {thr} {str(rdt)[6:]}"))
    print(f"[refine] kernel refine_keypoints plan: {plan}; ptxas: {regs}; bitwise vs plain, one "
          f"launch each: {'; '.join(lines)} [{kind}; {card}]", flush=True)

    # One VGA list past a chunk: a whole-map list of random scores, cut to
    # 307,195 so the second frame's row starts 11 bytes into a word.
    dense = torch.randint(-(2**31) + 1, 2**31 - 1, (2, 480, 640), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(25)).to(dev)
    vga_k = 480 * 640 - 5
    lists, _ = kc.layer_candidates_cuda([dense], [torch.ones_like(dense, dtype=torch.bool)],
                                        [480 * 640])
    cands = [tuple(t[:, :vga_k].contiguous() for t in lists[0])]
    geoms = [scale_space.layer_geometry(0)]
    lines = []
    for label, flags in (("tail", tail_accepts([cands[0][3]])),
                         ("half", [cands[0][3] & (torch.rand(cands[0][3].shape, device=dev,
                                                             generator=torch.Generator(dev)
                                                             .manual_seed(25)) < 0.5)])):
        for cap in (64, refine.CHUNK + 1, vga_k // 2, vga_k):
            lines.append(check(([dense], cands, flags, [cap], geoms), torch.float32,
                               f"{label} cap {cap} [{walk(flags, [cap])}]"))
    lines.append(check(([dense], cands, flags, [refine.CHUNK + 1], geoms), torch.float64,
                       f"half cap {refine.CHUNK + 1} float64"))
    print(f"[refine] VGA list past a chunk, B=2: bitwise vs plain, one launch each: "
          f"{'; '.join(lines)} [{kind}; {card}]", flush=True)
    del dense, lists, cands, flags
    torch.cuda.empty_cache()

    row = None
    for batch in (16, 128):
        frames = torch.from_numpy(bench_frames(batch)).to(dev)
        lines = []
        args = capture_refine(lambda: fused_feature.detect(frames))
        lines.append(check(args, torch.float32, "fused"))
        args = capture_refine(lambda: feature.detect(frames))
        for rdt in (torch.float64, torch.float32):
            lines.append(check(args, rdt, f"default {str(rdt)[6:]}"))
        scores, cands, accepts, caps, geoms = args
        tail = tail_accepts(accepts)
        tail_args = (scores, cands, tail, caps, geoms)
        for rdt in (torch.float32, torch.float64):
            lines.append(check(tail_args, rdt, f"tail {str(rdt)[6:]}"))
        if batch == 16:
            lines.append(check((scores, cands, accepts, [c[0].shape[1] for c in cands], geoms),
                               torch.float32, "caps = k"))
            for label, fill in (("no accept", False), ("every accept", True)):
                flags = [torch.full_like(a, fill) for a in accepts]
                lines.append(check((scores, cands, flags, caps, geoms), torch.float32, label))
        runs = {"kernel": lambda: refine.refine_keypoints_cuda(*args),
                "tail": lambda: refine.refine_keypoints_cuda(*tail_args),
                "plain": lambda: refine.refine_keypoints_plain(*args)}
        order = ("kernel", "tail", "plain")
        turns = turns_of(runs, order + order[::-1], dev,
                         {label: ("refine_kernel",) for label in order[:2]})
        # The bytes: the accept flags, a slot's candidate (12 B) and fields
        # (25 B: five float32, the int32 octave, the valid byte), the
        # distinct sectors of its taps, the counts.
        nbytes, slots = 4 * scores[0].shape[0] * len(caps), 0
        for sc, (xs, ys, _, _), a, cap in zip(scores, cands, accepts, caps):
            src = refine.compaction_slots(a, cap)
            cx, cy = torch.gather(xs, 1, src).long(), torch.gather(ys, 1, src).long()
            h, w = sc.shape[1:]
            plane = torch.arange(sc.shape[0], device=dev)[:, None] * (h * w)
            taps = torch.stack([plane + torch.clamp(cy + dy, 0, h - 1) * w
                                + torch.clamp(cx + dx, 0, w - 1)
                                for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
            nbytes += a.numel() + 37 * src.numel() + measure.distinct_sector_bytes(
                taps, 4, sc.numel())
            slots += src.numel()
        bnd = measure.bound_ms(nbytes, fp32_ops=REFINE_OPS_PER_SLOT * slots)
        # The wrapper's host time and its parts, in turns (each part's mean
        # over 200 calls, in order, in reverse, in order again): the router
        # as the detector calls it, refine_keypoints_cuda, launch_plan, its
        # checks and rows (layer_rows, which makes the kernel's inputs
        # contiguous), its 8 torch.empty, the ctypes tables, the C entry on
        # a plan made once. Each is printed as its least and its largest
        # mean.
        kps, _, tables, outs, _keep = refine.launch_plan(*args)
        rows, col, _ = refine.layer_rows(*args)
        ptrs = [t.data_ptr() for t in kps.fields()] + [0]

        is_float = int(scores[0].dtype == torch.float32)

        def entry():
            for table, n in tables:
                _kernels.launch("refine_keypoints", "refine_keypoints", dev, table, n, outs,
                                batch, col, len(scores), is_float, 0)

        parts = {"call": lambda: refine.refine_keypoints(*args),
                 "refine_keypoints_cuda": runs["kernel"],
                 "launch_plan": lambda: refine.launch_plan(*args),
                 "its checks and rows": lambda: refine.layer_rows(*args),
                 "its 8 torch.empty": lambda: [
                     torch.empty((batch, col), dtype=torch.float32, device=dev)
                     for _ in range(8)],
                 "the ctypes tables": lambda: refine.launch_tables(rows, ptrs),
                 "the C entry": entry}
        host = {label: [] for label in parts}
        for label in [*parts, *reversed(parts), *parts]:
            host[label].append(host_us(parts[label], 200))
        txt = "; ".join(f"{lab} " + ", ".join(f"{e:.4f} / {d:.4f}" for e, d in v)
                        for lab, v in turns.items())
        print(f"[refine] B={batch} step, caps {caps}, {slots} slots, accepted up to "
              f"{refine.accepted_counts(accepts).max(dim=0).values.tolist()} a frame (tail "
              f"{refine.accepted_counts(tail).max(dim=0).values.tolist()}); walk "
              f"[{walk(accepts, caps)}], tail [{walk(tail, caps)}]; bitwise vs plain: "
              f"{'; '.join(lines)}; float32 event / device ms in turns: {txt}; bound "
              f"{bnd[0]:.5f} ms ({bnd[1]}, {nbytes} B, {REFINE_OPS_PER_SLOT * slots} float "
              f"operations); host us a call (least and largest of 3 means of 200 in turns, "
              f"launches queued): "
              + ", ".join(f"{lab} {min(v):.1f}-{max(v):.1f}" for lab, v in host.items())
              + f" [{kind}; {card}]", flush=True)
        if batch == 16:
            (ev, dv) = turns["kernel"][0]
            row = dict(name="refine_keypoints", route="cuda",
                       source="ethzasl_brisk_tpu_torch/csrc/refine.cu",
                       replaces="none: the port's own (the compaction, taps, sub-pixel fit and "
                                "packing, which the JAX package does in XLA: ethzasl_brisk_tpu/"
                                "detect/scale_space.py:666-701, :772-848; detect/subpixel.py:18)",
                       launches=launches, max_abs_err=0.0, ms=ev, device_ms=dv,
                       plain_ms=turns["plain"][0][0], bound_ms=bnd[0], bound_by=bnd[1],
                       library_ms=None)
        del frames, args, tail_args, scores, cands, accepts, tail, runs, tables, _keep, kps
        torch.cuda.empty_cache()
    return row


# Kernel pyramid_u8's int32 operations an output (csrc/pyramid.cu): a
# two-thirds output 15 (20 averages of 3 a 2 x 2 block), a half output 10
# (3 averages and the clamp).
PYRAMID_TWOTHIRDS_OPS = 15
PYRAMID_HALF_OPS = 10
# Kernel hamming_argmin stages a CTA's train rows in chunks of 256 words
# rows plus a penalty word a row (csrc/match.cu kChunk): dynamic shared bytes.
MATCH_CHUNK = 256
# The int8 tensor cores' dense peak (NVIDIA's data sheet, H100 SXM, 700 W),
# for the +-1 match as an s8 product: the route a later design could take.
INT8_TENSOR_OPS_PER_S = 1979e12


def match_words(b: int, k: int, w: int, seed: int, dev, rule: str = "") -> tuple:
    """(b, k, w) int32 words on the card with duplicated rows (every third
    row repeats an earlier one of its frame; a quarter of each frame's rows
    come from the frame before, half of those with two bits flipped), and a
    valid mask (~75 %) with ``rule``'s slots cleared: "no valid train"
    (frame 0 all invalid), "invalid queries" (every second slot of frames
    1 on)."""
    g = torch.Generator().manual_seed(seed)
    words = torch.randint(-2**31, 2**31, (b, k, w), generator=g, dtype=torch.int64)
    words = words.to(torch.int32)
    for r in range(3, k, 3):
        words[:, r] = words[:, int(torch.randint(0, r, (1,), generator=g))]
    if k > 2:
        for f in range(1, b):
            rows = torch.randint(0, k, (max(1, k // 4),), generator=g)
            words[f, rows] = words[f - 1, torch.randint(0, k, rows.shape, generator=g)]
            words[f, rows[: rows.numel() // 2], 0] ^= 0b1001
    valid = torch.rand((b, k), generator=g) < 0.75
    if rule == "no valid train":
        valid[0] = False
    elif rule == "invalid queries":
        valid[1:, ::2] = False
    return words.to(dev), valid.to(dev)


def match_work(desc: torch.Tensor, n_bits: int) -> tuple[int, int]:
    """(bytes, popcounts) of one adjacent match: the words it counts and the
    valid flags read once, best index and distance written once; a
    popcount a word of every (query, train) pair."""
    b, k, _ = desc.shape
    nw = n_bits // 32
    return b * k * (4 * nw + 1) + 8 * max(b - 1, 0) * k, max(b - 1, 0) * k * k * nw


def match_phase(dev, card: str, kind: str, launches: int, regs: list, pipe, step16) -> dict:
    """[match]: kernel hamming_argmin bitwise against its plain version (the
    +-1 matmul route) on the card, one counted launch a call (none at B=1):
    the steps' descriptors at B=16 and B=128, the AST step's K (1,520
    slots, more than one staged chunk), v1's 16 words at 512 and 384 bits,
    three words (the generic body), and the odd cases (ties, a train frame
    with no valid slot, invalid queries, K = 1, K = 130, B = 1); the peak
    memory of each route at B=128; the kernel and the plain route in turns,
    event and device ms, beside the popcount and byte bounds and the int8
    tensor-core figure. Returns the kernel's row at the B=16 step."""
    from ethzasl_brisk_tpu_torch import _kernels, measure
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.match.matcher import (
        match_adjacent_cuda,
        match_adjacent_plain,
        unpack_bits_pm1,
    )

    def check(desc, valid, n_bits, what):
        _kernels.reset_launches()
        got = match_adjacent_cuda(desc, valid, n_bits)
        torch.cuda.synchronize()
        n = _kernels.LAUNCHES["hamming_argmin"]
        assert n == (1 if desc.shape[0] > 1 else 0), (what, _kernels.LAUNCHES)
        ref = match_adjacent_plain(desc, valid, n_bits)
        for g, r in zip(got, ref):
            assert torch.equal(g, r.to(torch.int32)), f"[match] {what} differs from plain"
        return n

    desc16, valid16 = step16
    kps128, desc128 = pipe.step(torch.from_numpy(bench_frames(128)).to(dev))[:2]
    steps = {16: (desc16, valid16), 128: (desc128, kps128.valid)}
    cases = [("B=16 step", desc16, valid16, 384), ("B=128 step", desc128, kps128.valid, 384)]
    for seed, (what, b, k, w, n_bits, rule) in enumerate((
            ("ties", 4, 40, 12, 384, ""), ("no valid train", 3, 45, 12, 384, "no valid train"),
            ("invalid queries", 3, 64, 12, 384, "invalid queries"), ("K=1", 4, 1, 12, 384, ""),
            ("K=130", 3, 130, 12, 384, ""), ("B=1", 1, 33, 12, 384, ""),
            ("AST K=1520", 16, 1520, 12, 384, ""), ("v1 512 bits", 16, 1520, 16, 512, ""),
            ("v1 384 bits", 16, 1520, 16, 384, ""), ("3 words", 3, 200, 12, 96, ""))):
        cases.append((what, *match_words(b, k, w, 100 + seed, dev, rule), n_bits))
    checked = [f"{what} {tuple(d.shape)} {n_bits} bits (launches {check(d, v, n_bits, what)})"
               for what, d, v, n_bits in cases]
    print(f"[match] hamming_argmin bitwise vs plain: {'; '.join(checked)} [{card}]", flush=True)

    # Peak memory of each route at B=128 over what its inputs hold.
    peaks = {}
    for label, fn in (("kernel", match_adjacent_cuda), ("plain", match_adjacent_plain)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(desc128, kps128.valid)
        torch.cuda.synchronize()
        peaks[label] = (torch.cuda.max_memory_allocated() - base) / 2**20
        del out

    rows = {}
    for b, (d, v) in steps.items():
        nbytes, popc = match_work(d, 384)
        q, t = unpack_bits_pm1(d[1:], 384), unpack_bits_pm1(d[:-1], 384)
        row = own_kernel_row(
            "hamming_argmin", "ethzasl_brisk_tpu_torch/csrc/match.cu",
            "none: XLA work, ethzasl_brisk_tpu/parallel/frames.py:256-265 (the Harris step's "
            "match_pair) and :194-208 (_match_adjacent), through match/matcher.py:31-47's +-1 "
            "bf16 matmul",
            launches, lambda: match_adjacent_cuda(d, v),
            lambda cpu=False: match_adjacent_plain(d.cpu(), v.cpu()) if cpu
            else match_adjacent_plain(d, v),
            lambda: torch.matmul(q, t.transpose(-1, -2)), ("hamming_argmin_kernel",),
            nbytes=nbytes, popc_ops=popc)
        turns = turns_of({"kernel": lambda: match_adjacent_cuda(d, v),
                          "plain": lambda: match_adjacent_plain(d, v)},
                         ("kernel", "plain", "plain", "kernel"), dev,
                         {"kernel": ("hamming_argmin_kernel",)})
        int8_ms = 1e3 * 2 * (b - 1) * d.shape[1] ** 2 * 384 / INT8_TENSOR_OPS_PER_S
        print(f"[match] B={b} step, K = {d.shape[1]}, {popc:.4g} popcounts, {nbytes} bytes: "
              f"{row_text(row)}; library: torch.matmul of the unpacked +-1 operands; in turns "
              f"(event / device ms): {turns_text(turns)}; the same work as an int8 tensor-core "
              f"product: {int8_ms:.5f} ms [{kind}; {card}]", flush=True)
        rows[b] = row
    nw = 12
    shared = MATCH_CHUNK * (nw + 1) * 4
    regs_n = ptxas_numbers(regs)[0]
    print(f"[match] plan: CTAs of 128 queries, {shared} B of dynamic shared memory at 12 words "
          f"({ctas_an_sm(shared, regs_n, dev, 128)} CTAs an SM); ptxas: {regs}; peak memory over "
          f"the inputs at B=128: kernel {peaks['kernel']:.2f} MiB, plain {peaks['plain']:.2f} "
          f"MiB [{kind}; {card}]", flush=True)
    return rows[16]


def pyramid_bytes_ops(frames: torch.Tensor, n_layers: int) -> tuple[int, int]:
    """(bytes, int32 operations) of kernel pyramid_u8 on ``frames``: the
    frames read once, every derived layer written once; 15 operations a
    two-thirds output, 10 a half output."""
    from ethzasl_brisk_tpu_torch.kernels.downsample import layer_sizes

    *lead, h, w = frames.shape
    b = frames.numel() // max(h * w, 1)
    sizes = [b * a * c for a, c in layer_sizes(h, w, n_layers)]
    ops = PYRAMID_TWOTHIRDS_OPS * sum(sizes[1:2]) + PYRAMID_HALF_OPS * sum(sizes[2:])
    return sum(sizes), ops


def pyramid_phase(dev, card: str, kind: str, launches: int, regs: list) -> dict:
    """[pyramid]: kernel pyramid_u8 bitwise against its plain version (the
    torch resamplers a layer after the other) on the card, one counted
    launch a call: the B=16 and B=128 steps' frames (4 layers), the AST
    step's 6 layers, the odd shapes (61 x 83, 96 x 130, 3 x 3, 2 x 5,
    1 x 7) at 2, 4 and 6 layers, frames off 16-byte alignment (the byte
    loads), strided frames and one (H, W) frame; the kernel and the plain
    chain in turns, event and device ms, beside the bound. Returns the
    kernel's row at the B=16 step."""
    import numpy as np

    from ethzasl_brisk_tpu_torch import _kernels
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.kernels.downsample import pyramid_u8_cuda, pyramid_u8_plain

    def check(frames, n_layers, what):
        _kernels.reset_launches()
        got = pyramid_u8_cuda(frames, n_layers)
        torch.cuda.synchronize()
        ref = pyramid_u8_plain(frames, n_layers)
        n = _kernels.LAUNCHES["pyramid_u8"]
        assert n == (1 if any(r.numel() for r in ref[1:]) else 0), (what, _kernels.LAUNCHES)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert g.shape == r.shape and torch.equal(g, r), f"[pyramid] {what} layer {i}"
        return n

    f16 = torch.from_numpy(bench_frames(16)).to(dev)
    f128 = torch.from_numpy(bench_frames(128)).to(dev)
    big = torch.from_numpy(bench_frames(3)).to(dev)
    cases = [("B=16 step", f16, 4), ("B=128 step", f128, 4), ("AST B=16", f16, 6),
             ("off 16-byte alignment", big.view(-1)[1 : 1 + 2 * 479 * 640].view(2, 479, 640), 4),
             ("strided", big[:, 1::2, 3:], 6), ("one frame", big[1], 4)]
    rng = np.random.default_rng(26)
    for h, w in ((61, 83), (96, 130), (3, 3), (2, 5), (1, 7)):
        frames = torch.from_numpy(rng.integers(0, 256, (3, h, w), dtype=np.uint8)).to(dev)
        frames[1] = 255
        cases += [(f"{h}x{w}", frames, n) for n in (2, 4, 6)]
    checked = [f"{what} {tuple(f.shape)} {n} layers (launches {check(f, n, what)})"
               for what, f, n in cases]
    print(f"[pyramid] pyramid_u8 bitwise vs plain: {'; '.join(checked)} [{card}]", flush=True)

    rows = {}
    for b, frames in ((16, f16), (128, f128)):
        nbytes, ops = pyramid_bytes_ops(frames, 4)
        row = own_kernel_row(
            "pyramid_u8", "ethzasl_brisk_tpu_torch/csrc/pyramid.cu",
            "none: XLA work, ethzasl_brisk_tpu/kernels/downsample.py:19-66 (halfsample8, "
            "twothirdsample8) in detect/scale_space.py:84-100's layer order",
            launches, lambda: pyramid_u8_cuda(frames, 4),
            lambda cpu=False: pyramid_u8_plain(frames.cpu() if cpu else frames, 4),
            None, ("pyramid_u8_kernel",), nbytes=nbytes, int32_ops=ops)
        turns = turns_of({"kernel": lambda: pyramid_u8_cuda(frames, 4),
                          "plain": lambda: pyramid_u8_plain(frames, 4)},
                         ("kernel", "plain", "plain", "kernel"), dev,
                         {"kernel": ("pyramid_u8_kernel",)})
        print(f"[pyramid] B={b} step's 4 layers, {nbytes} bytes, {ops} int32 operations: "
              f"{row_text(row)}; in turns (event / device ms): {turns_text(turns)} "
              f"[{kind}; {card}]", flush=True)
        rows[b] = row
    regs_n, shared = ptxas_numbers(regs)
    print(f"[pyramid] plan: CTAs of 256 threads a 48 x 96 tile, {shared} B of static shared "
          f"memory ({ctas_an_sm(shared, regs_n, dev, 256)} CTAs an SM); ptxas: {regs} "
          f"[{kind}; {card}]", flush=True)
    return rows[16]


def empty_floor(lib, dev) -> dict:
    """The device time (ms) of an empty kernel (``EMPTY_KERNEL_CU``) at a
    CTA of 32 threads and at 80 CTAs of 128 (the B=16 step's 10,240 slots
    a thread): the floor under any launch's device time."""
    import ctypes

    from ethzasl_brisk_tpu_torch import measure

    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def run(grid, threads):
        assert lib.empty_launch(grid, threads, torch.cuda.current_stream(dev).cuda_stream) == 0

    return {f"{g} x {t}": measure.device_time(lambda g=g, t=t: run(g, t), dev,
                                              ("empty_kernel",), per_call=1)
            for g, t in ((1, 32), (80, 128))}



def build_yardsticks() -> dict:
    """The yardsticks the port never calls, each built into its own library
    with the kernels' flags and ``csrc/`` on the include path, all ``nvcc``
    runs at once: the staged segment_sum body, the two-launch describe's
    warp kernel, ``describe.cu`` with its words a ballot a word and an
    empty kernel.
    Returns {name: (loaded library, ptxas lines)}."""
    import ctypes
    import hashlib

    from ethzasl_brisk_tpu_torch import _kernels

    describe_cu = (_kernels._CSRC / "describe.cu").read_text()
    specs = {"staged_segment_sum": (STAGED_SEGMENT_SUM_CU, ()),
             "warp_describe": (WARP_DESCRIBE_CU, ()),
             "describe_words_ballot": (describe_cu, ("-DDESCRIBE_WORDS_BALLOT",)),
             "empty_kernel": (EMPTY_KERNEL_CU, ())}
    headers = "".join(h.read_text() for h in sorted(_kernels._CSRC.glob("*.cuh")))
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs, cmds = {}, []
    for name, (src, extra) in specs.items():
        flags = (*_kernels.NVCC_FLAGS, *extra, "-I", str(_kernels._CSRC))
        tag = hashlib.sha256((src + headers + " ".join(flags)).encode()).hexdigest()[:16]
        out = _kernels.BUILD_DIR / f"{name}_{tag}.so"
        outs[name] = out
        if not out.exists():
            cu = out.with_suffix(".cu")
            cu.write_text(src)
            cmds.append((name, [_kernels._nvcc(), *flags, "-shared", "-o", str(out), str(cu)]))
    logs = {}
    for (name, _), (rc, text) in zip(cmds, _kernels._run_all([c for _, c in cmds])):
        assert rc == 0, f"yardstick {name}: nvcc failed:\n{text}"
        outs[name].with_suffix(".log").write_text(text)
    for name, out in outs.items():
        log = out.with_suffix(".log")
        logs[name] = (ctypes.CDLL(str(out)), ptxas_lines(log.read_text() if log.exists() else ""))
    return logs


def ptxas_lines(log: str, kernel: str = "") -> list[str]:
    """``-Xptxas -v``'s lines for the kernels whose mangled names hold
    ``kernel``: the entry, its stack and spills, its registers."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("registers" in line or "spill" in line or "Compiling entry" in line):
            out.append(" ".join(line.split()))
    return out


def warp_describe(lib):
    """The two-launch describe (``WARP_DESCRIBE_CU``): ``(rot) -> (angle,
    words)`` by K2's phase-1 launch on ``phase1_args`` (its five LUT-row
    gathers included) and the warp kernel on its values, on the current
    stream. Not counted: a yardstick."""
    import ctypes

    from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity_cuda

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.warp_describe_rotated.argtypes = [vp, ci, ci] + [vp] * 12 + [vp, vp, vp, vp, ci, vp, vp, ci,
                                                                      vp, vp, ci, ci, ci, ci, ci, vp]
    lib.warp_describe_rotated.restype = ci

    def run(rot):
        pat, integral, rows, rotate, sidx, valid, angle, key_x, key_y, row_base, v1 = rot
        vals0 = smoothed_intensity_cuda(*phase1_args(rot)) if rotate else None
        k, (n_scales, n_rot, p) = sidx.numel(), pat.lut_x.shape
        out_angle = torch.empty((k,), dtype=torch.float32, device=integral.device)
        desc = torch.empty((k, pat.descriptor_words), dtype=torch.int32, device=integral.device)
        err = lib.warp_describe_rotated(
            integral.data_ptr(), integral.shape[1] - 1, rows,
            None if vals0 is None else vals0.data_ptr(), sidx.data_ptr(), valid.data_ptr(),
            angle.data_ptr(), key_x.data_ptr(), key_y.data_ptr(), row_base.data_ptr(),
            pat.lut_x.data_ptr(), pat.lut_y.data_ptr(), pat.lut_sigma.data_ptr(),
            pat.lut_scaling.data_ptr(), pat.lut_scaling2.data_ptr(), pat.long_i.data_ptr(),
            pat.long_j.data_ptr(), pat.long_wdx.data_ptr(), pat.long_wdy.data_ptr(),
            pat.long_i.numel(), pat.short_i.data_ptr(), pat.short_j.data_ptr(),
            pat.short_i.numel(), out_angle.data_ptr(), desc.data_ptr(), k, p, n_rot,
            pat.descriptor_words, int(v1), torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"warp describe: CUDA error {err}"
        return out_angle, desc
    return run


def words_ballot(lib):
    """``describe.cu`` built with its words a ballot a word: ``(rot) ->
    (angle, words)``, launched as ``describe_rotated_cuda`` launches the
    port's build, on the current stream. Not counted: a yardstick."""
    import ctypes

    from ethzasl_brisk_tpu_torch import _kernels

    lib.brisk_describe_rotated.argtypes = _kernels.library().brisk_describe_rotated.argtypes
    lib.brisk_describe_rotated.restype = ctypes.c_int

    def run(rot):
        pat, integral, rows, rotate, sidx, valid, angle, key_x, key_y, row_base, v1 = rot
        tables, k = pat.kernel_tables, sidx.numel()
        out_angle = torch.empty((k,), dtype=torch.float32, device=integral.device)
        desc = torch.empty((k, tables.layout.n_words), dtype=torch.int32, device=integral.device)
        err = lib.brisk_describe_rotated(
            integral.data_ptr(), integral.shape[1] - 1, rows, int(bool(rotate)), sidx.data_ptr(),
            valid.data_ptr(), angle.data_ptr(), key_x.data_ptr(), key_y.data_ptr(),
            row_base.data_ptr(), *tables.args, out_angle.data_ptr(), desc.data_ptr(), k,
            tables.layout.p, pat.lut_x.shape[1], tables.layout.n_words, int(v1),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"words by ballot: CUDA error {err}"
        return out_angle, desc
    return run


def describe_rotated_vs_plain(rot, what: str) -> int:
    """``describe_rotated`` on the card against its plain version on the
    CPU, bit for bit (angle and words). Returns the slots."""
    from ethzasl_brisk_tpu_torch.describe.rotated import describe_rotated_cuda, describe_rotated_plain

    got = describe_rotated_cuda(*rot)
    ref = describe_rotated_plain(*to_cpu(rot))
    assert torch.equal(got[0].cpu().view(torch.int32), ref[0].view(torch.int32)), f"{what}: angle"
    assert torch.equal(got[1].cpu(), ref[1]), f"{what}: descriptor words"
    return got[1].shape[0]


def to_cpu(args) -> tuple:
    """A call's arguments on the CPU, the pattern's tables too."""
    from ethzasl_brisk_tpu_torch.describe.extractor import DevicePattern

    def cpu(a):
        if isinstance(a, DevicePattern):
            return dataclasses.replace(a, **{f.name: getattr(a, f.name).cpu()
                                             for f in dataclasses.fields(a)})
        return a.cpu() if torch.is_tensor(a) else a
    return tuple(cpu(a) for a in args)


def describe_turns(rot, dev, other, label: str = "pair") -> dict:
    """``describe_rotated`` and ``other`` (a yardstick, ``(rot) -> (angle,
    words)``), equal bit for bit on these inputs, timed in turns (kernel,
    other, other, kernel) by CUDA events and by ``measure.device_time`` (all
    of a call's device work). Returns {label: [(event ms, device ms), ...]}."""
    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.describe.rotated import describe_rotated_cuda

    new, old = describe_rotated_cuda(*rot), other(rot)
    assert torch.equal(new[0].view(torch.int32), old[0].view(torch.int32)), f"{label}: angle"
    assert torch.equal(new[1], old[1]), f"describe_rotated differs from the {label}"
    fns = {"kernel": lambda: describe_rotated_cuda(*rot), label: lambda: other(rot)}
    turns = {name: [] for name in fns}
    for name in ("kernel", label, label, "kernel"):
        turns[name].append((measure.cuda_time(fns[name]), measure.device_time(fns[name], dev)))
    return turns


def turns_text(turns) -> str:
    return "; ".join(f"{label} " + ", ".join(f"{e:.4f} / {d:.4f}" for e, d in runs)
                     for label, runs in turns.items())


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
    from ethzasl_brisk_tpu_torch.kernels import candidates
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
    with uniformity_checked():
        out, match = run(feature, imgs)  # host images, as the README passes them
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    assert launches["enforce_uniformity"] == 2, launches
    assert all(t.device == dev for t in (*out[0][0].fields(), out[0][1], *match)), "outputs"
    assert launches["harris_score_mask"] == 2, launches
    assert launches["harris_score_i32"] == 0, launches
    # octaves 0 with K3: its mask is already the answer.
    assert launches["score_masks"] == 0, launches
    assert launches["layer_candidates"] == launches["refine_keypoints"] == 2, launches
    assert launches["describe_rotated"] == 2, launches
    assert launches["smoothed_intensity"] == launches["brisk_orientation"] == 0, launches
    # One layer: no pyramid; radius_match_best keeps the matmul.
    assert launches["pyramid_u8"] == launches["hamming_argmin"] == 0, launches

    ref, ref_match = run(BriskFeature(**QUICK_CONFIG, max_candidates=cap, device="cpu"), imgs)
    gap, n_valid = 0, []
    for (kg, dg), (kc, dc) in zip(out, ref):
        assert kg.x.dim() == 1 and dg.shape == (kg.capacity, 12), "unbatched outputs"
        assert torch.equal(kg.valid.cpu(), kc.valid), "quick start valid"
        for name in ("size", "response", "octave", "x", "y"):
            assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
        gap = max(gap, ulp_gap(kg.x, kc.x), ulp_gap(kg.y, kc.y))
        assert torch.equal(kg.angle.cpu(), kc.angle), "quick start angle"
        assert torch.equal(dg.cpu(), dc), "quick start descriptors"
        assert bool(torch.isfinite(kg.x).all())
        n_valid.append(int(kc.valid.sum()))
    assert gap == 0, gap
    assert min(n_valid) > 0
    for g, c in zip(match, ref_match):
        assert torch.equal(g.cpu(), c), "quick start matches"
    ms = measure.cuda_time(lambda: feature.detect_and_compute(gpu_imgs[0]), reps=5, warmup=1)
    print(
        f"[quick start] 2 VGA PGM images: candidates {counts} -> certified cap {cap}; "
        f"valid keypoints {n_valid}; launches {launches}; GPU vs CPU: every field, x/y "
        f"included ({gap} ULP apart), angles, descriptors and matches bitwise; the list on "
        f"the {candidates.layer_route(cap, candidates.cluster_size(1, 1, 480 * 640))} route, "
        f"a cluster of {candidates.cluster_size(1, 1, 480 * 640)} CTAs "
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


def u16_phase(dev: torch.device, card: str) -> dict:
    """The 16-bit pipeline on one VGA frame, on the card against the CPU.
    Returns its launches (the path that launches ``brisk_orientation``)."""
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

    # The host image, as a user passes it.
    got, launches = counted(lambda: feature.detect_and_compute(frame))
    # No K1-K3 (float maps, the float sampler): the orientation kernel, on
    # the op-by-op chain, uniformity's, and the float lists and refine.
    on_path = dict(brisk_orientation=1, enforce_uniformity=1, layer_candidates=1,
                   refine_keypoints=1)
    assert launches == launches_of(**on_path), f"[u16] launches: {launches}"
    assert not any(v for k, v in _kernels.LAUNCHES.items() if k not in on_path)
    assert got[0].x.device == dev and got[1].shape == (got[0].capacity, 12)
    assert bool(torch.isfinite(got[0].x).all())
    ref = BriskFeature(**U16_CONFIG, max_candidates=cap, device="cpu").detect_and_compute(frame)
    n_valid = assert_same_image_outputs(got, ref, "[u16]")
    assert n_valid > 0
    UNIFORMITY_INPUTS["[u16]"] = capture_uniformity(lambda: feature.detect(img))
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
    return launches


def facade_phase(dev: torch.device, card: str) -> dict:
    """Caller keypoints through compute, the float64 refine with exact
    angles, and bench.py's keywords, on one VGA uint8 frame. Returns the
    launches of the compute call (K2's path: ``angle_exact``)."""
    import numpy as np

    from ethzasl_brisk_tpu_torch import BriskFeature, KeyPoints
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    frame = torch.from_numpy(bench_frames(1, seed=11)[0])
    rng = np.random.default_rng(11)
    n = 800
    x, y = rng.uniform(0, 640, n), rng.uniform(0, 480, n)
    size = rng.uniform(8, 40, n)
    angle = np.where(rng.random(n) < 0.5, rng.uniform(-180, 180, n), -1.0)
    kw = dict(uniformity_radius=30.0, absolute_threshold=20.0, angle_exact=True)

    feature = BriskFeature(**kw)
    got, launches = counted(
        lambda: feature.compute(frame, KeyPoints.from_numpy(x, y, size, angle, capacity=1024)))
    assert launches["smoothed_intensity"] == 2, launches
    assert launches["enforce_uniformity"] == 0, launches
    assert launches["harris_score_i32"] == launches["harris_score_mask"] == 0, launches
    assert launches["score_masks"] == 0, launches
    assert launches["layer_candidates"] == launches["refine_keypoints"] == 0, launches
    # angle_exact: the host's double atan2, no orientation kernel, and both
    # samplings on K2 (describe_rotated takes the float32 chain only).
    assert launches["brisk_orientation"] == launches["describe_rotated"] == 0, launches
    assert launches["pyramid_u8"] == launches["hamming_argmin"] == 0, launches
    ref = BriskFeature(**kw, device="cpu").compute(
        frame, KeyPoints.from_numpy(x, y, size, angle, capacity=1024, device="cpu"))
    n_given = assert_same_image_outputs(got, ref, "[facade] from_numpy")
    assert n_given > 0

    parity = dict(kw, octaves=2, refine_dtype="float64")
    parity["max_candidates"] = certified_cap(parity, frame.to(dev))
    got, launches64 = counted(lambda: BriskFeature(**parity).detect_and_compute(frame))
    assert launches64["harris_score_i32"] == launches64["score_masks"] == 1, launches64
    assert launches64["enforce_uniformity"] == 1, launches64
    assert launches64["layer_candidates"] == launches64["refine_keypoints"] == 1, launches64
    assert launches64["smoothed_intensity"] == 2, launches64
    assert launches64["pyramid_u8"] == 1 and launches64["hamming_argmin"] == 0, launches64
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
    return launches


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


def ast_phase(dev: torch.device, card: str, kind: str, yard: dict) -> None:
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
    assert launches == launches_of(describe_rotated=1, pyramid_u8=1, hamming_argmin=1), launches
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

    # ---- K2 and describe_rotated at the AST shapes: against their plain
    # versions (K2 at both samplings' taps), K2 timed at phase 1, and
    # describe_rotated in turns with the two-launch describe, bounded.
    calls, rot = capture_describe(lambda: pipe.step(frames))
    for phase, args in enumerate(calls):
        assert torch.equal(smoothed_intensity_cuda(*args), smoothed_intensity(*args)), \
            f"[ast] K2 differs in phase {phase}"
    n_rot = describe_rotated_vs_plain(rot, "[ast] describe_rotated")
    k2_ms = measure.cuda_time(lambda: smoothed_intensity_cuda(*calls[0]))
    k2_plain = measure.cuda_time(lambda: smoothed_intensity(*calls[0]))
    k2_dev = measure.device_time(lambda: smoothed_intensity_cuda(*calls[0]), dev,
                                 ("k2_sampler_kernel",), per_call=1)
    k2_bnd = k2_bound(calls[:1])
    turns = describe_turns(rot, dev, warp_describe(yard["warp_describe"][0]))
    words = describe_turns(rot, dev, words_ballot(yard["describe_words_ballot"][0]),
                           "a ballot a word")
    rot_bnd = measure.bound_ms(*describe_rotated_work(rot))
    print(f"[ast K2] B={AST_BATCH}, K x P = {tuple(calls[0][3].shape)}: bitwise vs plain on "
          f"phase 1 and on the rotated taps; phase 1 {k2_ms:.3f} ms (device {k2_dev:.4f} ms) vs "
          f"plain {k2_plain:.3f} ms, bound {k2_bnd[0]:.4f} ms ({k2_bnd[1]}); describe_rotated on "
          f"{n_rot} slots bitwise vs plain and the pair, event / device ms in turns: "
          f"{turns_text(turns)}; bound {rot_bnd[0]:.5f} ms ({rot_bnd[1]}); the words a thread a "
          f"word (kernel) or a ballot a word: {turns_text(words)} [{kind}; {card}]", flush=True)


def counted(fn):
    """fn()'s result and the system kernels' launches during it, the
    counters set to 0 just before and read just after; every
    ``enforce_uniformity`` launch in it held against its plain version."""
    from ethzasl_brisk_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launches()
    with uniformity_checked():
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

    # ---- The facade on 4 frames: describe_rotated's v1 variant, 1 launch a frame.
    got, launches = counted(lambda: [det.detect_and_compute(host[i]) for i in range(4)])
    assert launches == launches_of(describe_rotated_v1=4), launches
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
    # The v1 resamplers stay torch ops: no pyramid_u8.
    assert launches_step == launches_of(describe_rotated=1, hamming_argmin=1), launches_step
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
    assert launches_h == launches_of(harris_score_i32=1, describe_rotated_v1=1,
                                     enforce_uniformity=1, score_masks=1, layer_candidates=1,
                                     refine_keypoints=1, pyramid_u8=1), launches_h
    n_h = assert_same_image_outputs(
        hg, BriskFeature(**BENCH_CONFIG, version="v1", device="cpu").detect_and_compute(host[0]),
        "[v1] BriskFeature")
    assert n_h > 0
    # K2's v1 variant's path: the exact angles keep both samplings on K2.
    exact = dict(BENCH_CONFIG, version="v1", angle_exact=True)
    he, launches_e = counted(lambda: BriskFeature(**exact).detect_and_compute(host[0]))
    assert launches_e == launches_of(harris_score_i32=1, smoothed_intensity_v1=2,
                                     enforce_uniformity=1, score_masks=1, layer_candidates=1,
                                     refine_keypoints=1, pyramid_u8=1), launches_e
    n_e = assert_same_image_outputs(
        he, BriskFeature(**exact, device="cpu").detect_and_compute(host[0]),
        "[v1] BriskFeature, angle_exact")
    assert n_e > 0
    print(f"[v1] detect_and_compute on 4 frames: launches {launches}, {n_fac} valid; "
          f"AstFramePipeline B={V1_BATCH}: launches {launches_step}, {n_step} valid, describable "
          f"{int(diag['describable'])}, 512-bit match; BriskFeature(version='v1') on frame 0: "
          f"launches {launches_h}, {n_h} valid; with angle_exact: launches {launches_e}, {n_e} "
          f"valid; each against a device='cpu' twin: every field, the angle included, "
          f"descriptors and matches bitwise [{card}]", flush=True)

    # ---- K2's v1 variant and describe_rotated's at the facade's shapes,
    # against their plain versions (K2 also at the rotated taps); the AST
    # step's describe (v2 rounding, 16 words) too.
    calls, rot = capture_describe(lambda: det.detect_and_compute(frames[0]))
    assert all(c[10] for c in calls) and rot[-1], "the facade describes with v1 rounding"
    err = 0
    for phase, args in enumerate(calls):
        got_k2, ref_k2 = smoothed_intensity_cuda(*args), smoothed_intensity(*args)
        err = max(err, int((got_k2.to(torch.int64) - ref_k2).abs().max()))
        assert torch.equal(got_k2, ref_k2), f"[v1] K2 v1 differs in phase {phase}"
    n_rot = describe_rotated_vs_plain(rot, "[v1] describe_rotated, v1 rounding")
    step_calls, step_rot = capture_describe(lambda: pipe.step(frames))
    assert not step_rot[-1] and det.descriptor_bytes == 64
    n_step_rot = describe_rotated_vs_plain(step_rot, "[v1] describe_rotated, the AST step")
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
    calls05, rot05 = capture_describe(lambda: half(frames[0], kps05))
    small05 = sum(int((c[5] < 0.5).sum()) for c in calls05)
    assert small05 > 0, "[v1] the bilinear branch is live at pattern_scale 0.5"
    for phase, args in enumerate(calls05):
        assert torch.equal(smoothed_intensity_cuda(*args), smoothed_intensity(*args)), \
            f"[v1] K2 v1 differs at pattern_scale 0.5, phase {phase}"
    describe_rotated_vs_plain(rot05, "[v1] describe_rotated at pattern_scale 0.5")
    k2_ms = measure.cuda_time(lambda: smoothed_intensity_cuda(*calls[0]))
    k2_plain = measure.cuda_time(lambda: smoothed_intensity(*calls[0]))
    k2_dev = measure.device_time(lambda: smoothed_intensity_cuda(*calls[0]), dev,
                                 ("k2_sampler_kernel",), per_call=1)
    bnd = k2_bound(calls[:1])
    print(f"[v1 K2] v1 rounding, K x P = {tuple(calls[0][3].shape)} ({small} small-sigma points "
          f"over phase 1 and the rotated taps; at pattern_scale 0.5 {small05}, bitwise too): "
          f"bitwise vs plain; phase 1 {k2_ms:.3f} ms (device {k2_dev:.4f} ms) vs plain "
          f"{k2_plain:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); describe_rotated bitwise vs "
          f"plain on the facade's {n_rot} slots (v1 rounding, 16 words), the AST step's "
          f"{n_step_rot} (v2 rounding, 16 words) and pattern_scale 0.5's [{kind}; {card}]",
          flush=True)

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
                launches=launches_e["smoothed_intensity_v1"], max_abs_err=err, ms=k2_ms,
                device_ms=k2_dev, plain_ms=k2_plain, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=None)


def own_kernel_row(name: str, source: str, replaces: str, launches: int, run, plain, library,
                   kernel_names: tuple, nbytes: float, fp32_ops: float = 0.0,
                   fp64_ops: float = 0.0, chain_ms: float | None = None,
                   int32_ops: float = 0.0, popc_ops: float = 0.0) -> dict:
    """A kernels-line row for one of the port's own kernels (no TPU
    counterpart): ``run()`` on the card against ``plain()`` on the CPU,
    bit for bit (sequences of tensors, NaN equal to NaN), then the kernel,
    the plain version on the card and the library call (or None) timed by
    CUDA events, the kernel's (one launch a call) and the library call's
    device times, and the bound of ``nbytes`` and the operations;
    ``chain_ms``, a serial chain's least time, is kept beside it
    (``chain_bound_ms``), and ``bound_note`` names the larger of the two."""
    from ethzasl_brisk_tpu_torch import measure

    got, ref = run(), plain(cpu=True)
    got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
    ref = tuple(ref) if isinstance(ref, (tuple, list)) else (ref,)
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
    bnd = measure.bound_ms(nbytes, int32_ops=int32_ops, fp32_ops=fp32_ops, fp64_ops=fp64_ops,
                           popc_ops=popc_ops)
    dev = got[0].device
    row = dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
               max_abs_err=err, ms=measure.cuda_time(run),
               device_ms=measure.device_time(run, dev, kernel_names, per_call=1),
               plain_ms=measure.cuda_time(plain), bound_ms=bnd[0], bound_by=bnd[1],
               library_ms=None if library is None else measure.cuda_time(library),
               library_device_ms=None if library is None else measure.device_time(library, dev))
    if chain_ms is not None:
        row.update(chain_bound_ms=chain_ms, bound_note="chain" if chain_ms > bnd[0] else bnd[1])
    return row


def row_text(row: dict) -> str:
    """An own-kernel row's times: event / device of the kernel, the plain
    version's event time, the library call's event / device times, the
    bounds."""
    lib = ("none" if row["library_ms"] is None
           else f"{row['library_ms']:.4f} / {row['library_device_ms']:.4f} ms")
    chain = ("" if "chain_bound_ms" not in row
             else f", chain {row['chain_bound_ms']:.5f} ms; governs: {row['bound_note']}")
    return (f"{row['ms']:.4f} / {row['device_ms']:.4f} ms (event / device) vs plain "
            f"{row['plain_ms']:.4f} ms, library {lib}, bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}){chain}")


def staged_segment_sum(lib):
    """The staged segment_sum body (``STAGED_SEGMENT_SUM_CU``, built by
    ``build_yardsticks``): its launcher, ``(values, plan) -> sums``, on the
    current stream. Not counted: it is a yardstick."""
    import ctypes

    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.staged_segment_sum.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
    lib.staged_segment_sum.restype = ci

    def run(values, plan):
        values = values.contiguous()
        out = torch.empty((plan.n, *values.shape[1:]), dtype=values.dtype, device=values.device)
        width = values[0].numel()
        if out.numel():
            err = lib.staged_segment_sum(values.data_ptr(), plan.order.data_ptr(),
                                       plan.offsets.data_ptr(), out.data_ptr(), plan.n, width,
                                       int(values.dtype == torch.float64),
                                       torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"staged segment_sum: CUDA error {err}"
        return out
    return run


def grid_stage_times(grid, img, reps: int = 10, warmup: int = 3):
    """Medians (ms) of ``reps`` grid images, total and per stage, by CUDA
    events at the stage marks, and the run's peak memory (GiB)."""
    for _ in range(warmup):
        grid.detect_and_compute(img)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, stages = [], {s: [] for s in CAMERA_STAGES}
    for _ in range(reps):
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
    return (statistics.median(totals), min(totals),
            {s: statistics.median(t) for s, t in stages.items()},
            torch.cuda.max_memory_allocated() / 2**30)


def camera_phase(dev: torch.device, card: str, kind: str) -> list:
    """The camera-aware path on a VGA bench frame taken as the distorted
    image: two grids and the single view, counted, against the CPU, timed,
    the angles stage in turns with the torch chain the walk-back kernel
    replaced. Returns the rows of walk_angles and of the elementwise angle
    kernels at the radial-tangential grid's shapes."""
    from ethzasl_brisk_tpu_torch import BriskFeature, measure
    from ethzasl_brisk_tpu_torch.core import atan2f as atan2f_mod
    from ethzasl_brisk_tpu_torch.core import sincosf as sincosf_mod
    from ethzasl_brisk_tpu_torch.describe.sampler import smoothed_intensity, smoothed_intensity_cuda
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
    expect = launches_of(harris_score_i32=1, describe_rotated=1, walk_angles=1,
                         enforce_uniformity=1, score_masks=1, layer_candidates=1,
                         refine_keypoints=1, pyramid_u8=1)
    walk, old_chain = camera_aware.walk_angles, camera_aware.walk_angles_plain
    walk_calls, atan2_calls, sincos_calls, grid_launches = [], [], [], {}

    def recording(*args, **kwargs):
        walk_calls.append((tuple(a.clone() for a in args),
                           {k: v.clone() for k, v in kwargs.items()}))
        return walk(*args, **kwargs)

    for name, cam in cams.items():
        t0 = time.perf_counter()
        grid = CameraAwareFeatureGrid(cam, feature)
        build_s = time.perf_counter() - t0
        grid_cpu = CameraAwareFeatureGrid(cam, feature_cpu, device="cpu")
        camera_aware.walk_angles = recording
        try:
            got, launches = counted(lambda: grid.detect_and_compute(host))
        finally:
            camera_aware.walk_angles = walk
        assert launches == expect, (name, launches)
        grid_launches[name] = launches
        assert got[1].shape == (got[0].capacity, 12) and bool(torch.isfinite(got[0].angle).all())
        ref = grid_cpu.detect_and_compute(host)
        n = assert_same_image_outputs(got, ref, f"[camera] {name} grid")
        assert n > 0
        if name == "radtan":
            UNIFORMITY_INPUTS["[camera] radtan grid"] = capture_uniformity(
                lambda: grid.detect_and_compute(img))
        # K2 (phase 1 and the rotated taps) and describe_rotated at the
        # grid's describe inputs (per-keypoint row_base and view limits).
        k2_calls, rot = capture_describe(lambda: grid.detect_and_compute(img))
        for phase, args in enumerate(k2_calls):
            assert torch.equal(smoothed_intensity_cuda(*args), smoothed_intensity(*args)), \
                f"[camera] {name} grid: K2 differs in phase {phase}"
        n_rot = describe_rotated_vs_plain(rot, f"[camera] {name} grid describe_rotated")
        # The angles stage in turns: the kernel, the torch chain it replaced
        # (walk_angles_plain on the card: torch ops around the elementwise
        # atan2f and sincosf kernels), the chain, the kernel. The chain's
        # first run also records the elementwise kernels' inputs.
        turns = []
        for label in ("kernel", "old chain", "old chain", "kernel"):
            camera_aware.walk_angles = walk if label == "kernel" else old_chain
            try:
                if label != "kernel":
                    undo = ([] if atan2_calls else
                            [record_calls(camera_aware, "atan2f", atan2_calls),
                             record_calls(camera_aware, "sincosf", sincos_calls)])
                    try:
                        assert_same_image_outputs(grid.detect_and_compute(img), ref,
                                                  f"[camera] {name} grid, old chain")
                    finally:
                        for u in undo:
                            u()
                turns.append((label, *grid_stage_times(grid, img)))
            finally:
                camera_aware.walk_angles = walk
        med, low, stages, peak = turns[0][1:]
        stage_txt = ", ".join(f"{s} {t:.3f}" for s, t in stages.items())
        turn_txt = "; ".join(f"{label} {st['angles']:.4f} (image {m:.3f})"
                             for label, m, _, st, _ in turns)
        print(f"[camera] {name} grid: {grid.n_views} views ({grid.n_x} x {grid.n_y}), padded view "
              f"{tuple(grid.dist_maps.shape[1:3])}, views built on the host in {build_s:.2f} s; "
              f"launches {launches}; {n} valid, GPU vs CPU: every field, the angle included, "
              f"and the descriptors bitwise; K2 (both phases' taps) and describe_rotated on "
              f"{n_rot} slots bitwise vs plain; detect_and_compute median {med:.3f} ms, min "
              f"{low:.3f} of 10 (3 warm-up); stages ms: {stage_txt}; peak mem {peak:.3f} GiB; "
              f"angles stage ms (median of 10) in turns: {turn_txt} [{kind}; {card}]",
              flush=True)

    single = CameraAwareFeature(cams["radtan"], feature)
    got, launches = counted(lambda: single.detect_and_compute(host))
    assert launches == launches_of(harris_score_i32=1, describe_rotated=1,
                                   enforce_uniformity=1, score_masks=1, layer_candidates=1,
                                   refine_keypoints=1, pyramid_u8=1), launches
    ref = CameraAwareFeature(cams["radtan"], feature_cpu).detect_and_compute(host)
    assert torch.equal(got[2].cpu(), ref[2]), "[camera] single view warp"
    n = assert_same_image_outputs(got[:2], ref[:2], "[camera] single view")
    ms = measure.cuda_time(lambda: single.detect_and_compute(img))
    print(f"[camera] single view (radtan): launches {launches}; warp bitwise, {n} valid, every "
          f"field, the angle included, and the descriptors bitwise; detect_and_compute median "
          f"{ms:.3f} ms of 10 [{kind}; {card}]", flush=True)

    # The kernels at the radial-tangential grid's shapes (its calls come
    # first): walk_angles on the grid's walk back; the public core.atan2f
    # and core.sincosf, which the grid no longer calls, each launched once
    # (counted) on the inputs the old chain gave them.
    args, kw = walk_calls[0]
    (y, x), (a_rad,) = atan2_calls[0], sincos_calls[0]
    _, elementwise = counted(lambda: (atan2f_mod.atan2f(y, x), sincosf_mod.sincosf(a_rad)))
    assert elementwise == launches_of(atan2f_elementwise=1, sincosf_elementwise=1), elementwise
    n_el = x.numel()

    def plain_walk(cpu=False):
        a, k = (([t.cpu() for t in args], {n: v.cpu() for n, v in kw.items()}) if cpu
                else (args, kw))
        return old_chain(*a, **k)

    rows = [
        own_kernel_row(
            "walk_angles", "ethzasl_brisk_tpu_torch/csrc/angle.cu",
            "none: the port's own (the camera grid's angle back-transform, jnp.sin, jnp.cos, "
            "the map lookup and jnp.arctan2; ethzasl_brisk_tpu/geometry/camera_aware.py:527-534)",
            grid_launches["radtan"]["walk_angles"],
            lambda: camera_aware.walk_angles_cuda(*args, **kw),
            plain_walk,
            None, ("walk_angles_kernel",),
            nbytes=walk_bytes(args, kw), fp32_ops=WALK_FP32_OPS * n_el,
            fp64_ops=SINCOSF_FP64_OPS * n_el),
        own_kernel_row(
            "atan2f_elementwise", "ethzasl_brisk_tpu_torch/csrc/angle.cu",
            "none: the port's own (glibc's float32 atan2, which jnp.arctan2 takes on the CPU; "
            "core.atan2f on the card)",
            elementwise["atan2f_elementwise"],
            lambda: atan2f_mod.atan2f_cuda(y, x),
            lambda cpu=False: atan2f_mod.atan2f_plain(*((y.cpu(), x.cpu()) if cpu else (y, x))),
            lambda: torch.atan2(y, x), ("atan2f_elementwise_kernel",),
            nbytes=12 * n_el, fp32_ops=ATAN2F_OPS * n_el),
        own_kernel_row(
            "sincosf_elementwise", "ethzasl_brisk_tpu_torch/csrc/angle.cu",
            "none: the port's own (glibc's float32 sin and cos, which jnp.sin and jnp.cos take "
            "on the CPU; core.sincosf on the card)",
            elementwise["sincosf_elementwise"],
            lambda: sincosf_mod.sincosf_cuda(a_rad),
            lambda cpu=False: sincosf_mod.sincosf_plain(a_rad.cpu() if cpu else a_rad),
            None, ("sincosf_elementwise_kernel",),
            nbytes=12 * n_el, fp64_ops=SINCOSF_FP64_OPS * n_el),
    ]
    for row in rows:
        print(f"[camera] {row['name']} on the grid's {n_el} keypoints: bitwise vs plain; "
              f"{row_text(row)} [{kind}; {card}]", flush=True)
    # Where atan2f_cuda's host time goes: the mean host time of a call, the
    # launches queued (the card keeps up), against torch.atan2's, and its
    # pieces: the output's allocation, _kernels.launch, the C call alone.
    from ethzasl_brisk_tpu_torch import _kernels

    out = torch.empty_like(x)
    ptrs = (y.data_ptr(), x.data_ptr(), out.data_ptr(), n_el)
    stream = torch.cuda.current_stream().cuda_stream
    c_call = _kernels._entry("atan2f_elementwise")
    host = {name: host_us(fn) for name, fn in (
        ("atan2f_cuda", lambda: atan2f_mod.atan2f_cuda(y, x)),
        ("torch.atan2", lambda: torch.atan2(y, x)),
        ("empty_like", lambda: torch.empty_like(x)),
        ("launch()", lambda: _kernels.launch("atan2f_elementwise", "atan2f_elementwise", dev,
                                             *ptrs)),
        ("the C call", lambda: c_call(*ptrs, stream)))}
    print("[camera] host us a call (mean of 500, launches queued): "
          + ", ".join(f"{k} {v:.2f}" for k, v in host.items()) + f" [{kind}; {card}]", flush=True)
    return rows


def host_us(fn, calls: int = 500) -> float:
    """Mean host time (us) of fn() over ``calls`` calls in a row, after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def walk_bytes(args, kw) -> int:
    """walk_angles' bytes: the six float32 inputs, the view index and the
    output a keypoint, and the distinct 32-byte sectors of the maps that
    its four taps read."""
    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.core.sincosf import sincosf_plain

    maps, (vidx, base_x, base_y, size) = args[0], (a.cpu() for a in args[1:5])
    sin_a, cos_a = sincosf_plain(kw["angle"].cpu() * (torch.pi / 180.0))
    # The truncation and clamps as the plain lookup takes them (on the CPU).
    hh, ww = maps.shape[1], maps.shape[2]
    xi = torch.clamp((base_x + size * cos_a).to(torch.int32), 0, ww - 2).to(torch.int64)
    yi = torch.clamp((base_y + size * sin_a).to(torch.int32), 0, hh - 2).to(torch.int64)
    corner = (vidx.to(torch.int64) * hh + yi) * ww + xi
    taps = torch.stack([corner, corner + 1, corner + ww, corner + ww + 1], -1).to(maps.device)
    return 32 * vidx.numel() + measure.distinct_sector_bytes(taps, 8, maps.numel() // 2)


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


def vo_phase(dev: torch.device, card: str, kind: str, yard: dict) -> dict:
    """The keyframed VO + window-BA loop on a VGA synthetic sequence,
    counted, against a CPU twin, timed per stage; then one of its BA windows
    alone (``ba_window``). Returns the segment_sum kernel's row."""
    import numpy as np

    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.vo import frontend, sequence
    from ethzasl_brisk_tpu_torch.vo.sequence import FRAME_STAGES, WINDOW_STAGES, run_keyframed

    # The 8-point systems' null vectors as RANSAC takes them on the card
    # (on the host's LAPACK, geometry/ransac.py's _svd): the 9th right
    # singular vector of its (512, 8, 9) and (256, 8, 9) systems, back on
    # the card; timed by CUDA events beside the card's own cuSOLVER in
    # float32 and in float64 (rounded to float32), the routes the host's
    # replaced.
    from ethzasl_brisk_tpu_torch.geometry import ransac

    rng = np.random.default_rng(VO_SEED)
    for shape in ((512, 8, 9), (256, 8, 9)):
        a = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        a_dev = a.to(dev)
        v = ransac._null_vector(a_dev, host=True)
        assert v.device == a_dev.device
        v = v.cpu()
        ref = torch.linalg.svd(a.double(), full_matrices=True)[2][..., -1, :]
        resid = float(torch.linalg.vector_norm(a @ v[..., None], dim=(-2, -1)).max())
        align = float((v.double() * ref).sum(-1).abs().min())
        assert resid < 1e-4 and align > 1 - 1e-4, (shape, resid, align)
        forms = {"host LAPACK float32": lambda: ransac._null_vector(a_dev, host=True),
                 "card cuSOLVER float32": lambda: ransac._null_vector(a_dev),
                 "card cuSOLVER float64": lambda: ransac._null_vector(a_dev.double()).float()}
        ms = {k: [] for k in forms}
        for k in [*forms, *reversed(forms)]:
            ms[k].append(measure.cuda_time(forms[k], reps=10, warmup=3))
        print(f"[vo] SVD {shape} of the card's systems: |A v| <= {resid:.2e}, |v . v_cpu64| >= "
              f"{align:.6f}; event ms in turns: "
              + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v) for k, v in ms.items())
              + f" [{kind}; {card}]", flush=True)

    t0 = time.perf_counter()
    frames, cam, gt = vo_scene(VO_FRAMES)
    render_s = time.perf_counter() - t0

    recorded, features = [], []
    process = frontend.VoFrontend.process_frame

    def recording(self, img):
        out = process(self, img)
        recorded.append(out)
        features.append(self.feature)
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
    # K1, score_masks, layer_candidates, refine_keypoints and pyramid_u8
    # once a frame and once for the frame-0 certificate, describe_rotated
    # once a frame, the segment sums once a Gauss-Newton step, 12 a BA
    # solve; the front-end's matcher keeps the matmul (no hamming_argmin).
    expect = launches_of(harris_score_i32=VO_FRAMES + 1, score_masks=VO_FRAMES + 1,
                         layer_candidates=VO_FRAMES + 1, refine_keypoints=VO_FRAMES + 1,
                         pyramid_u8=VO_FRAMES + 1, describe_rotated=VO_FRAMES,
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

    # One frame's describe (the card's feature, frame 1): describe_rotated
    # against its plain version, and in turns with the two-launch describe.
    card_feature = features[0]
    assert card_feature.device == dev
    _, rot = capture_describe(lambda: card_feature.detect_and_compute(torch.as_tensor(frames[1])))
    n_rot = describe_rotated_vs_plain(rot, "[vo] describe_rotated")
    turns = describe_turns(rot, dev, warp_describe(yard["warp_describe"][0]))
    rot_bnd = measure.bound_ms(*describe_rotated_work(rot))
    print(f"[vo describe] one frame's {n_rot} slots: describe_rotated bitwise vs plain and the "
          f"pair, event / device ms in turns: {turns_text(turns)}; bound {rot_bnd[0]:.5f} ms "
          f"({rot_bnd[1]}) [{kind}; {card}]", flush=True)
    return ba_window(windows[-1], launches["segment_sum"], card, kind, yard)


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


def ba_window(window, segment_launches: int, card: str, kind: str, yard: dict) -> dict:
    """One LM window of the [vo] loop alone: two plain solves bitwise; its
    ms and kernels with the grouped segment sums and, in turns in this
    call, with the earlier staged body (a block a segment, a launch a sum)
    and with the index_add_ scatters the sums replaced; the add-latency
    probe; the grouped kernel
    against its plain version on one Gauss-Newton step's five sums, beside
    the staged body on the same sums. Returns its kernels-line row."""
    from ethzasl_brisk_tpu_torch import measure
    from ethzasl_brisk_tpu_torch.ba import segment, window as bw

    (prob,) = window  # the loop passes the problem, and kitti_eval's settings as keywords
    solve_kw = dict(iterations=12, damping=1e-2, fix_poses=2, huber_delta=3.0)
    dev = prob.r.device

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

    staged = staged_segment_sum(yard["staged_segment_sum"][0])
    real = bw.segment_sums
    bodies = {"grouped": real,
              "staged body": lambda items: [staged(v, p) for v, p in items],
              "index_add_": lambda items: [index_add(v, p) for v, p in items]}
    res = {label: [] for label in bodies}
    for label in ("grouped", "staged body", "index_add_", "index_add_", "staged body", "grouped"):
        bw.segment_sums = bodies[label]
        try:
            res[label].append((measure.cuda_time(solve), device_kernels(solve)))
            if label == "staged body" and len(res[label]) == 1:
                old_body = solve()
        finally:
            bw.segment_sums = real
    for a, b in zip((old_body[0].r, old_body[0].t, old_body[0].points, old_body[1]),
                    (runs[0][0].r, runs[0][0].t, runs[0][0].points, runs[0][1])):
        assert torch.equal(a, b), "[vo ba] the staged body and the grouped kernel differ"
    bw.segment_sums = bodies["index_add_"]
    try:
        old = [solve() for _ in range(2)]
    finally:
        bw.segment_sums = real
    old_gap = float((old[0][0].t - old[1][0].t).abs().max())
    # One Gauss-Newton step's five sums, for the kernel's row.
    calls = []
    undo = record_calls(bw, "segment_sums", calls)
    try:
        bw._gauss_newton_step(prob, 1e-2, 2, 3.0)
    finally:
        undo()
    assert len(calls) == 1 and len(calls[0][0]) == 5, calls
    items = calls[0][0]

    def on_cpu(plan):
        return segment.SegmentPlan(plan.key.cpu(), plan.order.cpu(), plan.offsets.cpu(), plan.n)

    # The rows the sums read: the plans' kept observations (the padded,
    # invalid ones are dropped), each with its order entry; the offsets;
    # the sums written. The chain: the longest segment's adds.
    nbytes = ops = longest = 0
    for values, plan in items:
        width, kept = values[0].numel(), int(plan.offsets[-1])
        nbytes += ((kept * width + plan.n * width) * values.element_size() + 8 * kept
                   + 8 * plan.offsets.numel())
        ops += kept * width
        longest = max(longest, int((plan.offsets[1:] - plan.offsets[:-1]).max()))
    dtype = items[0][0].dtype
    latency = {t: measure.add_latency_cycles(dev, t) for t in (torch.float32, torch.float64)}
    assert all(1.0 <= c <= 64.0 for c in latency.values()), latency
    clock = measure.sm_clock_hz(dev)
    chain_ms = measure.chain_bound_ms(longest, latency[dtype], clock)
    print(f"[vo ba] add-latency probe: a dependent __fadd_rn {latency[torch.float32]:.3f} "
          f"cycles, __dadd_rn {latency[torch.float64]:.3f} cycles; SM clock max "
          f"{clock / 1e6:.0f} MHz; the step's longest segment {longest} rows: chain bound "
          f"{chain_ms:.6f} ms [{kind}; {card}]", flush=True)
    row = own_kernel_row(
        "segment_sum", "ethzasl_brisk_tpu_torch/csrc/segment_sum.cu",
        "none: the port's own (the BA's scatter-adds, which the JAX package leaves to XLA; "
        "ethzasl_brisk_tpu/ba/window.py)",
        segment_launches,
        lambda: segment.segment_sums_cuda(items),
        lambda cpu=False: [segment.segment_sum_plain(v.cpu(), on_cpu(p)) if cpu
                           else segment.segment_sum_plain(v, p) for v, p in items],
        lambda: [index_add(v, p) for v, p in items], ("segment_sums_kernel",),
        nbytes=nbytes, fp32_ops=ops if dtype == torch.float32 else 0.0,
        fp64_ops=ops if dtype == torch.float64 else 0.0, chain_ms=chain_ms)
    # The staged body on the same five sums (five launches), in this call.
    got_staged = [staged(v, p) for v, p in items]
    assert all(torch.equal(a, b) for a, b in zip(got_staged, segment.segment_sums_cuda(items)))
    row["staged_ms"] = measure.cuda_time(lambda: [staged(v, p) for v, p in items])
    row["staged_device_ms"] = measure.device_time(lambda: [staged(v, p) for v, p in items], dev,
                                                ("staged_segment_sum_kernel",),
                                                per_call=len(items))
    txt = "; ".join(f"{label} {', '.join(f'{ms:.3f} ms / {n} kernels' for ms, n in v)}"
                    for label, v in res.items())
    print(f"[vo ba] the loop's last LM window ({prob.r.shape[0]} keyframes, "
          f"{prob.points.shape[0]} landmark slots, {prob.kf_idx.shape[0]} observation slots, "
          f"{dtype}, 12 iterations): two plain solves bitwise (deterministic algorithms off; "
          f"with index_add_ they differ by {old_gap:.3g} in t), the staged body bitwise the "
          f"grouped kernel; a solve by CUDA events (median of 10) and its kernels, in turns: "
          f"{txt}. segment_sum, one step's five sums in one launch: bitwise vs the CPU's "
          f"index_add_; {row_text(row)}; the staged body (five launches) {row['staged_ms']:.4f} / "
          f"{row['staged_device_ms']:.4f} ms [{kind}; {card}]", flush=True)
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
    expect = launches_of(harris_score_i32=frames_run + 1, score_masks=frames_run + 1,
                         layer_candidates=frames_run + 1, refine_keypoints=frames_run + 1,
                         pyramid_u8=frames_run + 1, describe_rotated=frames_run,
                         segment_sum=launches["segment_sum"])
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
            assert launches["harris_score_i32"] == launches["describe_rotated"] == 1, launches
            assert launches["enforce_uniformity"] == launches["score_masks"] == 1, launches
            assert launches["layer_candidates"] == launches["refine_keypoints"] == 1, launches
            assert launches["smoothed_intensity"] == 0, launches
            assert launches["pyramid_u8"] == launches["hamming_argmin"] == 1, launches
            assert_same_step(got[:4], (kps, desc, midx, mdist), "[dist] step over the mesh")
            assert bool(got[4]["detect"].ok.all())
            ast_det = BriskFeatureDetector(**AST_DETECTOR, device=dev)
            ast_plain = AstFramePipeline(ast_det, dev, **AST_PIPELINE).step(frames16[:4])
            ast_got, ast_launches = counted(lambda: AstFramePipeline(
                ast_det, dev, mesh=mesh, **AST_PIPELINE).step(frames16[:4]))
            assert ast_launches == launches_of(describe_rotated=1, pyramid_u8=1,
                                               hamming_argmin=1), ast_launches
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
    every step's rotation within the [vo] phase's 0.02; no step's
    translation may leave the CPU's by more than 0.01 (the rays and the
    8-point hypotheses' SVD run on the host on both devices, so a weak
    pair, step 11 of the stressed run, no longer takes another translation
    on the card), and
    both runs are held to the rest of that bar (aligned centres within 5 %
    of the path, the ATE within 1 %)."""
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
        assert launches == launches_of(harris_score_i32=n, score_masks=n, layer_candidates=n,
                                       refine_keypoints=n, describe_rotated=n, pyramid_u8=n), \
            launches
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
        flips = [int(i) + 1 for i in np.flatnonzero(t_gap > 0.01)]
        assert rot_gap <= 0.02, (label, rot_gap)
        assert not flips, (label, flips, t_gap.tolist())
        # The [vo] phase's bar.
        assert centre_gap <= 0.05 * path, (label, centre_gap)
        assert abs(got["ate"] - exp["ate"]) <= 0.01 * path, (label, got["ate"], exp["ate"])
        print(f"[vo tools] vo.synthetic {label}, {n} VGA frames (rendered on the host in "
              f"{render_s:.2f} s): launches {launches}; detection, angles and descriptors "
              f"bitwise the CPU twin's (same draws) on every frame; steps' rotations within "
              f"{rot_gap:.2e}, translation directions within {float(t_gap.max()):.3g} "
              f"(step 11 {float(t_gap[10]) if len(t_gap) > 10 else float('nan'):.3g}; none "
              f"apart by more than 0.01); aligned camera centres within {centre_gap:.2e}; ATE "
              f"{got['ate']:.5f} (CPU {exp['ate']:.5f}) on a {path:.3f} "
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
            harris_score_i32=VO_TOOLS_CLI_FRAMES, score_masks=VO_TOOLS_CLI_FRAMES,
            layer_candidates=VO_TOOLS_CLI_FRAMES, refine_keypoints=VO_TOOLS_CLI_FRAMES,
            describe_rotated=VO_TOOLS_CLI_FRAMES, pyramid_u8=VO_TOOLS_CLI_FRAMES), eval_launches
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
    assert launches["harris_score_i32"] == launches["score_masks"] == n_batches + 1, launches
    assert launches["layer_candidates"] == launches["refine_keypoints"] == n_batches + 1, \
        launches
    assert launches["describe_rotated"] == n_batches, launches
    # pyramid_u8 with every detection (the certificate's too), hamming_argmin
    # once a batch's step.
    assert launches["pyramid_u8"] == n_batches + 1, launches
    assert launches["hamming_argmin"] == n_batches, launches
    assert launches["smoothed_intensity"] == launches["enforce_uniformity"] == 0, launches
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
    assert (demo_launches["harris_score_i32"] == demo_launches["describe_rotated"]
            == demo_launches["score_masks"] == demo_launches["layer_candidates"]
            == demo_launches["refine_keypoints"] == demo_launches["pyramid_u8"] == 1), \
        demo_launches
    assert demo_launches["hamming_argmin"] == 0, demo_launches
    assert demo_launches["smoothed_intensity"] == demo_launches["enforce_uniformity"] == 0, \
        demo_launches
    print(f"[examples] cameras_demo on the card: {demo}; launches {demo_launches} "
          f"[{kind}; {card}]", flush=True)


def time_steps() -> int:
    """``python3 chip_smoke.py --time-steps``, run from the root of a tree of
    the port: that tree's package (built from its own sources) times the
    default step, ``BENCH_CONFIG`` on bench frames, at B=16 and B=128 by
    ``timed_steps``, and prints one JSON line of the medians, minima,
    stage medians and peak memory. Two trees run from their own roots in
    turns (A, B, B, A) compare on one card."""
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ethzasl_brisk_tpu_torch import BriskFeature, FramePipeline, measure
    from ethzasl_brisk_tpu_torch.frames import bench_frames

    dev = torch.device("cuda", 0)
    pipe = FramePipeline(BriskFeature(**BENCH_CONFIG))
    steps = {}
    for batch in (16, 128):
        frames = torch.from_numpy(bench_frames(batch)).to(dev)
        torch.cuda.reset_peak_memory_stats()
        med, low, stages = timed_steps(pipe, frames, STAGES + ("match",))
        steps[batch] = dict(median_ms=med, min_ms=low, stages=stages,
                            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(json.dumps({"tree": os.getcwd(), "card": measure.card_line(dev), "steps": steps}),
          flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--time-steps"]:
        return time_steps()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from ethzasl_brisk_tpu_torch import BriskFeature, FramePipeline, _kernels, measure
    from ethzasl_brisk_tpu_torch.describe import orientation
    from ethzasl_brisk_tpu_torch.describe.rotated import describe_rotated_cuda, describe_rotated_plain
    from ethzasl_brisk_tpu_torch.describe.sampler import (
        smoothed_intensity,
        smoothed_intensity_cuda,
    )
    from ethzasl_brisk_tpu_torch.detect import scale_space, uniformity
    from ethzasl_brisk_tpu_torch.frames import bench_frames
    from ethzasl_brisk_tpu_torch.kernels.harris import (
        harris_score_i32,
        harris_score_i32_cuda,
        harris_score_i32_layers,
        harris_score_mask_cuda,
        harris_score_mask_i32,
        harris_score_mask_layers,
    )
    from ethzasl_brisk_tpu_torch.kernels.candidates import layer_candidates
    from ethzasl_brisk_tpu_torch.kernels.nms import maxima2d_mask
    from ethzasl_brisk_tpu_torch.probes import cases as probe_cases
    cuda_time = measure.cuda_time

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = measure.card_line(dev)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"[card] {card}", flush=True)

    # The kernels and the yardsticks, every nvcc run at once.
    t0 = time.perf_counter()
    yard = {}
    builder = threading.Thread(target=lambda: yard.update(build_yardsticks()))
    builder.start()
    lib_path = _kernels.build()
    _kernels.library()
    builder.join()
    assert set(yard) == {"staged_segment_sum", "warp_describe", "describe_words_ballot",
                         "empty_kernel"}, yard
    log = lib_path.with_suffix(".log")
    regs = ptxas_lines(log.read_text() if log.exists() else "", "describe_rotated_kernel")
    uniformity_regs = ptxas_lines(log.read_text() if log.exists() else "", "uniformity_kernel")
    masks_regs = ptxas_lines(log.read_text() if log.exists() else "", "score_masks_kernel")
    candidates_regs = ptxas_lines(log.read_text() if log.exists() else "", "candidates_kernel")
    refine_regs = ptxas_lines(log.read_text() if log.exists() else "", "refine_kernel")
    match_regs = ptxas_lines(log.read_text() if log.exists() else "", "hamming_argmin_kernel")
    pyramid_regs = ptxas_lines(log.read_text() if log.exists() else "", "pyramid_u8_kernel")
    uniformity_kernel = install_uniformity_check()
    print(f"[build] {lib_path.name} and {len(yard)} yardsticks in "
          f"{time.perf_counter() - t0:.2f} s; describe_rotated's ptxas: {regs}; the words a "
          f"ballot a word: {yard['describe_words_ballot'][1]}; the warp kernel: "
          f"{yard['warp_describe'][1]}; enforce_uniformity's: {uniformity_regs}; score_masks': "
          f"{masks_regs}; layer_candidates': "
          f"{candidates_regs}; refine_keypoints': {refine_regs}; hamming_argmin's: {match_regs}; "
          f"pyramid_u8's: {pyramid_regs}", flush=True)

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

    # ---- K2 against its plain version at the taps of both samplings
    # describe_rotated takes at the B=16 describe (the unrotated pattern, and
    # the rotated one at the plain chain's theta), and describe_rotated
    # against its plain version there.
    k2_calls, rot16 = capture_describe(
        lambda: feature.describe(frames16, feature.detect(frames16)))
    k2_err = 0
    for phase, args in enumerate(k2_calls):
        got = smoothed_intensity_cuda(*args)
        ref = smoothed_intensity(*args)
        torch.cuda.synchronize()
        k2_err = max(k2_err, int((got.to(torch.int64) - ref).abs().max()))
        assert torch.equal(got, ref), f"K2 differs in phase {phase}"
    n_rot = describe_rotated_vs_plain(rot16, "[describe_rotated] B=16")
    print(f"[K2] bitwise equal to plain on the unrotated and the rotated taps of the main "
          f"step's describe, K x P = {tuple(k2_calls[0][3].shape)}; [describe_rotated] bitwise "
          f"equal to plain (angle and words) on {n_rot} slots", flush=True)

    # ---- The main path, counted.
    torch.cuda.synchronize()
    _kernels.reset_launches()
    with uniformity_checked():
        kps, desc, midx, mdist, diag = pipe.step(frames16, with_diagnostics=True)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    assert launches["harris_score_i32"] == 1, launches
    assert launches["describe_rotated"] == 1, launches
    assert launches["enforce_uniformity"] == 1, launches  # the four layers
    assert launches["score_masks"] == 1, launches  # the four layers
    assert launches["layer_candidates"] == launches["refine_keypoints"] == 1, launches
    assert launches["smoothed_intensity"] == launches["brisk_orientation"] == 0, launches
    assert launches["pyramid_u8"] == launches["hamming_argmin"] == 1, launches
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
    with uniformity_checked():
        fused_out = fused_pipe.step(frames16)
    torch.cuda.synchronize()
    fused_launches = dict(_kernels.LAUNCHES)
    assert fused_launches["harris_score_mask"] == 1, fused_launches
    assert fused_launches["enforce_uniformity"] == 1, fused_launches
    assert fused_launches["score_masks"] == 1, fused_launches  # on K3's masks
    assert fused_launches["layer_candidates"] == fused_launches["refine_keypoints"] == 1, \
        fused_launches
    assert fused_launches["harris_score_i32"] == 0, fused_launches
    assert fused_launches["describe_rotated"] == 1, fused_launches
    assert fused_launches["smoothed_intensity"] == 0, fused_launches
    assert fused_launches["pyramid_u8"] == fused_launches["hamming_argmin"] == 1, fused_launches
    assert_same_step(fused_out, (kps, desc, midx, mdist), "fused vs default step")
    print(f"[fused path] step B={b}: launches {fused_launches}; keypoints, descriptors "
          f"and matches bitwise equal to the default step", flush=True)
    UNIFORMITY_INPUTS["B=16"] = capture_uniformity(lambda: feature.detect(frames16))
    # The candidates route's own traffic: radius 10, whose grids at VGA's
    # two largest layers exceed a CTA's shared memory.
    feature_r10 = BriskFeature(**{**BENCH_CONFIG, "uniformity_radius": 10.0})
    UNIFORMITY_INPUTS["B=16, radius 10"] = capture_uniformity(
        lambda: feature_r10.detect(frames16))
    del feature_r10

    # ---- GPU step against the plain CPU step on the first 4 frames.
    f4 = frames16[:4]
    f4c = f4.cpu()
    feature_cpu = BriskFeature(**BENCH_CONFIG, device="cpu")
    cfg = feature.config
    pyr_g, pyr_c = scale_space.build_pyramid(f4, 4), scale_space.build_pyramid(f4c, 4)
    caps4 = [cfg.layer_cap(i) for i in range(4)]
    _kernels.reset_launches()
    sc_g, mk_g = scale_space.layer_score_masks(pyr_g, cfg)
    cands_g, counts_g = layer_candidates(sc_g, mk_g, caps4)
    assert _kernels.LAUNCHES["score_masks"] == _kernels.LAUNCHES["layer_candidates"] == 1, \
        _kernels.LAUNCHES
    sc_c, mk_c = scale_space.layer_score_masks(pyr_c, cfg)
    cands_c, counts_c = layer_candidates(sc_c, mk_c, caps4)
    assert torch.equal(counts_g.cpu(), counts_c), "candidate counts"
    for i in range(4):
        assert torch.equal(pyr_g[i].cpu(), pyr_c[i]), f"pyramid layer {i}"
        assert torch.equal(sc_g[i].cpu(), sc_c[i]), f"scores layer {i}"
        assert torch.equal(mk_g[i].cpu(), mk_c[i]), f"masks layer {i}"
        for a, c in zip(cands_g[i], cands_c[i]):
            assert torch.equal(a.cpu(), c), f"candidates layer {i}"
        with uniformity_checked():
            accept_g = scale_space._layer_accept(cands_g[i], cfg, tuple(sc_g[i].shape[-2:]))
        assert torch.equal(accept_g.cpu(), scale_space._layer_accept(cands_c[i], cfg)), \
            f"accept layer {i}"
    out_g = FramePipeline(feature).step(f4)
    out_c = FramePipeline(feature_cpu, device="cpu").step(f4c)
    kg, kc = out_g[0], out_c[0]
    for name in ("x", "y", "size", "response", "octave", "valid"):
        assert torch.equal(getattr(kg, name).cpu(), getattr(kc, name)), name
    gx, gy = ulp_gap(kg.x, kc.x), ulp_gap(kg.y, kc.y)
    assert torch.equal(kg.angle.cpu(), kc.angle), "angle"
    n_desc = int(kc.valid.sum())
    assert n_desc > 0
    for i, name in ((1, "descriptors"), (2, "match index"), (3, "match distance")):
        assert torch.equal(out_g[i].cpu(), out_c[i]), name
    print(
        f"[gpu vs cpu] B=4: pyramid, scores, masks (score_masks, 1 launch), candidates "
        f"(layer_candidates, 1 launch) and their counts, accepts, every keypoint field "
        f"bitwise (x/y {max(gx, gy)} ULP apart); the angles of all {n_desc} described keypoints, "
        f"descriptors and matches bitwise",
        flush=True,
    )

    # ---- The README quick start, through PGM files, counted.
    quick_start(dev)

    # ---- The 16-bit pipeline, the facade's knobs and the AST path, each counted.
    u16_launches = u16_phase(dev, card)
    facade_launches = facade_phase(dev, card)
    ast_phase(dev, card, kind, yard)
    v1_row = v1_phase(dev, card, kind)
    camera_rows = camera_phase(dev, card, kind)
    segment_row = vo_phase(dev, card, kind, yard)
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

    # ---- The orientation kernel at the main path's B=16 shapes: the
    # gradient of its describe's phase-1 values (the [u16] path launches it).
    from ethzasl_brisk_tpu_torch.describe.rotated import long_pair_gradient

    d0, d1 = long_pair_gradient(rot16[0], smoothed_intensity_cuda(*k2_calls[0]))
    o_args = (d0, d1, rot16[6], rot16[6] == -1.0)
    n_kp = d0.numel()
    orientation_row = own_kernel_row(
        "brisk_orientation", "ethzasl_brisk_tpu_torch/csrc/angle.cu",
        "none: the port's own (the angle chain the JAX package leaves to XLA, jnp.arctan2; "
        "ethzasl_brisk_tpu/describe/extractor.py:1061-1068)",
        u16_launches["brisk_orientation"],
        lambda: orientation.orientation_cuda(*o_args),
        lambda cpu=False: orientation.orientation_plain(
            *(t.cpu() if cpu and torch.is_tensor(t) else t for t in o_args)),
        lambda: torch.atan2(o_args[1].float(), o_args[0].float()), ("brisk_orientation_kernel",),
        nbytes=25 * n_kp, fp32_ops=ORIENTATION_OPS * n_kp)
    print(f"[orientation] B=16 step's {n_kp} keypoint slots: bitwise vs plain; "
          f"{row_text(orientation_row)}; library: torch.atan2; launches: [u16]'s "
          f"{u16_launches['brisk_orientation']} [{kind}; {card}]", flush=True)
    # The floor under walk_angles', sincosf_elementwise's and
    # brisk_orientation's device times: an empty launch's.
    floor = empty_floor(yard["empty_kernel"][0], dev)
    print("[floor] an empty kernel's device ms: " + ", ".join(
        f"{shape} threads {ms:.5f}" for shape, ms in floor.items()) + f" [{kind}; {card}]",
        flush=True)

    # ---- describe_rotated at the main path's B=16 shapes.
    rot_bytes, rot_int, rot_fp = describe_rotated_work(rot16)
    describe_row = own_kernel_row(
        "describe_rotated", "ethzasl_brisk_tpu_torch/csrc/describe.cu",
        "ethzasl_brisk_tpu/describe/extractor.py:890-1081 (_describe_core on the Pallas route: "
        "both calls of describe/pallas_sampler.py:443, the gradient, jnp.arctan2 and the chain, "
        "_pack_descriptor)",
        launches["describe_rotated"],
        lambda: describe_rotated_cuda(*rot16),
        lambda cpu=False: describe_rotated_plain(*(to_cpu(rot16) if cpu else rot16)),
        None, ("describe_rotated_kernel",), nbytes=rot_bytes, int32_ops=rot_int, fp32_ops=rot_fp)
    pair = warp_describe(yard["warp_describe"][0])
    host = {"kernel": host_us(lambda: describe_rotated_cuda(*rot16), 200),
            "pair": host_us(lambda: pair(rot16), 200)}
    print(f"[describe_rotated] B=16 step's {n_rot} slots: bitwise vs plain; {row_text(describe_row)} "
          f"({rot_int:.3g} int32 and {rot_fp:.3g} float32 operations); host us a call (mean of "
          f"200, launches queued): kernel {host['kernel']:.2f}, pair {host['pair']:.2f} "
          f"[{kind}; {card}]", flush=True)

    # ---- score_masks against its plain version, in turns, at the step's shapes.
    masks_row = masks_phase(dev, card, kind, launches["score_masks"], masks_regs)
    print(f"[masks] B=16 step's four layers: {row_text(masks_row)}; "
          f"launches: the main path's {launches['score_masks']} [{kind}; {card}]", flush=True)

    # ---- layer_candidates and refine_keypoints against their plain
    # versions, in turns, at the step's shapes.
    candidates_row = candidates_phase(dev, card, kind, launches["layer_candidates"],
                                      candidates_regs)
    print(f"[candidates] B=16 step's four layers: {row_text(candidates_row)}; launches: the "
          f"main path's {launches['layer_candidates']} [{kind}; {card}]", flush=True)
    refine_row = refine_phase(dev, card, kind, launches["refine_keypoints"], refine_regs,
                              feature, fused_feature)
    print(f"[refine] B=16 step: {row_text(refine_row)}; launches: the main path's "
          f"{launches['refine_keypoints']} [{kind}; {card}]", flush=True)

    # ---- hamming_argmin and pyramid_u8 against their plain versions, in
    # turns, at the step's shapes.
    match_row = match_phase(dev, card, kind, launches["hamming_argmin"], match_regs, pipe,
                            (desc, kps.valid))
    print(f"[match] B=16 step: {row_text(match_row)}; launches: the main path's "
          f"{launches['hamming_argmin']} [{kind}; {card}]", flush=True)
    pyramid_row = pyramid_phase(dev, card, kind, launches["pyramid_u8"], pyramid_regs)
    print(f"[pyramid] B=16 step: {row_text(pyramid_row)}; launches: the main path's "
          f"{launches['pyramid_u8']} [{kind}; {card}]", flush=True)

    # ---- Timing.
    stage_names = ["pyramid", "harris", "masks", "candidates", "uniformity", "refine",
                   "describe", "match"]
    real_uniformity_layers = scale_space.enforce_uniformity_layers

    for batch in (16, 128):
        frames = torch.from_numpy(bench_frames(batch)).to(dev)
        if batch == 128:
            UNIFORMITY_INPUTS["B=128"] = capture_uniformity(lambda: feature.detect(frames))
        # In turns (default, fused, blocked, blocked, fused, default), so the
        # three compare in one call; "blocked step" is the default step with
        # the blocked uniformity path (the plain version) in the kernel's place.
        for label, p in (("step", pipe), ("fused step", fused_pipe), ("blocked step", pipe),
                         ("blocked step", pipe), ("fused step", fused_pipe), ("step", pipe)):
            torch.cuda.reset_peak_memory_stats()
            if label == "blocked step":
                scale_space.enforce_uniformity_layers = blocked_uniformity
            try:
                ms, _, stages = timed_steps(p, frames, stage_names)
            finally:
                scale_space.enforce_uniformity_layers = real_uniformity_layers
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
        # K2 at the step's phase-1 taps (describe_rotated samples both
        # phases; K2 runs on angle_exact's path).
        calls, rot = capture_describe(lambda: feature.describe(frames, feature.detect(frames)))
        calls = calls[:1]
        k1_ms = cuda_time(lambda: harris_score_i32_layers(pyr))
        k1_plain = cuda_time(lambda: [harris_score_i32(p) for p in pyr])
        k2_ms = cuda_time(lambda: [smoothed_intensity_cuda(*a) for a in calls])
        k2_plain = cuda_time(lambda: [smoothed_intensity(*a) for a in calls])
        k3_ms = cuda_time(lambda: harris_score_mask_layers(pyr, thr))
        k3_plain = cuda_time(lambda: [harris_score_mask_i32(p, thr) for p in pyr])
        k1_nms = cuda_time(lambda: [maxima2d_mask(s, thr) for s in harris_score_i32_layers(pyr)])
        # The kernels' own time on the card, each step's launches from a cold L2.
        k1_dev = measure.device_time(lambda: harris_score_i32_layers(pyr), dev,
                                     ("harris_rows_kernel",), per_call=1)
        k2_dev = measure.device_time(lambda: [smoothed_intensity_cuda(*a) for a in calls], dev,
                                     ("k2_sampler_kernel",), per_call=len(calls))
        k3_dev = measure.device_time(lambda: harris_score_mask_layers(pyr, thr), dev,
                                     ("harris_mask_rows_kernel",), per_call=1)
        # Bounds: K1 reads 1 B and writes 4 B per pixel, K3 one more byte.
        pixels = sum(p.numel() for p in pyr)
        k1_bound = measure.bound_ms(5 * pixels, int32_ops=K1_OPS_PER_PIXEL * pixels)
        k3_bound = measure.bound_ms(6 * pixels, int32_ops=K3_OPS_PER_PIXEL * pixels)
        k2_bnd = k2_bound(calls)
        print(
            f"[timing] kernels B={batch}, per step (K1, K3: 4 layers, {pixels} pixels; K2: the "
            f"unrotated samples, K={calls[0][3].shape[0]}): K1 {k1_ms:.3f} ms (device {k1_dev:.4f} ms) vs "
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
        # describe_rotated against its plain version, and in turns with the
        # two-launch describe it replaced (K2's phase 1 with its gathers and
        # the warp kernel), and its bound.
        if batch != 16:
            describe_rotated_vs_plain(rot, f"[timing] describe_rotated B={batch}")
        turns = describe_turns(rot, dev, warp_describe(yard["warp_describe"][0]))
        rot_bnd = measure.bound_ms(*describe_rotated_work(rot))
        # Its words a thread a word, against the same source built with a
        # ballot a (keypoint, word).
        words = describe_turns(rot, dev, words_ballot(yard["describe_words_ballot"][0]),
                               "a ballot a word")
        print(f"[timing] describe_rotated B={batch}, {rot[4].numel()} slots, bitwise vs plain and "
              f"the pair, event / device ms in turns: {turns_text(turns)}; bound "
              f"{rot_bnd[0]:.5f} ms ({rot_bnd[1]}); the words a thread a word (kernel) or a "
              f"ballot a word: {turns_text(words)} [{kind}; {card}]", flush=True)
        del frames, pyr, calls, rot
        torch.cuda.empty_cache()

    # ---- enforce_uniformity against the blocked path in turns, its bounds.
    uniformity_row = uniformity_phase(dev, card, kind, uniformity_kernel,
                                      launches["enforce_uniformity"], uniformity_regs)
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
             facade_launches["smoothed_intensity"], k2_err, "k2"),
            ("harris_score_mask", "harris.cu",
             "ethzasl_brisk_tpu/kernels/pallas_harris.py:177",
             fused_launches["harris_score_mask"], k3_err, "k3"),
        )
    ] + [v1_row, describe_row, orientation_row] + camera_rows + [
        segment_row, uniformity_row, masks_row, candidates_row, refine_row, match_row,
        pyramid_row] + probe_rows
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"[wall] {time.perf_counter() - t_start:.1f} s from start to the kernels line", flush=True)
    print(f"[card] {card}", flush=True)
    # The run uses one card, whatever the machine holds.
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

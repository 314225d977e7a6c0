"""Utilization and roofline accounting for the step's stages (port of
``utils/roofline.py``).

Two parts:

* :func:`measure_peaks` measures THIS device's achievable float32 and
  bfloat16 matmul GFLOP/s and its read GB/s (CUDA events on the card,
  ``perf_counter`` on the CPU). The float32 matmul runs at the process's
  current ``torch.get_float32_matmul_precision()``, which it reports and
  does not change (the port sets no process-wide flag). ``measure.bound_ms``
  keeps the data-sheet peaks; these are the card's own.

* :func:`stage_model` is static shape math for the stages' algorithmic
  work, as in the JAX package: exact operation counts for the match,
  order-of-magnitude op counts for the stencil stages, byte counts the
  MINIMUM traffic (inputs read once, outputs written once). Sort-bound
  stages (top_k) get bytes only. Every row but ``describe``,
  ``uniformity``, ``match`` and ``pyramid`` equals the JAX row for the
  same shapes. The JAX ``uniformity`` row models the TPU's blocked pairwise suppression; the
  port's counts the reference's own work, which kernel
  ``enforce_uniformity`` (``csrc/uniformity.cu``) does on its grid route:
  per candidate its x, y, score and flag read once and its mask byte
  written once, and per accept the paint of its 31x31 patch (the LUT
  product and its ceil in float32, the saturating add in int32: four
  operations a cell), with at most ``max_keypoints`` accepts a (frame,
  layer). So the yardstick does not move with the kernel's design.
  The JAX ``describe`` row models
  the TPU's one-hot bf16 contraction, work the port never does, so a share
  of the bf16 matmul peak would be fiction here. The port's row counts
  the two samplings at kernel K2's work a point instead (``csrc/sampler.cu``,
  whose point code kernel ``describe_rotated`` runs for both): per
  slot and phase, each pattern point's integral taps (22 of the box
  branch, 4 bytes each), the keypoint's inputs (x, y, frame row), each
  point's pattern inputs and output (6 words), and the box branch's 149
  operations a point (119 int32, 30 float32), with kind ``"bw"``.
  Two rows model the port's kernels where the JAX package has another
  algorithm or no row: ``match`` counts kernel ``hamming_argmin``'s work
  (``csrc/match.cu``), a popcount a word of every (query, train) pair of
  the (B-1) adjacent pairs, against one read of the descriptors and valid
  flags and one write of the best index and distance, kind ``"int"``
  (the JAX row is the +-1 matmul's FLOPs); ``pyramid`` (no JAX row) counts
  kernel ``pyramid_u8``'s (``csrc/pyramid.cu``): the frames read once, the
  derived layers written once, ~15 int32 operations a two-thirds output
  and ~10 a half output, kind ``"bw"``.

:func:`report` combines measured stage times with the model.
"""
from __future__ import annotations

import time

import torch

from ethzasl_brisk_tpu_torch.core.device import resolve_device
from ethzasl_brisk_tpu_torch.kernels.downsample import layer_sizes

# K2 per (slot, point), counted from csrc/sampler.cu (chip_smoke.py's
# K2_TAPS and K2_OPS_BOX): the box branch's integral taps and operations.
K2_TAPS_PER_POINT = 22
K2_OPS_PER_POINT = 119 + 30
K2_WORDS_PER_POINT = 6   # pattern x, y, sigma, scaling, scaling2 in; the value out
K2_WORDS_PER_SLOT = 3    # key x, key y, frame row
# Greedy uniformity per candidate: x, y, score (4 B each) and valid in, the
# mask byte out; per accept, the reference's paint of its 31 x 31 patch
# (uniformity-enforcement-inl.h): the LUT product and its ceil in float32,
# the saturating add in int32, two operations each a cell.
UNIFORMITY_BYTES_PER_CANDIDATE = 14
UNIFORMITY_PAINT_FP32_OPS = 2 * 31 * 31
UNIFORMITY_PAINT_INT32_OPS = 2 * 31 * 31
# Kernel pyramid_u8's int32 operations an output pixel: a two-thirds output
# (20 averages of 3 operations a 2 x 2 block) and a half output (3 averages
# and the clamp).
PYRAMID_TWOTHIRDS_OPS = 15
PYRAMID_HALF_OPS = 10


def _timed_ms(fn, device: torch.device, reps: int, iters: int = 4) -> float:
    """Best over ``reps`` of the mean time (ms) of ``iters`` calls, after
    three warm-up calls; CUDA events on the card, perf_counter on the CPU."""
    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best


def measure_peaks(reps: int = 3, device: str | torch.device = "cuda") -> dict:
    """Measured peak f32/bf16 matmul GFLOP/s and read GB/s of ``device``,
    with the float32 matmul precision they ran at and the device's name."""
    dev = resolve_device(device)
    n = 2048
    flops = 2.0 * n * n * n

    def mm_peak(dtype):
        a = torch.ones((n, n), dtype=dtype, device=dev)
        return flops / (_timed_ms(lambda: torch.mm(a, a), dev, reps) / 1e3) / 1e9

    peak_gflops = mm_peak(torch.float32)
    peak_gflops_bf16 = mm_peak(torch.bfloat16)

    m = 64 * 1024 * 1024 // 4  # 64 MB f32
    big = torch.ones((m,), dtype=torch.float32, device=dev)
    read_ms = _timed_ms(lambda: big.sum(), dev, reps)
    return {
        "peak_gflops": peak_gflops,
        "peak_gflops_bf16": peak_gflops_bf16,
        "peak_gbs": (m * 4) / (read_ms / 1e3) / 1e9,
        "f32_matmul_precision": torch.get_float32_matmul_precision(),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def _pyramid_pixels(h: int, w: int, n_layers: int) -> float:
    """Total pixels across the scale-space pyramid."""
    px = 0.0
    dims = [(h, w)]
    if n_layers > 1:
        dims.append((2 * h // 3, 2 * w // 3))
    for i in range(2, n_layers):
        ph, pw = dims[i - 2]
        dims.append((ph // 2, pw // 2))
    for ph, pw in dims[:n_layers]:
        px += ph * pw
    return px


def stage_model(
    *,
    batch: int,
    h: int,
    w: int,
    n_layers: int,
    max_candidates: int,
    max_keypoints: int,
    describe_slots: int,
    pattern_points: int = 66,
    desc_words: int = 12,
) -> dict:
    """Static per-stage (gflops, gbytes, kind) for the Harris step at the
    given shapes. kind: 'mxu' (flops meaningful), 'bw' (bandwidth-bound),
    'int' (integer-operation-bound: gflops counts the match's popcounts),
    'sort' (comparison-bound: flops not meaningful, bytes one read of the
    sorted operands, an upper bound on useful-traffic utilization)."""
    px = _pyramid_pixels(h, w, n_layers) * batch

    stages = {}
    # Pyramid: kernel pyramid_u8, the frames read once and the derived
    # layers written once (module docstring).
    derived = [ph * pw * batch for ph, pw in layer_sizes(h, w, n_layers)[1:]]
    stages["pyramid"] = dict(
        gflops=1e-9 * (PYRAMID_TWOTHIRDS_OPS * sum(derived[:1])
                       + PYRAMID_HALF_OPS * sum(derived[1:])),
        gbytes=1e-9 * (h * w * batch + sum(derived)),
        kind="bw",
    )
    # Harris scores: Scharr dx/dy + 3 products + 3x3 Gauss x3 + det -
    # trace^2/16, ~60 integer ops/px; min bytes: u8 in + i32 score out.
    stages["scores"] = dict(gflops=60e-9 * px, gbytes=5e-9 * px, kind="bw")
    # Maxima masks + cross-layer warp compares: ~40 ops/px over the
    # pyramid, score maps re-read ~3x (self + neighbors), bool out.
    stages["masks"] = dict(gflops=40e-9 * px, gbytes=13e-9 * px, kind="bw")
    # Candidates in score order: a sort of the masked maps; one read of
    # the (value, index) pairs is the algorithmic minimum.
    stages["top_k"] = dict(gflops=0.0, gbytes=8e-9 * px, kind="sort")
    # Uniformity: kernel enforce_uniformity over max_candidates a (frame,
    # layer) (module docstring).
    k = max_candidates
    accepts = min(max_keypoints, k)
    stages["uniformity"] = dict(
        gflops=1e-9 * (UNIFORMITY_PAINT_FP32_OPS + UNIFORMITY_PAINT_INT32_OPS) * accepts
        * n_layers * batch,
        gbytes=1e-9 * UNIFORMITY_BYTES_PER_CANDIDATE * k * n_layers * batch,
        kind="bw",
    )
    # Refine: 9 flat gathers over the accepted prefix + quadratic fit.
    kk = max_keypoints
    stages["refine"] = dict(
        gflops=60e-9 * kk * n_layers * batch,
        gbytes=9 * 4e-9 * kk * n_layers * batch,
        kind="bw",
    )
    # Describe: two samplings at K2's work a point, per slot (module docstring).
    slots = describe_slots * batch
    words = K2_WORDS_PER_SLOT + pattern_points * (K2_TAPS_PER_POINT + K2_WORDS_PER_POINT)
    stages["describe"] = dict(
        gflops=1e-9 * K2_OPS_PER_POINT * pattern_points * 2 * slots,
        gbytes=4e-9 * words * 2 * slots,
        kind="bw",
    )
    # Match: kernel hamming_argmin, a popcount a word of the (B-1) pairs'
    # K x K (query, train) pairs; the descriptors and valid flags read once,
    # the best index and distance written once (module docstring).
    pairs = max(batch - 1, 0)
    stages["match"] = dict(
        gflops=1e-9 * pairs * kk * kk * desc_words,
        gbytes=1e-9 * (batch * kk * (4 * desc_words + 1) + pairs * kk * 8),
        kind="int",
    )
    return stages


def report(stage_ms: dict, model: dict, peaks: dict) -> dict:
    """Combine measured per-stage times with the static model.

    Returns {stage: {ms, mfu, bandwidth_frac, kind}}; mfu = achieved
    GFLOP/s / peak, bandwidth_frac = min-traffic GB/s / peak.
    """
    out = {}
    for name, ms in stage_ms.items():
        m = model.get(name)
        if m is None or ms <= 0:
            continue
        s = ms / 1e3
        gfs = m["gflops"] / s
        gbs = m["gbytes"] / s
        peak = peaks["peak_gflops_bf16"] if m["kind"] == "mxu_bf16" else peaks["peak_gflops"]
        out[name] = dict(
            ms=round(ms, 2),
            kind=m["kind"],
            mfu=round(gfs / peak, 4),
            bandwidth_frac=round(gbs / peaks["peak_gbs"], 4),
        )
    return out

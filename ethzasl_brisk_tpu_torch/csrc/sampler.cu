// BRISK box-smoothed intensity samples on Hopper (kernel K2).
//
// Replaces the Pallas TPU kernel ethzasl_brisk_tpu/describe/pallas_sampler.py
// (_kernel / _bucket_branch, reached through smoothed_intensity_patch_pallas)
// together with the XLA code around it (fast_sampler._tap_geometry and
// _values_from_taps). One thread per (keypoint, pattern point):
//   * it computes the tap geometry (fast_sampler.py:51-101);
//   * it reads its integral-image taps from the row-stacked int32 integral,
//     rows shifted by the keypoint's row_base and every coordinate clipped
//     to the frame-local integral bounds [0, frame_rows] x [0, cols]
//     (extractor.py:215-223);
//   * it weights them into the int32 value x1024 (fast_sampler.py:211-287):
//     corner pixels are second differences of the integral, the box branch
//     and the small-sigma bilinear branch both exist.
// The value equals the reference's SmoothedIntensity wherever every tap
// lies inside the frame, which holds for every describable keypoint.
//
// The geometry and the value of a point are device functions in
// sampler.cuh, which the describe kernel (describe.cu) compiles too for the
// rotated samples.
//
// The TPU-only machinery (window DMA, bucket and lane alignment, the bf16-
// limb one-hot contraction, 16-bit row packing) has no counterpart: a GPU
// thread reads the taps it needs directly.
//
// Design. Threads run in (keypoint, point) order, so a warp's lanes hold
// neighbouring points of one keypoint and no lane idles at P = 66. The box
// branch reads 22 distinct taps, named by the pairs of neighbouring columns
// they come in: (x_left, x_left+1) and (x_right, x_right+1) on rows y_top,
// y_top+1 and y_bottom; (d_x, d_x+1) and (c_x, c_x+1) on rows cd_y and
// cd_y+1; two single taps on row y_bottom+1 (the small-sigma branch, 3 x 3
// from (y_i, x_i)). Each tap is one 4-byte load by a 32-bit offset from its
// frame's first row, with no load for the grid cells the branch does not
// read. Clamping each coordinate keeps keypoints whose pattern leaves the
// frame exact: (clamp(c), clamp(c+1)) is a pair or one column twice.
//
// Arithmetic: float chains are compiled with --fmad=false so each product
// and sum rounds on its own, as in the plain torch version and XLA's
// separate ops. Weighted integer sums use uint32 so that wrap-around is
// defined (it matches torch's int32 wrap; it never happens for keypoints
// inside the frame), and the final division floors like Python's //.
//
// The v1 engine's rounding (brisk-v1.cc:246, :331, :366; the JAX samplers'
// v1_rounding, pallas_sampler.py:466-470) is the template flag V1: each
// division adds half its divisor first, +512 before the bilinear branch's
// /1024 and +max(scaling2, 1)/2 before the box branch's /scaling2, in
// uint32 like the sums. It costs one add (and a shift) a point.
//
// Bound: bytes, the integral sectors the taps touch, the keypoint and
// pattern inputs and the output. What holds the kernel back is the L1
// traffic of scattered 4-byte taps: the 32 lanes of a load touch different
// rows. Staging each keypoint's footprint in shared memory, and 8- or
// 16-byte loads of the column pairs, measured slower on an H100 (PERF.md
// §6), as did more resident blocks per SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "sampler.cuh"

namespace {

constexpr int kThreads = 128;

template <bool V1>
__global__ void __launch_bounds__(kThreads) k2_sampler_kernel(
    const int32_t* __restrict__ integral, int cols, int frame_rows,
    const float* __restrict__ key_x, const float* __restrict__ key_y,
    const float* __restrict__ pat_x, const float* __restrict__ pat_y,
    const float* __restrict__ pat_sigma, const int32_t* __restrict__ pat_scaling,
    const int32_t* __restrict__ pat_scaling2, const int32_t* __restrict__ row_base,
    int32_t* __restrict__ out, int n, int P) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const int k = t / P;
  const int stride = cols + 1;
  const Geom g = geometry(key_x[k], key_y[k], pat_x[t], pat_y[t], pat_sigma[t]);
  out[t] = point_value<V1>(integral + (size_t)row_base[k] * stride, stride, g, frame_rows, cols,
                       pat_scaling[t], pat_scaling2[t]);
}

template <bool V1>
void launch_k2(const void* integral, int cols, int frame_rows, const void* key_x,
               const void* key_y, const void* pat_x, const void* pat_y, const void* pat_sigma,
               const void* pat_scaling, const void* pat_scaling2, const void* row_base,
               void* out, int n, int P, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  k2_sampler_kernel<V1><<<blocks, kThreads, 0, stream>>>(
      (const int32_t*)integral, cols, frame_rows, (const float*)key_x,
      (const float*)key_y, (const float*)pat_x, (const float*)pat_y,
      (const float*)pat_sigma, (const int32_t*)pat_scaling,
      (const int32_t*)pat_scaling2, (const int32_t*)row_base, (int32_t*)out, n, P);
}

}  // namespace

// K2 on K keypoints of P points: out (K, P) int32. K * P, and the
// (frame_rows + 1) * (cols + 1) ints of one frame, stay under 2^31.
// v1_rounding != 0 launches the v1 engine's rounding.
extern "C" int brisk_smoothed_intensity(
    const void* integral, int cols, int frame_rows, const void* key_x,
    const void* key_y, const void* pat_x, const void* pat_y, const void* pat_sigma,
    const void* pat_scaling, const void* pat_scaling2, const void* row_base, void* out,
    int K, int P, int v1_rounding, void* stream) {
  const long long n = (long long)K * P;
  if (n > INT32_MAX || (long long)(frame_rows + 1) * (cols + 1) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (v1_rounding)
    launch_k2<true>(integral, cols, frame_rows, key_x, key_y, pat_x, pat_y, pat_sigma,
                    pat_scaling, pat_scaling2, row_base, out, (int)n, P, (cudaStream_t)stream);
  else
    launch_k2<false>(integral, cols, frame_rows, key_x, key_y, pat_x, pat_y, pat_sigma,
                     pat_scaling, pat_scaling2, row_base, out, (int)n, P, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// BRISK box-smoothed intensity samples on Hopper (kernel K2).
//
// Replaces the Pallas TPU kernel ethzasl_brisk_tpu/describe/pallas_sampler.py
// (_kernel / _bucket_branch, reached through smoothed_intensity_patch_pallas)
// together with the XLA code around it (fast_sampler._tap_geometry and
// _values_from_taps). One thread per (keypoint, pattern point):
//   * it computes the tap geometry (fast_sampler.py:51-101);
//   * it reads its 6x6 grid of integral-image taps straight from the
//     stacked int32 integral, rows shifted by the keypoint's row_base and
//     every coordinate clipped to the frame-local integral bounds
//     [0, frame_rows] x [0, cols] (extractor.py:215-223);
//   * it weights them into the int32 value x1024 (fast_sampler.py:211-287):
//     corner pixels are second differences of the integral, the box branch
//     and the small-sigma bilinear branch both exist.
// The value equals the reference's SmoothedIntensity wherever every tap
// lies inside the frame, which holds for every describable keypoint.
//
// The TPU-only machinery (window DMA, bucket and lane alignment, the bf16-
// limb one-hot contraction, 16-bit row packing) has no counterpart: a GPU
// thread reads the taps it needs directly.
//
// Arithmetic: float chains are compiled with --fmad=false so each product
// and sum rounds on its own, as in the plain torch version and XLA's
// separate ops. Weighted integer sums use uint32 so that wrap-around is
// defined (it matches torch's int32 wrap; it never happens for keypoints
// inside the frame), and the final division floors like Python's //.
//
// Bound: random 4-byte reads from L2 (36 taps per thread, ~14 distinct
// cache lines per pattern point). The stacked integral of a 128-frame
// batch is 158 MB, more than the 50 MB L2, so taps miss to HBM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int trunc_i32(float v) { return (int)truncf(v); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(128) smoothed_intensity_kernel(
    const int32_t* __restrict__ integral, int cols, int frame_rows,
    const float* __restrict__ key_x, const float* __restrict__ key_y,
    const float* __restrict__ pat_x, const float* __restrict__ pat_y,
    const float* __restrict__ pat_sigma, const int32_t* __restrict__ pat_scaling,
    const int32_t* __restrict__ pat_scaling2, const int32_t* __restrict__ row_base,
    int32_t* __restrict__ out, int K, int P) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)K * P) return;
  const int k = (int)(t / P);

  // ---- Tap geometry (fast_sampler._tap_geometry).
  const float xf = pat_x[t] + key_x[k];
  const float yf = pat_y[t] + key_y[k];
  const float sigma_half = pat_sigma[t];
  const bool small = sigma_half < 0.5f;
  const float x_1 = xf - sigma_half;
  const float x1 = xf + sigma_half;
  const float y_1 = yf - sigma_half;
  const float y1 = yf + sigma_half;
  const int x_left = trunc_i32(x_1 + 0.5f);
  const int y_top = trunc_i32(y_1 + 0.5f);
  const int x_right = trunc_i32(x1 + 0.5f);
  const int y_bottom = trunc_i32(y1 + 0.5f);
  const int x_i = trunc_i32(xf);
  const int y_i = trunc_i32(yf);
  const bool big = (x_right - x_left - 1) + (y_bottom - y_top - 1) > 2;
  const int cd_y = big ? y_bottom - 1 : y_bottom;
  const int c_x = big ? x_right + 1 : x_right;
  const int d_x = big ? x_left + 1 : x_left;

  int rows6[6], cols6[6];
  if (small) {
    const int r[6] = {y_i, y_i + 1, y_i + 2, y_i, y_i, y_i};
    const int c[6] = {x_i, x_i + 1, x_i + 2, x_i, x_i, x_i};
    for (int i = 0; i < 6; ++i) { rows6[i] = r[i]; cols6[i] = c[i]; }
  } else {
    const int r[6] = {y_top, y_top + 1, cd_y, cd_y + 1, y_bottom, y_bottom + 1};
    const int c[6] = {x_left, x_left + 1, d_x + 1, x_right, x_right + 1, c_x + 1};
    for (int i = 0; i < 6; ++i) { rows6[i] = r[i]; cols6[i] = c[i]; }
  }
  const int stride = cols + 1;
  const int32_t* frame = integral + (size_t)row_base[k] * stride;
  for (int i = 0; i < 6; ++i) {
    rows6[i] = clampi(rows6[i], 0, frame_rows) * stride;
    cols6[i] = clampi(cols6[i], 0, cols);
  }
#define T(i, j) ((uint32_t)frame[rows6[i] + cols6[j]])

  int value;
  if (small) {
    // ---- Small-sigma bilinear (brisk-descriptor-extractor.cc:391-408).
    const uint32_t s00 = T(1, 1) - T(0, 1) - T(1, 0) + T(0, 0);
    const uint32_t s01 = T(1, 2) - T(0, 2) - T(1, 1) + T(0, 1);
    const uint32_t s10 = T(2, 1) - T(1, 1) - T(2, 0) + T(1, 0);
    const uint32_t s11 = T(2, 2) - T(1, 2) - T(2, 1) + T(1, 1);
    const uint32_t r_x = (uint32_t)trunc_i32((xf - (float)x_i) * 1024.0f);
    const uint32_t r_y = (uint32_t)trunc_i32((yf - (float)y_i) * 1024.0f);
    const uint32_t sum = (1024u - r_x) * (1024u - r_y) * s00 + r_x * (1024u - r_y) * s01 +
                         r_x * r_y * s11 + (1024u - r_x) * r_y * s10;
    value = floordiv((int)sum, 1024);
  } else {
    // ---- Box branch (:410-495), corner pixels from integral differences.
    const uint32_t img_a = T(1, 1) - T(0, 1) - T(1, 0) + T(0, 0);
    const uint32_t img_b = T(1, 4) - T(0, 4) - T(1, 3) + T(0, 3);
    const uint32_t c_col0 = big ? T(3, 4) : T(3, 3);
    const uint32_t c_col0_top = big ? T(2, 4) : T(2, 3);
    const uint32_t img_c = T(3, 5) - T(2, 5) - c_col0 + c_col0_top;
    const uint32_t d_col0 = big ? T(3, 1) : T(3, 0);
    const uint32_t d_col0_top = big ? T(2, 1) : T(2, 0);
    const uint32_t img_d = T(3, 2) - T(2, 2) - d_col0 + d_col0_top;

    const float r_x_1f = (float)x_left - x_1 + 0.5f;
    const float r_y_1f = (float)y_top - y_1 + 0.5f;
    const float r_x1f = x1 - (float)x_right + 0.5f;
    const float r_y1f = y1 - (float)y_bottom + 0.5f;
    const int scaling = pat_scaling[t];
    const float scf = (float)scaling;
    const uint32_t w_a = (uint32_t)trunc_i32(r_x_1f * r_y_1f * scf);
    const uint32_t w_b = (uint32_t)trunc_i32(r_x1f * r_y_1f * scf);
    const uint32_t w_c = (uint32_t)trunc_i32(r_x1f * r_y1f * scf);
    const uint32_t w_d = (uint32_t)trunc_i32(r_x_1f * r_y1f * scf);
    const uint32_t r_x_1_i = (uint32_t)trunc_i32(r_x_1f * scf);
    const uint32_t r_y_1_i = (uint32_t)trunc_i32(r_y_1f * scf);
    const uint32_t r_x1_i = (uint32_t)trunc_i32(r_x1f * scf);
    const uint32_t r_y1_i = (uint32_t)trunc_i32(r_y1f * scf);

    const uint32_t corners = w_a * img_a + w_b * img_b + w_c * img_c + w_d * img_d;
    const uint32_t t1 = T(0, 1), t2 = T(0, 3), t3 = T(1, 3), t4 = T(1, 4);
    const uint32_t t5 = T(4, 4), t6 = T(4, 3), t7 = T(5, 3), t8 = T(5, 1);
    const uint32_t t9 = T(4, 1), t10 = T(4, 0), t11 = T(1, 0), t12 = T(1, 1);
    const uint32_t upper = (t3 - t2 + t1 - t12) * r_y_1_i;
    const uint32_t middle = (t6 - t3 + t12 - t9) * (uint32_t)scaling;
    const uint32_t left = (t9 - t12 + t11 - t10) * r_x_1_i;
    const uint32_t right = (t5 - t4 + t3 - t6) * r_x1_i;
    const uint32_t bottom = (t7 - t6 + t9 - t8) * r_y1_i;
    const uint32_t total = corners + upper + middle + left + right + bottom;
    const int scaling2 = max(pat_scaling2[t], 1);
    value = floordiv((int)total, scaling2);
  }
#undef T
  out[t] = value;
}

}  // namespace

extern "C" int brisk_smoothed_intensity(
    const void* integral, int cols, int frame_rows, const void* key_x,
    const void* key_y, const void* pat_x, const void* pat_y, const void* pat_sigma,
    const void* pat_scaling, const void* pat_scaling2, const void* row_base, void* out,
    int K, int P, void* stream) {
  const int threads = 128;
  const long long n = (long long)K * P;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  smoothed_intensity_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)integral, cols, frame_rows, (const float*)key_x,
      (const float*)key_y, (const float*)pat_x, (const float*)pat_y,
      (const float*)pat_sigma, (const int32_t*)pat_scaling,
      (const int32_t*)pat_scaling2, (const int32_t*)row_base, (int32_t*)out, K, P);
  return (int)cudaGetLastError();
}

// BRISK's describe after the unrotated samples, in one launch
// (describe_rotated).
//
// Replaces no TPU kernel by itself: it is the rest of the JAX package's
// describe (ethzasl_brisk_tpu/describe/extractor.py, _describe_core
// :1039-1079 and _pack_descriptor), which XLA runs around the Pallas
// sampler's second call (describe/pallas_sampler.py), and it takes that
// second call in. Kernel K2 (sampler.cu) still samples the unrotated
// pattern (phase 1); from its (K, P) values, for each keypoint, this kernel
//   * sums the long-pair gradient d0, d1 (extractor.py:1041-1046): int32
//     products that wrap, C's truncating division by 1024, int32 sums that
//     wrap (an order-free sum mod 2^32, so any order is bitwise);
//   * takes the angle and the rotation bin theta through brisk_orientation's
//     chain (angle.cuh: glibc's atan2f, * 57.2957764f, fma(angle, 2.84444451f,
//     0.5f), wrapped into [0, n_rot)), the given angle kept where it is not
//     -1;
//   * samples the pattern rotated by theta, lut_x/lut_y[scale, theta], with
//     K2's own geometry and point_value<V1> (sampler.cuh);
//   * packs the short-pair comparisons LSB first, pair 32w + j to bit j of
//     word w, pairs past n_bits 0, every word 0 where the keypoint is not
//     valid.
// Without vals0 (rotation_invariant=False) the gradient and the chain are
// skipped: theta 0 and the given angle. Every slot is computed, describable
// or not, as the plain chain computes it (describe/rotated.py,
// describe_rotated_plain). A theta outside [0, n_rot), which only a given
// angle outside about [-360, 720) degrees gives and on which the plain
// chain's LUT lookup raises, is clamped into the table here.
//
// Design. A warp a keypoint, kWarps warps a CTA, a persistent grid that
// strides over the keypoints, so each CTA stages the pattern's tables in
// shared memory once: the long pairs' indices as int16 and their int32
// weights, the short pairs' indices as int16. Each warp stages its
// keypoint's P phase-1 values in shared memory, its lanes take a long pair
// each in turn, the two sums are reduced with __shfl_xor_sync (every lane
// ends with both and runs the chain on them, so nothing is broadcast); the
// P rotated values then go into the same buffer, a point a lane in turn,
// and a word of the descriptor is one __ballot_sync. The shared memory is
// sized from the pattern's P, L and short-pair count, so a .ptn pattern
// works too; above 48 KB the launch opts in, and a pattern that does not
// fit in 227 KB is refused.
//
// Bound: bytes (the phase-1 values, the distinct 32-byte sectors of the
// integral the rotated taps touch, the keypoints' inputs, the LUT rows,
// the outputs). Built with --fmad=false like the others; the chain's one
// FMA is the explicit __fmaf_rn.

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

// Dynamic shared memory of a CTA: the long pairs' weights and each warp's
// values (int32), then the long and short pairs' indices (int16).
size_t smem_bytes(int P, int L, int n_bits) {
  return sizeof(int32_t) * (2 * (size_t)L + (size_t)kWarps * P) +
         sizeof(int16_t) * (2 * (size_t)L + 2 * (size_t)n_bits);
}

template <bool V1>
__global__ void __launch_bounds__(kThreads) describe_rotated_kernel(
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

// CTAs that fill the card once: the persistent grid's cap.
int resident_blocks() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return (sms[dev] > 0 ? sms[dev] : 1) * (2048 / kThreads);
}

}  // namespace

// describe_rotated on K keypoints of a P-point pattern: angle (K,) float32
// and desc (K, W) int32. vals0 (K, P) int32 or null (rotation_invariant
// off); scale_idx int64, valid bool; the LUTs (S, n_rot, P) and (S, P);
// the long pairs' indices int64 and weights int32 (L), the short pairs'
// indices int64 (n_bits). n_rot must be 1024 (the chain's folded
// constants); P, L and n_bits must fit int16 indices and the shared memory.
extern "C" int brisk_describe_rotated(
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
  auto kernel = v1_rounding ? describe_rotated_kernel<true> : describe_rotated_kernel<false>;
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

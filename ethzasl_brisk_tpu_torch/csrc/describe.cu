// BRISK's uint8 describe in one launch (describe_rotated).
//
// Replaces the JAX package's _describe_core on the Pallas route
// (ethzasl_brisk_tpu/describe/extractor.py:890-1081): both calls of the
// Pallas sampler smoothed_intensity_patch_pallas (pallas_call at
// describe/pallas_sampler.py:443) and the XLA code around them. From the
// row-stacked int32 integral and the keypoints, for each keypoint it
//   * samples the unrotated pattern, lut_x/lut_y[scale, 0] (phase 1), with
//     kernel K2's own geometry and point_value<V1> (sampler.cuh);
//   * sums the long-pair gradient d0, d1 (extractor.py:1041-1046): int32
//     products that wrap, C's truncating division by 1024, int32 sums that
//     wrap (an order-free sum mod 2^32, so any split is bitwise);
//   * takes the angle and the rotation bin theta through brisk_orientation's
//     chain (angle.cuh: glibc's atan2f, * 57.2957764f, fma(angle, 2.84444451f,
//     0.5f), wrapped into [0, n_rot)), the given angle kept where it is not
//     -1;
//   * samples the pattern rotated by theta, lut_x/lut_y[scale, theta];
//   * packs the short-pair comparisons LSB first, pair 32w + j to bit j of
//     word w, pairs past n_bits 0, every word 0 where the keypoint is not
//     valid (_pack_descriptor).
// A keypoint whose given angle is not -1 needs no phase 1 and skips it.
// Without rotation invariance (rotate == 0) phase 1, the gradient and the
// chain are skipped: theta 0 and the given angle. Every slot is computed,
// describable or not, as the plain chain computes it (describe/rotated.py,
// describe_rotated_plain). A theta outside [0, n_rot), which only a given
// angle outside about [-360, 720) degrees gives and on which the plain
// chain's LUT lookup raises, is clamped into the table here.
//
// Design. A persistent grid of CTAs of kWarps warps, at least kMinBlocks
// of them an SM (the registers capped to fit); a CTA takes a tile of T
// keypoints at a time (T = kWarps, or at small K 2 or 1, so that every
// resident CTA has work and each keypoint's serial path is shared by more
// lanes). Its threads walk a tile's T x P (keypoint, point) items in that
// order for both samplings, as K2 does, so no lane idles at P = 66; the
// values stay in shared memory. The tiles are software-pipelined, two
// passes a tile with a barrier after each: (A) tile i's rotated samples
// together with tile i + 1's unrotated ones (528 items for 128 threads at
// T = 4, P = 66), (B) tile i's words together with tile i + 1's gradient
// and chain, so every pass has both samplings' loads or both reductions in
// flight. A keypoint's gradient is split over the kWarps / T warps the
// tile gives it (shuffles, then partial sums in shared memory), and the
// last of them to arrive runs the chain on one lane. A word is a thread's
// 32 comparisons at T = kWarps and a warp's __ballot_sync below (built
// with -DDESCRIBE_WORDS_BALLOT, a ballot at every T: a yardstick, not the
// port's path). The pattern's pair tables come packed once a pattern and
// device (describe/rotated.py, pack_tables): (wdx, wdy) a long pair, then
// the long and the short pairs as i | j << 16. Each CTA stages them once,
// by one bulk asynchronous copy into shared memory that completes on an
// mbarrier, while it samples its first tile's phase 1. Tile i + 2's
// keypoint inputs are staged in shared memory during tile i's pass B
// (three buffers).
//
// Bound: the larger of bytes (the distinct 32-byte sectors of the integral
// both samplings touch, the keypoints' inputs, the packed tables, the LUT
// rows, the outputs) and int32 operations (both samplings, the gradient,
// the comparisons), operations at the main step's shapes. What holds it
// back is K2's: the L1 traffic of scattered 4-byte taps, so two K2
// samplings are its floor. Built with --fmad=false like the others; the
// chain's one FMA is the explicit __fmaf_rn.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#include "angle.cuh"
#include "launch.cuh"
#include "sampler.cuh"

namespace {

constexpr int kWarps = 4;  // warps a CTA, and keypoints a tile at most
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;   // what a block can opt in to on Hopper
constexpr int kStaticSmem = 1024;  // kept for the kernel's static shared arrays
constexpr int kMinBlocks = 8;      // CTAs an SM the registers must allow (64 a thread)

// Ints of the packed pair tables, padded to the bulk copy's 16 bytes.
__host__ __device__ __forceinline__ int table_ints(int L, int n_bits) {
  return (3 * L + n_bits + 3) & ~3;
}

// Dynamic shared memory of a CTA with a tile of T keypoints: the packed
// tables, then two tiles' T x P values (one tile's rotated, the next one's
// unrotated).
size_t dynamic_smem(int T, int P, int L, int n_bits) {
  return sizeof(int32_t) * ((size_t)table_ints(L, n_bits) + 2 * (size_t)T * P);
}

// A tile's keypoint inputs; scale -1 past K.
struct KeyTile {
  float x[kWarps], y[kWarps], given[kWarps];
  int row_base[kWarps], scale[kWarps], valid[kWarps];
};

__device__ __forceinline__ void stage_keys(KeyTile& t, int kl, int k, int K,
                                           const int64_t* __restrict__ scale_idx,
                                           const uint8_t* __restrict__ valid,
                                           const float* __restrict__ given,
                                           const float* __restrict__ key_x,
                                           const float* __restrict__ key_y,
                                           const int32_t* __restrict__ row_base) {
  if (k < K) {
    t.x[kl] = key_x[k];
    t.y[kl] = key_y[k];
    t.given[kl] = given[k];
    t.row_base[kl] = row_base[k];
    t.scale[kl] = static_cast<int>(scale_idx[k]);
    t.valid[kl] = valid[k];
  } else {
    t.scale[kl] = -1;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits until the mbarrier at `bar` completes its phase of parity `parity`.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

template <bool V1>
__global__ void __launch_bounds__(kThreads, kMinBlocks) describe_rotated_kernel(
    const int32_t* __restrict__ integral, int cols, int frame_rows, int rotate,
    const int64_t* __restrict__ scale_idx, const uint8_t* __restrict__ valid,
    const float* __restrict__ given, const float* __restrict__ key_x,
    const float* __restrict__ key_y, const int32_t* __restrict__ row_base,
    const float* __restrict__ lut_x, const float* __restrict__ lut_y,
    const float* __restrict__ lut_sigma, const int32_t* __restrict__ lut_scaling,
    const int32_t* __restrict__ lut_scaling2, const int32_t* __restrict__ tables, int L,
    int n_bits, float* __restrict__ angle_out, int32_t* __restrict__ desc, int K, int P,
    int n_rot, int W, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ KeyTile s_keys[3];
  __shared__ uint32_t s_part[kWarps][2];
  __shared__ int s_count[kWarps];
  __shared__ int s_theta[kWarps];
  __shared__ __align__(8) uint64_t s_bar;
  int32_t* s_tab = reinterpret_cast<int32_t*>(smem);
  const int2* s_w = reinterpret_cast<const int2*>(s_tab);  // (wdx, wdy) a long pair
  const uint32_t* s_long = reinterpret_cast<const uint32_t*>(s_tab + 2 * L);
  const uint32_t* s_short = s_long + L;
  int32_t* s_rot = s_tab + table_ints(L, n_bits);  // tile i's rotated values
  int32_t* s_un = s_rot + T * P;                   // tile i + 1's unrotated values

  // The tables: one bulk copy, completing on s_bar, waited for after the
  // first tile's phase 1.
  const uint32_t bar = smem_addr(&s_bar);
  if (threadIdx.x == 0) {
    const int bytes = 4 * table_ints(L, n_bits);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (bytes > 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(s_tab)), "l"(tables), "r"(bytes), "r"(bar) : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = cols + 1;
  const int items = T * P;
  const int slices = kWarps / T;  // warps a keypoint's gradient is split over
  const int step = gridDim.x * T;
  const int first = blockIdx.x * T;
  auto stage = [=](KeyTile& t, int base) {
    if (threadIdx.x < T)
      stage_keys(t, threadIdx.x, base + threadIdx.x, K, scale_idx, valid, given, key_x, key_y,
                 row_base);
  };
  if (threadIdx.x < kWarps) s_count[threadIdx.x] = 0;
  stage(s_keys[0], first);
  __syncthreads();

  // The value x1024 of point p of tile keypoint kl in rotation bin th.
  auto sample = [=](const KeyTile& kt, int kl, int p, int th) {
    const int s = kt.scale[kl];
    const size_t sp = (size_t)s * P + p;
    const size_t lp = ((size_t)s * n_rot + th) * P + p;
    const Geom geo = geometry(kt.x[kl], kt.y[kl], __ldg(lut_x + lp), __ldg(lut_y + lp),
                              __ldg(lut_sigma + sp));
    return point_value<V1>(integral + (size_t)kt.row_base[kl] * stride, stride, geo, frame_rows,
                           cols, __ldg(lut_scaling + sp), __ldg(lut_scaling2 + sp));
  };
  // Phase 1 of item `it` of a tile, where the keypoint's angle is computed.
  auto unrotated = [=](const KeyTile& kt, int it) {
    const int kl = it / P;
    if (rotate && kt.scale[kl] >= 0 && kt.given[kl] == -1.0f)
      s_un[it] = sample(kt, kl, it - kl * P, 0);
  };
  // The gradient of a tile's keypoint over `slices` warps, lanes a pair each
  // in turn, then the chain on lane 0 of the keypoint's last warp to arrive.
  auto orient_one = [=](const KeyTile& kt, int base, int kl, int slice) {
    if (kt.scale[kl] < 0) return;  // warp-uniform, and the same for all its warps
    const float g = kt.given[kl];
    uint32_t s0 = 0, s1 = 0;
    if (rotate && g == -1.0f) {
      const int32_t* v = s_un + kl * P;
      for (int l = slice * 32 + lane; l < L; l += 32 * slices) {
        const uint32_t ij = s_long[l];
        const int2 w = s_w[l];
        const uint32_t dt = (uint32_t)v[ij & 0xffffu] - (uint32_t)v[ij >> 16];
        s0 += (uint32_t)((int32_t)(dt * (uint32_t)w.x) / 1024);
        s1 += (uint32_t)((int32_t)(dt * (uint32_t)w.y) / 1024);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s0 += __shfl_xor_sync(kFull, s0, o);
        s1 += __shfl_xor_sync(kFull, s1, o);
      }
    }
    if (lane != 0) return;
    if (slices > 1) {
      volatile uint32_t* part = &s_part[0][0];
      part[2 * warp] = s0;
      part[2 * warp + 1] = s1;
      __threadfence_block();
      if (atomicAdd(&s_count[kl], 1) != slices - 1) return;
      __threadfence_block();
      s0 = s1 = 0;
      for (int i = kl * slices; i < (kl + 1) * slices; ++i) {
        s0 += part[2 * i];
        s1 += part[2 * i + 1];
      }
      s_count[kl] = 0;
    }
    float a = g;
    int64_t theta = 0;
    if (rotate) {
      if (g == -1.0f) a = orientation_angle((int32_t)s0, (int32_t)s1, false);
      theta = rotation_bin(a, n_rot, false);
    }
    s_theta[kl] = (int)(theta < 0 ? 0 : (theta >= n_rot ? n_rot - 1 : theta));
    angle_out[base + kl] = a;
  };
  auto orient = [=](const KeyTile& kt, int base) {
    const int kl = warp / slices;
    orient_one(kt, base, kl, warp - kl * slices);
  };
  // The words of a tile from its rotated values: a thread a word at the
  // full tile (as fast as a ballot there, or faster, and one coalesced
  // store a word), else a __ballot_sync of a warp a word, which shortens a
  // small tile's path.
  auto pack = [=](const KeyTile& kt, int base) {
#ifndef DESCRIBE_WORDS_BALLOT
    if (T == kWarps) {
      for (int idx = threadIdx.x; idx < T * W; idx += kThreads) {
        const int kl = idx / W, w = idx - kl * W;
        if (kt.scale[kl] < 0) break;
        const int32_t* v = s_rot + kl * P;
        const int end = n_bits - 32 * w < 32 ? n_bits - 32 * w : 32;
        uint32_t word = 0;
        for (int j = 0; j < end; ++j) {
          const uint32_t ij = s_short[32 * w + j];
          word |= (uint32_t)(v[ij & 0xffffu] > v[ij >> 16]) << j;
        }
        desc[(size_t)(base + kl) * W + w] = kt.valid[kl] ? (int32_t)word : 0;
      }
      return;
    }
#endif
    for (int idx = warp; idx < T * W; idx += kWarps) {
      const int kl = idx / W, w = idx - kl * W;
      if (kt.scale[kl] < 0) break;  // warp-uniform: every later word is past K too
      const int b = 32 * w + lane;
      bool bit = false;
      if (b < n_bits) {
        const uint32_t ij = s_short[b];
        const int32_t* v = s_rot + kl * P;
        bit = v[ij & 0xffffu] > v[ij >> 16];
      }
      const uint32_t word = __ballot_sync(kFull, bit);
      if (lane == 0) desc[(size_t)(base + kl) * W + w] = kt.valid[kl] ? (int32_t)word : 0;
    }
  };

  // Prologue: tile 0's phase 1, gradient and chain; tile 1's keys.
  for (int it = threadIdx.x; it < items; it += kThreads) unrotated(s_keys[0], it);
  stage(s_keys[1], first + step);
  wait_phase(bar, 0);
  __syncthreads();
  orient(s_keys[0], first);
  __syncthreads();
  // Tile i in two passes, software-pipelined with tile i + 1: (A) tile i's
  // rotated samples and tile i + 1's unrotated ones; (B) tile i's words,
  // tile i + 1's gradient and chain, tile i + 2's keys.
  for (int base = first, cur = 0; base < K; base += step, cur = cur == 2 ? 0 : cur + 1) {
    const int nxt = cur == 2 ? 0 : cur + 1;
    const KeyTile& kt = s_keys[cur];
    const KeyTile& kn = s_keys[nxt];
    for (int it = threadIdx.x; it < 2 * items; it += kThreads) {
      if (it < items) {
        const int kl = it / P;
        if (kt.scale[kl] >= 0) s_rot[it] = sample(kt, kl, it - kl * P, s_theta[kl]);
      } else {
        unrotated(kn, it - items);
      }
    }
    __syncthreads();
    pack(kt, base);
    orient(kn, base + step);
    stage(s_keys[nxt == 2 ? 0 : nxt + 1], base + 2 * step);
    __syncthreads();
  }
}

// CTAs of `kernel` with `smem` bytes of dynamic shared memory that fit on
// the current card at once: its occupancy times its SMs, cached per card,
// variant and size.
template <typename Kernel>
int resident_blocks(Kernel kernel, bool v1, size_t smem) {
  constexpr int kCards = 64;
  static std::mutex mu;
  static int sms[kCards] = {};
  static size_t last_smem[kCards][2] = {};
  static int last_blocks[kCards][2] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kCards) dev = 0;
  std::lock_guard<std::mutex> lock(mu);
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  if (last_smem[dev][v1] != smem || last_blocks[dev][v1] == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    cudaGetLastError();
    last_smem[dev][v1] = smem;
    last_blocks[dev][v1] = (sms[dev] > 0 ? sms[dev] : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return last_blocks[dev][v1];
}

}  // namespace

// describe_rotated on K keypoints of a P-point pattern: angle (K,) float32
// and desc (K, W) int32. rotate 0 skips phase 1, the gradient and the
// chain; scale_idx int64, valid bool, given (the given angle) float32;
// the LUTs (S, n_rot, P) and (S, P); tables the packed pair tables
// (describe/rotated.py, pack_tables) of L long and n_bits short pairs,
// 16-byte aligned. n_rot must be 1024 (the chain's folded constants); P
// must fit int16 indices, and the tables with a one-keypoint tile the
// shared memory.
extern "C" int brisk_describe_rotated(
    const void* integral, int cols, int frame_rows, int rotate, const void* scale_idx,
    const void* valid, const void* given, const void* key_x, const void* key_y,
    const void* row_base, const void* lut_x, const void* lut_y, const void* lut_sigma,
    const void* lut_scaling, const void* lut_scaling2, const void* tables, int L, int n_bits,
    void* angle, void* desc, int K, int P, int n_rot, int W, int v1_rounding, void* stream) {
  const auto fits = [&](int T) {
    return dynamic_smem(T, P, L, n_bits) + kStaticSmem <= (size_t)kMaxSmem;
  };
  if (n_rot != 1024 || P < 1 || P > 32767 || L < 0 || n_bits < 0 || W * 32 < n_bits ||
      !fits(1) || (reinterpret_cast<uintptr_t>(tables) & 15) != 0 ||
      (long long)(frame_rows + 1) * (cols + 1) > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  auto kernel = v1_rounding ? describe_rotated_kernel<true> : describe_rotated_kernel<false>;
  int T = kWarps;
  while (T > 1 && !fits(T)) T >>= 1;
  // Resident CTAs at the largest tile; a smaller tile fits as many or more.
  const int resident = resident_blocks(kernel, v1_rounding != 0, dynamic_smem(T, P, L, n_bits));
  while (T > 1 && (K + T - 1) / T < resident) T >>= 1;
  const int tiles = (K + T - 1) / T;
  const int grid = tiles < resident ? tiles : resident;
  return (int)launch(kernel, grid, kThreads, (int)dynamic_smem(T, P, L, n_bits),
                     (cudaStream_t)stream, (const int32_t*)integral, cols, frame_rows, rotate,
                     (const int64_t*)scale_idx, (const uint8_t*)valid, (const float*)given,
                     (const float*)key_x, (const float*)key_y, (const int32_t*)row_base,
                     (const float*)lut_x, (const float*)lut_y, (const float*)lut_sigma,
                     (const int32_t*)lut_scaling, (const int32_t*)lut_scaling2,
                     (const int32_t*)tables, L, n_bits, (float*)angle, (int32_t*)desc, K, P,
                     n_rot, W, T);
}

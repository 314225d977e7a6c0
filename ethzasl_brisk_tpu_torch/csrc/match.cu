// The batched step's adjacent-frame match on Hopper (kernel
// hamming_argmin): each frame's descriptors against the previous frame's,
// the nearest train slot by Hamming distance and that distance, every pair
// of a batch in one launch.
//
// No TPU kernel: it stands for XLA work of the JAX package,
// ethzasl_brisk_tpu/parallel/frames.py:194-208 (_match_adjacent, the AST
// step) and :256-265 (the Harris step's match_pair), which go through the
// +-1 bf16 matmul of match/matcher.py:31-47. For pair p (query frame p+1,
// train frame p) and query slot q:
//   d[t] = popcount(desc[p+1, q, :nw] XOR desc[p, t, :nw]), nw = n_bits / 32,
//   or the sentinel n_bits + 1 where train slot t is invalid;
//   best[p, q] = the first t of the minimum (ties to the lowest index,
//   jnp.argmin's rule), dist[p, q] = that minimum, or the sentinel where
//   query slot q is invalid. An invalid query still gets its real argmin
//   (JAX masks only the distance), and a train frame with no valid slot
//   gives best 0 and the sentinel.
// The words are the descriptors' uint32 bit patterns (int32 in torch), a
// row W words long; n_bits counts the first nw of them (the Harris step
// counts 384 bits whatever W, the AST step all W * 32).
//
// Bound: operations. (B-1) K^2 nw popcounts at 16 a clock an SM, against
// one read of the descriptors (B K W 4 bytes, 5.5 MB at the B=128 step).
//
// Design (simple and right first): a CTA of 128 threads takes one pair and
// 128 query slots, a thread a query, its nw words in registers. The CTA
// stages the train frame's rows in chunks of 256 in shared memory, with a
// penalty word a row (0, or 2^30 for an invalid slot, so an invalid slot
// never beats the sentinel that a thread starts from), and every thread
// walks the chunk's rows in ascending order with a strict <: every thread
// reads the same row, a shared-memory broadcast, and ties keep the lowest
// index. No (K, K) distance matrix exists. The grid is pair-major, so the
// CTAs that read one train frame run together and find it in L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 128;   // queries a CTA, one a thread
constexpr int kChunk = 256;     // train rows staged a round
constexpr int kMaxWords = 32;   // n_bits up to 1024
constexpr int kInvalid = 1 << 30;

// NW: the words compared, fixed at compile time (the main paths' 12 and
// 16), or 0 for the runtime count nw (up to kMaxWords, predicated).
template <int NW>
__global__ void __launch_bounds__(kThreads)
    hamming_argmin_kernel(const uint32_t* __restrict__ desc, const uint8_t* __restrict__ valid,
                          int32_t* __restrict__ best, int32_t* __restrict__ dist, int K,
                          int W, int nw_runtime, int sentinel, int tiles) {
  constexpr int R = NW ? NW : kMaxWords;
  const int nw = NW ? NW : nw_runtime;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* rows = smem;                                  // kChunk x nw words
  int* penalty = reinterpret_cast<int*>(smem + kChunk * nw);  // kChunk words

  const int p = blockIdx.x / tiles;
  const int q = (blockIdx.x - p * tiles) * kThreads + threadIdx.x;
  const uint32_t* train = desc + (size_t)p * K * W;
  const uint32_t* query = desc + (size_t)(p + 1) * K * W;
  const uint8_t* train_valid = valid + (size_t)p * K;
  const bool live = q < K;

  uint32_t qw[R];
#pragma unroll
  for (int w = 0; w < R; ++w) {
    qw[w] = (live && (NW || w < nw)) ? query[(size_t)q * W + w] : 0u;
  }
  int bd = sentinel, bi = 0;
  for (int t0 = 0; t0 < K; t0 += kChunk) {
    const int n = min(kChunk, K - t0);
    __syncthreads();  // the previous chunk's rows are read
    for (int e = threadIdx.x; e < n * nw; e += kThreads) {
      const int r = e / nw;
      rows[e] = train[(size_t)(t0 + r) * W + (e - r * nw)];
    }
    for (int r = threadIdx.x; r < n; r += kThreads) {
      penalty[r] = train_valid[t0 + r] ? 0 : kInvalid;
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < n; ++r) {
      const uint32_t* row = rows + r * nw;
      int d = penalty[r];
      if constexpr (NW > 0 && NW % 4 == 0) {
        const uint4* row4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
        for (int i = 0; i < NW / 4; ++i) {
          const uint4 v = row4[i];
          d += __popc(qw[4 * i] ^ v.x) + __popc(qw[4 * i + 1] ^ v.y) +
               __popc(qw[4 * i + 2] ^ v.z) + __popc(qw[4 * i + 3] ^ v.w);
        }
      } else {
#pragma unroll
        for (int w = 0; w < R; ++w) {
          if (NW || w < nw) d += __popc(qw[w] ^ row[w]);
        }
      }
      if (d < bd) {
        bd = d;
        bi = t0 + r;
      }
    }
  }
  if (live) {
    const size_t o = (size_t)p * K + q;
    best[o] = bi;
    dist[o] = valid[(size_t)(p + 1) * K + q] ? bd : sentinel;
  }
}

}  // namespace

// desc: (B, K, W) int32 words, valid: (B, K) bool, both contiguous on the
// current card; best, dist: (B-1, K) int32. n_bits a multiple of 32, at most
// min(W, kMaxWords) words. B >= 2 and K >= 1 (the wrapper launches nothing
// otherwise).
extern "C" int brisk_hamming_argmin(const void* desc, const void* valid, void* best, void* dist,
                                    int B, int K, int W, int n_bits, void* stream) {
  if (B < 2 || K < 1 || W < 1 || n_bits < 0 || n_bits % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nw = n_bits / 32;
  if (nw > W || nw > kMaxWords) return (int)cudaErrorInvalidValue;
  const long long tiles = (K + kThreads - 1) / kThreads;
  if (tiles * (B - 1) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles * (B - 1));
  const int smem = kChunk * (nw + 1) * 4;
  auto* d = static_cast<const uint32_t*>(desc);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* b = static_cast<int32_t*>(best);
  auto* o = static_cast<int32_t*>(dist);
  const auto s = static_cast<cudaStream_t>(stream);
  const int sentinel = n_bits + 1;
  cudaError_t err;
  if (nw == 12) {
    err = launch(hamming_argmin_kernel<12>, grid, kThreads, smem, s, d, v, b, o, K, W, nw,
                 sentinel, (int)tiles);
  } else if (nw == 16) {
    err = launch(hamming_argmin_kernel<16>, grid, kThreads, smem, s, d, v, b, o, K, W, nw,
                 sentinel, (int)tiles);
  } else {
    err = launch(hamming_argmin_kernel<0>, grid, kThreads, smem, s, d, v, b, o, K, W, nw,
                 sentinel, (int)tiles);
  }
  return (int)err;
}

// The in-kernel building blocks of the TPU Mosaic probes on Hopper
// (kernels T, X and S).
//
// T, transpose_chain, replaces tools/probes/probe_mosaic_gather3.py:86
// transpose_many: an int32 (m, 128) table in m / 128 square blocks, each
// taken through rounds (8 in the probe) of x = x.T; x = x + 1. Eight
// transposes return every element to its place, so the probe's result is
// t + 8 (int32 wrapping); an odd count gives x.T + rounds per block. The
// TPU holds the whole 128 x 128 block in VMEM and transposes it in the
// vector unit. A block's transpose is the transpose of each of its 16
// sub-tiles of 32 x 32 and the swap of sub-tile (I, J) with (J, I). Here a
// warp owns one sub-tile at a time, in its own 4 KB of shared memory, and
// each round moves every element of it to its transposed place there, so a
// round needs only __syncwarp; the swaps of all the rounds together are
// the identity for an even count and one swap for an odd one, taken when
// the tile is stored. The first round writes the tile's registers (16-byte
// loads) down the columns; a middle round reads down the columns and
// writes along the rows, 16 bytes a lane; the last reads down the columns
// and stores 16 bytes a lane to the output (with one round, it reads along
// the rows). A lane owns the 16-byte chunk lane % 8 of rows 4t + lane / 8
// (t < 8), and a row's chunks are swizzled by the row's quarter (chunk
// c of row R at c ^ (R / 4 % 8)), so a column read or write falls on 32
// distinct banks and a row's 16-byte chunks on all of them. The grid is
// persistent, four warps an SM (two or eight, padded tiles, pairs of tiles
// a warp and two or three units in flight all measured slower), each warp
// walking tiles with the card's whole warp count as its stride; it issues
// its next tile's loads right after the current tile's first round, so
// they overlap the remaining rounds, and its stores go out without
// waiting. Adds are unsigned, so overflow wraps as two's complement
// without undefined behaviour.
//
// X, gather_chain, replaces probe_mosaic_gather3.py:107 chain: per
// 128-row block, a = take_along_axis(t, i, 1); out = take_along_axis(a.T,
// i, 1), that is, with rows local to the block,
//   out[r, c] = t[i[r, c], i[i[r, c], r]].
// One thread per output: the index read is coalesced; the two dependent
// reads come from the block's 64 KB of i and of t, which stay in L2.
// Staging the block in shared memory is later work.
//
// S, window_colsum, replaces probe_mosaic_gather3.py:145 and
// probe_mosaic_gather4.py:87 dma_patches (one window per grid step, or
// eight): a DMA of a 96 x 128 int32 window at (ay[k], ax[k]) into VMEM and
// its column sums,
//   out[k, c] = sum_{r < 96} img[ay[k] + r, ax[k] + c].
// One block per window and one thread per column: each window row is one
// coalesced 512-byte read (offsets are not aligned, so element by element).
// Sums accumulate unsigned, wrapping as int32 does.
//
// Bound: bytes for all three. T reads and writes each element once (its
// 8 adds per element are a tenth of that time; its 8 shared-memory round
// trips, 56 KB a tile, come to ~3.5 us of the card's 33 TB/s of shared
// bandwidth at the probe's 8 MiB, under the 5.0 us of device memory, if
// they overlap it); X reads the index and
// writes the output once, plus the sectors of t it touches; S reads the
// sectors its windows cover and writes 128 sums per window (its 95 adds per
// sum are under half the byte time). Indices and offsets are trusted to be
// in range (the plain versions check them); element counts are below 2^31
// (the wrappers check), so index math is 32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 128;       // side of a transpose or gather block
constexpr int kSub = 32;        // side of a sub-tile of T
constexpr int kTWarps = 4;      // T: warps per block, one block an SM
constexpr int kThreads = 256;
constexpr int kWinRows = 96;
constexpr int kWinCols = 128;

// Word (R, col) of a 32 x 32 tile: the 16-byte chunk col / 4 of row R at
// chunk (col / 4) ^ (R / 4 % 8).
__device__ __forceinline__ int swizzled(int R, int col) {
  return R * kSub + ((((col >> 2) ^ ((R >> 2) & 7)) << 2) | (col & 3));
}

__global__ void __launch_bounds__(kTWarps * kSub) transpose_chain_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ out, int tiles, int rounds) {
  __shared__ __align__(16) uint32_t smem[kTWarps][kSub * kSub];
  uint32_t* const s = smem[threadIdx.x / kSub];
  const int lane = threadIdx.x % kSub;
  const int stride = gridDim.x * kTWarps;
  const int r = lane / 8, c4 = 4 * (lane % 8);  // rows 4t + r, columns c4 .. c4+3
  // Element offset of tile u's first element, or of its swapped place.
  auto at = [&](int u, bool swap) {
    const int ti = (u / 4) % 4, tj = u % 4;
    const int base = (u / 16) * kBlk * kBlk;
    return swap ? base + tj * kSub * kBlk + ti * kSub : base + ti * kSub * kBlk + tj * kSub;
  };
  uint4 v[8];  // a tile as loaded: chunk (4t + r, c4) in v[t]
  auto load = [&](int u) {
    const int g = at(u, false);
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = __ldg(src + (g + (4 * t + r) * kBlk + c4) / 4);
  };

  int u = blockIdx.x * kTWarps + threadIdx.x / kSub;
  if (u < tiles) load(u);
  for (; u < tiles; u += stride) {
    // Round 1: element (i, c4 + w) to (c4 + w, i), + 1.
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int i = 4 * t + r;
      s[swizzled(c4, i)] = v[t].x + 1u;
      s[swizzled(c4 + 1, i)] = v[t].y + 1u;
      s[swizzled(c4 + 2, i)] = v[t].z + 1u;
      s[swizzled(c4 + 3, i)] = v[t].w + 1u;
    }
    if (u + stride < tiles) load(u + stride);
    __syncwarp();
    for (int round = 2; round < rounds; ++round) {
      uint32_t a[32];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int w = 0; w < 4; ++w) a[4 * t + w] = s[swizzled(c4 + w, 4 * t + r)] + 1u;
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        *reinterpret_cast<uint4*>(s + swizzled(4 * t + r, c4)) =
            make_uint4(a[4 * t], a[4 * t + 1], a[4 * t + 2], a[4 * t + 3]);
      }
      __syncwarp();
    }
    const int g = at(u, rounds % 2 == 1);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int i = 4 * t + r;
      uint4 e;
      if (rounds >= 2) {  // the last round
        e = make_uint4(s[swizzled(c4, i)] + 1u, s[swizzled(c4 + 1, i)] + 1u,
                       s[swizzled(c4 + 2, i)] + 1u, s[swizzled(c4 + 3, i)] + 1u);
      } else {
        e = *reinterpret_cast<const uint4*>(s + swizzled(i, c4));
      }
      out[(g + i * kBlk + c4) / 4] = e;
    }
    __syncwarp();  // the tile is read before the next tile's first round
  }
}

__global__ void __launch_bounds__(kThreads) gather_chain_kernel(
    const int32_t* __restrict__ t, const int32_t* __restrict__ i, int32_t* __restrict__ out,
    unsigned n) {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const unsigned row = e / kBlk;
  const unsigned first = row - row % kBlk;  // the block's first row
  const unsigned k = (unsigned)i[e];
  const unsigned m = (unsigned)i[(first + k) * kBlk + row % kBlk];
  out[e] = t[(first + k) * kBlk + m];
}

__global__ void __launch_bounds__(kWinCols) window_colsum_kernel(
    const int32_t* __restrict__ img, const int32_t* __restrict__ ax,
    const int32_t* __restrict__ ay, int32_t* __restrict__ out, int width) {
  const int32_t* col = img + (size_t)ay[blockIdx.x] * width + ax[blockIdx.x] + threadIdx.x;
  uint32_t sum = 0;
#pragma unroll 8
  for (int r = 0; r < kWinRows; ++r) sum += (uint32_t)col[(size_t)r * width];
  out[blockIdx.x * kWinCols + threadIdx.x] = (int32_t)sum;
}

}  // namespace

// T. src and out are (nblk * 128, 128) int32, 16-byte aligned; rounds >= 1.
extern "C" int brisk_probe_transpose_chain(const void* src, void* out, int nblk, int rounds,
                                           void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)err;
  const int tiles = nblk * 16;
  const int wanted = (tiles + kTWarps - 1) / kTWarps;
  const int blocks = wanted < sms ? wanted : sms;
  transpose_chain_kernel<<<blocks, kTWarps * kSub, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)out, tiles, rounds);
  return (int)cudaGetLastError();
}

// X. t, i and out are (m, 128) int32 with m a multiple of 128; n = m * 128.
extern "C" int brisk_probe_gather_chain(const void* t, const void* i, void* out, int n,
                                        void* stream) {
  const unsigned blocks = ((unsigned)n + kThreads - 1) / kThreads;
  gather_chain_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)t, (const int32_t*)i, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// S. img (height, width) int32; ax, ay (K,) int32; out (K, 128) int32.
extern "C" int brisk_probe_window_colsum(const void* img, const void* ax, const void* ay,
                                         void* out, int width, int K, void* stream) {
  window_colsum_kernel<<<K, kWinCols, 0, (cudaStream_t)stream>>>(
      (const int32_t*)img, (const int32_t*)ax, (const int32_t*)ay, (int32_t*)out, width);
  return (int)cudaGetLastError();
}

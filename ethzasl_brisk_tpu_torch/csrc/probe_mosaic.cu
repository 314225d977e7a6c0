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
// i, 1), that is, with rows local to the block and k = i[r, c],
//   out[r, c] = t[k, i[k, r]].
// Each output needs two dependent reads at random places of the block's
// 64 KB of i and of t. Read from device memory, each costs a whole 32-byte
// sector of L2 traffic (2 x 2 M x 32 B = 134 MB at the probe's 128 blocks,
// against the 24 MB of its bound) and the three reads of an output wait on
// each other. The TPU holds the block in VMEM; here one CTA of 512 threads
// owns a block and first stages both halves of it in shared memory (129 KB,
// one CTA an SM; the probe's 128 blocks are one wave on 132 SMs), with all
// of its 16-byte loads in flight at once: t as it lies (a warp loads one
// 512-byte row, so its 16-byte stores fall on all 32 banks), and i
// transposed, iT[r][k] = i[k][r], in rows of 130 words. A warp loads i as 8
// rows x 4 chunks, so the transposing stores of one of a chunk's four words
// land on banks 2 (4q + j) + k, which are 32 distinct ones. The thread keeps
// its own 32 words of i in registers: they are the k of its 32 outputs,
// rows k of its chunks. Then it serves them from shared memory,
// m = iT[r][k], out = ts[k][m], and stores 16 bytes a chunk. L2->SM
// traffic falls to the bound's 24 MB; what is left is one stage, then one
// serve, on each SM, with nothing to overlap them (1024 or 256 threads a
// block, and t staged by cp.async, measured slower; PERF.md).
//
// S, window_colsum, replaces probe_mosaic_gather3.py:145 and
// probe_mosaic_gather4.py:87 dma_patches (one window per grid step, or
// eight): a DMA of a 96 x 128 int32 window at (ay[k], ax[k]) into VMEM and
// its column sums,
//   out[k, c] = sum_{r < 96} img[ay[k] + r, ax[k] + c].
// The windows overlap: at the probes' 512 windows in a 768-wide image each
// sector is read about 17 times, ~27 MB from L2 for 1.5 MB of image, so L2,
// not HBM, feeds it. A window has a CTA of 256 threads, 8 warps of 12 rows
// each, so the 512 windows are one wave with all their rows in flight
// together (a thread a column, walking all 96 rows, measured 1.5x slower).
// Lane l of a warp reads columns ax + l + 32 j of each of its rows, 48
// words a lane, any width and any alignment; each warp's partial sums go to
// shared memory and 128 threads add the 8 warps' sums into coalesced
// stores. Aligned 16-byte chunks shifted by ax % 4, and two windows a CTA,
// measured no faster (PERF.md): what bounds S now is the ~27 MB of sectors
// from L2, which only windows sharing their rows could cut.
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
// (the wrappers check), so index math is 32-bit. The wrappers own the
// alignment checks: T and X move 16 bytes only on the bases they were given
// aligned.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kBlk = 128;       // side of a transpose or gather block
constexpr int kSub = 32;        // side of a sub-tile of T
constexpr int kTWarps = 4;      // T: warps per block, one block an SM
constexpr int kWinRows = 96;
constexpr int kWinCols = 128;
constexpr int kChainThreads = 512;  // X: a block's threads
constexpr int kChainPitch = kBlk + 2;  // X: words of a row of iT
constexpr int kChainSmem = 4 * kBlk * (kBlk + kChainPitch);  // X: ts and iT, bytes
static_assert(kChainSmem <= 232448, "X: ts and iT exceed a block's shared memory");
constexpr int kColWarps = 8;  // S: a window's warps
constexpr int kColThreads = 32 * kColWarps;
constexpr int kColRows = kWinRows / kColWarps;  // S: rows a warp

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

__global__ void __launch_bounds__(kChainThreads) gather_chain_kernel(
    const uint4* __restrict__ t, const uint4* __restrict__ i, uint4* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const ts = smem;                // t's block as it lies, 128 x 128
  uint32_t* const iT = smem + kBlk * kBlk;  // iT[r * kChainPitch + k] = i[k][r]
  constexpr int kChunks = kBlk * kBlk / 4;  // 16-byte chunks of a block
  constexpr int kPer = kChunks / kChainThreads;  // 8 chunks a thread of each
  constexpr int kWarps = kChainThreads / 32;
  const size_t first = (size_t)blockIdx.x * kChunks;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // The thread's chunks of i: tile warp + 16 n of 8 rows x 4 chunks, its
  // row k[n] and chunk q[n] (of the row's 32).
  int k[kPer], q[kPer];
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int tile = warp + kWarps * n;
    k[n] = 8 * (tile % 16) + lane % 8;
    q[n] = 4 * (tile / 16) + lane / 8;
  }
  uint4 tv[kPer], iv[kPer];
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    tv[n] = __ldg(t + first + threadIdx.x + n * kChainThreads);
    iv[n] = __ldg(i + first + k[n] * (kBlk / 4) + q[n]);
  }
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    *reinterpret_cast<uint4*>(ts + 4 * (threadIdx.x + n * kChainThreads)) = tv[n];
    uint32_t* col = iT + 4 * q[n] * kChainPitch + k[n];
    col[0] = iv[n].x;
    col[kChainPitch] = iv[n].y;
    col[2 * kChainPitch] = iv[n].z;
    col[3 * kChainPitch] = iv[n].w;
  }
  __syncthreads();
  // Outputs (k[n], 4 q[n] + j): m = iT[k[n]][i], out = ts[i][m].
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const uint32_t* row = iT + k[n] * kChainPitch;
    const uint32_t a = iv[n].x, b = iv[n].y, c = iv[n].z, d = iv[n].w;
    out[first + k[n] * (kBlk / 4) + q[n]] =
        make_uint4(ts[a * kBlk + row[a]], ts[b * kBlk + row[b]], ts[c * kBlk + row[c]],
                   ts[d * kBlk + row[d]]);
  }
}

// S: block k serves window k; warp w sums rows w + 8 i (i < 12), lane l
// columns l + 32 j (j < 4) of each.
__global__ void __launch_bounds__(kColThreads) window_colsum_kernel(
    const int32_t* __restrict__ img, const int32_t* __restrict__ ax,
    const int32_t* __restrict__ ay, int32_t* __restrict__ out, int width) {
  __shared__ uint32_t sums[kColWarps * kWinCols];  // the warps' partial sums
  const int k = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t* row = img + (size_t)(ay[k] + warp) * width + ax[k] + lane;
  const size_t step = (size_t)kColWarps * width;  // between this warp's rows
  uint32_t v[kColRows][4];
#pragma unroll
  for (int r = 0; r < kColRows; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[r][j] = (uint32_t)__ldg(row + r * step + 32 * j);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t s = v[0][j];
#pragma unroll
    for (int r = 1; r < kColRows; ++r) s += v[r][j];
    sums[warp * kWinCols + lane + 32 * j] = s;
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < kWinCols) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) sum += sums[w * kWinCols + c];
    out[(size_t)k * kWinCols + c] = (int32_t)sum;
  }
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

// X. t, i and out are (nblk * 128, 128) int32, 16-byte aligned.
extern "C" int brisk_probe_gather_chain(const void* t, const void* i, void* out, int nblk,
                                        void* stream) {
  return (int)launch(gather_chain_kernel, nblk, kChainThreads, kChainSmem, (cudaStream_t)stream,
                     (const uint4*)t, (const uint4*)i, (uint4*)out);
}

// S. img (height, width) int32; ax, ay (K,) int32; out (K, 128) int32.
extern "C" int brisk_probe_window_colsum(const void* img, const void* ax, const void* ay,
                                         void* out, int width, int K, void* stream) {
  return (int)launch(window_colsum_kernel, K, kColThreads, 0, (cudaStream_t)stream,
                     (const int32_t*)img, (const int32_t*)ax, (const int32_t*)ay, (int32_t*)out,
                     width);
}

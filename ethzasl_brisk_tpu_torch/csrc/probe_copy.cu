// Copies of the TPU gather probes on Hopper (kernels C and W).
//
// C, relayout, replaces tools/probes/probe_sublane_gather.py:135 relay
// (out = pat.reshape(128, 4096).T, written column by column in VMEM) and
// tools/probes/probe_sampler_blocks.py:144 f_resh (out =
// pat.reshape(8192, 64), an in-kernel reshape). For an int32 (rows, cols)
// source it writes the (cols, rows) transpose or a plain copy. Both moves
// are 16 bytes a thread where probes/gather.py:relayout_vector allows it
// (both bases 16-byte aligned; for the transpose, rows and cols multiples
// of 4), and 4 bytes a thread elsewhere:
//   copy: no shared memory and no barrier; each thread has four loads in
//     flight before its four stores, and a grid of 1024 chunks a block
//     covers the probe's 2 MiB in one wave (a block's first threads copy
//     the last n % 4 words);
//   transpose: a block of two warps per 32 x 32 tile, each warp loading 16
//     of its rows as 16-byte chunks, 4 a lane, and writing their words
//     down the columns of a swizzled tile (chunk c of row R at c ^ (R / 4
//     % 8), as T's in probe_mosaic.cu, so a column write hits 32 banks);
//     after the barrier each warp stores 16 output rows as 16-byte chunks.
//     A warp a tile (T's layout, 8 chunks a lane) measured slower at the
//     probe's (128, 4096), where it leaves 4 warps an SM. The scalar
//     transpose moves one 32 x 33-word tile a block.
// Both probe calls move 2 MiB each way: at 3.35 TB/s that is 1.25 us,
// under the ~2 us that any launch of one wave takes on the card.
//
// W, window_copy, replaces tools/probes/probe_sampler_blocks.py:182 f_dma
// (k_dma, :163) and :238 f_dma2 (k_dma2, :200), which copy K windows of
// 64 x 64 int32 from an image in HBM to a VMEM slab by per-window DMAs (one
// at a time, or 8 in flight):
//   out[k * 64 + r, c] = img[ay[k] + r, ax[k] + c].
// Two bodies, picked per call by probes/gather.py:window_plan:
// 16-byte, window_copy16_kernel, where the image's base and the output are
//   16-byte aligned and the width is a multiple of 4: four CTAs of 256
//   threads a window, 16 rows each, a thread an output chunk. A lane loads
//   the aligned chunks q and q + 1 from column ax & ~3 of its image row
//   together, keeps the four words ax % 4 in and stores 16 bytes. No
//   shared memory and no barrier: one load round trip, then the store, with
//   512 CTAs so that every SM takes part. Taking chunk q + 1 from the next
//   lane by a shuffle instead ran as fast (0.00243 against 0.00246 ms), and
//   0.0031 when the compiler split the two loads around the shuffle.
// Words, window_copy_kernel, everywhere else: a CTA of 256 threads a
//   window, element by element.
// Why not TMA, Hopper's counterpart of the TPU's DMA (measured on an H100,
// PERF.md §6): a tiled TMA load faults with an illegal instruction unless
// its first column starts on a 16-byte boundary, so a window must be loaded
// as 68 columns from ax & ~3 into shared memory and shifted on its way out.
// That design, at one window, two windows or a quarter window a CTA, ran
// 0.0027-0.0030 ms at the probe's 128 windows against this body's 0.0025,
// and a TMA load with a bulk store, on windows already aligned, took
// 0.0027. This body at one, two or eight CTAs a window ran 0.0029, 0.0026
// and 0.0026; the first design (rows staged in shared memory, a barrier,
// shifted scalar reads) took 0.0047.
//
// Bound: bytes, no arithmetic. C reads and writes every element once. W
// reads the 32-byte sectors its windows cover (8 or 9 per window row) and
// the 2 K offsets, and writes K * 16 KiB. Window offsets are trusted to
// be in range (the plain version checks them).

#include <cstdint>
#include <cuda_runtime.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // the scalar transpose's block: 32 x 8 threads
constexpr int kTileWarps = 2;    // the 16-byte transpose's block: a tile, 16 rows a warp
constexpr int kCopyThreads = 256;
constexpr int kCopyLoads = 4;    // loads in flight a copy thread
constexpr int kWin = 64;
constexpr int kWinThreads = 256;               // the word body: a CTA a window
constexpr int kWinSplit = 4;                   // the 16-byte body: CTAs a window
constexpr int kSplitRows = kWin / kWinSplit;   // rows a CTA
constexpr int kChunkThreads = kSplitRows * kWin / 4;  // a 16-byte output chunk a thread

template <bool kVector>
__global__ void __launch_bounds__(kCopyThreads) relayout_copy_kernel(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ out, int n) {
  // In 16-byte chunks when kVector, else in words.
  using Unit = typename std::conditional<kVector, uint4, uint32_t>::type;
  constexpr int kWords = sizeof(Unit) / 4;
  const int units = n / kWords;
  const Unit* s = reinterpret_cast<const Unit*>(src);
  Unit* o = reinterpret_cast<Unit*>(out);
  const int step = gridDim.x * kCopyThreads * kCopyLoads;
  for (int x0 = blockIdx.x * kCopyThreads * kCopyLoads + threadIdx.x; x0 < units;
       x0 += step) {
    Unit v[kCopyLoads];
#pragma unroll
    for (int m = 0; m < kCopyLoads; ++m) {
      const int x = x0 + m * kCopyThreads;
      if (x < units) v[m] = s[x];
    }
#pragma unroll
    for (int m = 0; m < kCopyLoads; ++m) {
      const int x = x0 + m * kCopyThreads;
      if (x < units) o[x] = v[m];
    }
  }
  const int tail = units * kWords + (int)threadIdx.x;
  if (blockIdx.x == 0 && tail < n) out[tail] = src[tail];
}

// Word (R, col) of a 32 x 32 tile: the 16-byte chunk col / 4 of row R at
// chunk (col / 4) ^ (R / 4 % 8).
__device__ __forceinline__ int swizzled(int R, int col) {
  return R * kTile + ((((col >> 2) ^ ((R >> 2) & 7)) << 2) | (col & 3));
}

__global__ void __launch_bounds__(kTileWarps * 32) relayout_transpose16_kernel(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ out, int rows, int cols,
    int col_tiles) {
  __shared__ __align__(16) uint32_t s[kTile * kTile];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 8, c4 = 4 * (lane % 8);  // tile rows 4 (2t + w) + r, columns c4 .. c4+3
  const int r0 = (blockIdx.x / col_tiles) * kTile, k0 = (blockIdx.x % col_tiles) * kTile;
  uint4 v[kTile / 4 / kTileWarps];
#pragma unroll
  for (int t = 0; t < kTile / 4 / kTileWarps; ++t) {
    const int i = r0 + 4 * (kTileWarps * t + w) + r;
    v[t] = i < rows && k0 + c4 < cols
               ? __ldg(reinterpret_cast<const uint4*>(src + (size_t)i * cols + k0 + c4))
               : make_uint4(0, 0, 0, 0);
  }
  // Source element (i, c4 + m) of the tile to (c4 + m, i).
#pragma unroll
  for (int t = 0; t < kTile / 4 / kTileWarps; ++t) {
    const int i = 4 * (kTileWarps * t + w) + r;
    s[swizzled(c4, i)] = v[t].x;
    s[swizzled(c4 + 1, i)] = v[t].y;
    s[swizzled(c4 + 2, i)] = v[t].z;
    s[swizzled(c4 + 3, i)] = v[t].w;
  }
  __syncthreads();
  // Output row k0 + i (source column k0 + i), columns r0 + c4 .. r0 + c4 + 3.
#pragma unroll
  for (int t = 0; t < kTile / 4 / kTileWarps; ++t) {
    const int i = 4 * (kTileWarps * t + w) + r;
    if (k0 + i < cols && r0 + c4 < rows) {
      *reinterpret_cast<uint4*>(out + (size_t)(k0 + i) * rows + r0 + c4) =
          *reinterpret_cast<const uint4*>(s + swizzled(i, c4));
    }
  }
}

__global__ void __launch_bounds__(kTile * kRowsPerPass) relayout_transpose_kernel(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ out, int rows, int cols,
    int col_tiles) {
  __shared__ uint32_t tile[kTile][kTile + 1];  // 33 words a row: a column read hits 32 banks
  const int r0 = (blockIdx.x / col_tiles) * kTile;
  const int c0 = (blockIdx.x % col_tiles) * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int dy = ty; dy < kTile; dy += kRowsPerPass) {
    const int r = r0 + dy, c = c0 + tx;
    if (r < rows && c < cols) tile[dy][tx] = src[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int dy = ty; dy < kTile; dy += kRowsPerPass) {
    // Output row c0 + dy holds source column c0 + dy.
    const int orow = c0 + dy, ocol = r0 + tx;
    if (orow < cols && ocol < rows) out[(size_t)orow * rows + ocol] = tile[tx][dy];
  }
}

__global__ void __launch_bounds__(kWinThreads) window_copy_kernel(
    const int32_t* __restrict__ img, const int32_t* __restrict__ ax,
    const int32_t* __restrict__ ay, int32_t* __restrict__ out, int width) {
  const int32_t* win = img + (size_t)ay[blockIdx.x] * width + ax[blockIdx.x];
  int32_t* dst = out + (size_t)blockIdx.x * kWin * kWin;
  for (int i = threadIdx.x; i < kWin * kWin; i += kWinThreads) {
    dst[i] = win[(size_t)(i / kWin) * width + i % kWin];
  }
}

// Output chunk q of a window row from the aligned chunks a = q and b = q + 1
// of its image row, for a window that starts S words past its aligned column.
template <int S>
__device__ __forceinline__ int4 shifted(int4 a, int4 b) {
  if (S == 0) return a;
  if (S == 1) return make_int4(a.y, a.z, a.w, b.x);
  if (S == 2) return make_int4(a.z, a.w, b.x, b.y);
  return make_int4(a.w, b.x, b.y, b.z);
}

// Chunk q of row r of the window (q = threadIdx.x % 16) from the aligned
// chunks q and q + 1 of its image row, both loaded at once. Chunk q + 1 is
// the next lane's chunk, which L1 serves again; for q = 15 it is chunk 16,
// loaded only when S != 0 (width % 4 == 0 and ax + 64 <= width put it
// inside the row).
template <int S>
__device__ __forceinline__ void copy_chunk(const int32_t* __restrict__ img,
                                           int32_t* __restrict__ dst, int width, int a0,
                                           int y0) {
  const int q = threadIdx.x % 16, r = threadIdx.x / 16;
  const int4* p = reinterpret_cast<const int4*>(img + (size_t)(y0 + r) * width + a0 + 4 * q);
  const int4 v = __ldg(p);
  const int4 next = S != 0 ? __ldg(p + 1) : v;
  *reinterpret_cast<int4*>(dst + r * kWin + 4 * q) = shifted<S>(v, next);
}

// CTA u copies rows 16 (u % 4) .. 16 (u % 4) + 15 of window u / 4.
__global__ void __launch_bounds__(kChunkThreads) window_copy16_kernel(
    const int32_t* __restrict__ img, const int32_t* __restrict__ ax,
    const int32_t* __restrict__ ay, int32_t* __restrict__ out, int width) {
  const int k = blockIdx.x / kWinSplit, part = blockIdx.x % kWinSplit;
  const int x0 = ax[k], y0 = ay[k] + part * kSplitRows, a0 = x0 & ~3;
  int32_t* dst = out + (size_t)k * kWin * kWin + part * kSplitRows * kWin;
  switch (x0 & 3) {  // the same for every thread of the CTA
    case 0: copy_chunk<0>(img, dst, width, a0, y0); break;
    case 1: copy_chunk<1>(img, dst, width, a0, y0); break;
    case 2: copy_chunk<2>(img, dst, width, a0, y0); break;
    default: copy_chunk<3>(img, dst, width, a0, y0); break;
  }
}

}  // namespace

// C. src (rows, cols) int32 -> out (cols, rows) if transpose else (rows, cols);
// vector: 16-byte moves (probes/gather.py:relayout_vector).
extern "C" int brisk_probe_relayout(const void* src_, void* out_, int rows, int cols,
                                    int transpose, int vector, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* src = (const uint32_t*)src_;
  uint32_t* out = (uint32_t*)out_;
  const int row_tiles = (rows + kTile - 1) / kTile;
  const int col_tiles = (cols + kTile - 1) / kTile;
  const int tiles = row_tiles * col_tiles;
  if (transpose && vector) {
    relayout_transpose16_kernel<<<tiles, kTileWarps * 32, 0, st>>>(src, out, rows, cols,
                                                                   col_tiles);
  } else if (transpose) {
    relayout_transpose_kernel<<<tiles, dim3(kTile, kRowsPerPass), 0, st>>>(src, out, rows,
                                                                            cols, col_tiles);
  } else {
    const int n = rows * cols;
    const int units = vector ? n / 4 : n;
    const int per_block = kCopyThreads * kCopyLoads;
    const int blocks = units > per_block ? (units + per_block - 1) / per_block : 1;
    if (vector) {
      relayout_copy_kernel<true><<<blocks, kCopyThreads, 0, st>>>(src, out, n);
    } else {
      relayout_copy_kernel<false><<<blocks, kCopyThreads, 0, st>>>(src, out, n);
    }
  }
  return (int)cudaGetLastError();
}

// W. img (height, width) int32; ax, ay (K,) int32; out (K * 64, 64) int32;
// vector: probes/gather.py:window_plan's body (16-byte moves, else words).
extern "C" int brisk_probe_window_copy(const void* img, const void* ax, const void* ay,
                                       void* out, int width, int K, int vector, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t *i = (const int32_t*)img, *x = (const int32_t*)ax, *y = (const int32_t*)ay;
  int32_t* o = (int32_t*)out;
  if (vector) {
    return (int)launch(window_copy16_kernel, K * kWinSplit, kChunkThreads, 0, st, i, x, y, o,
                       width);
  }
  return (int)launch(window_copy_kernel, K, kWinThreads, 0, st, i, x, y, o, width);
}

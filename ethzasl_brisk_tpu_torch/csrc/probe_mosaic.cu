// The in-kernel building blocks of the TPU Mosaic probes on Hopper
// (kernels T, X and S).
//
// T, transpose_chain, replaces tools/probes/probe_mosaic_gather3.py:86
// transpose_many: an int32 (m, 128) table in m / 128 square blocks, each
// taken through eight rounds of x = x.T; x = x + 1. Eight transposes return
// every element to its place, so the result is t + 8 (int32 wrapping).
// The TPU holds the whole 128 x 128 block in VMEM and transposes it in the
// vector unit. Here each block of threads owns one symmetric pair of 32 x 32
// sub-tiles, (I, J) and (J, I) with I <= J (ten pairs per 128 x 128 block),
// in two padded [32][33] words of shared memory (8.4 KB): a round reads
// each tile's transpose down a column, which the padding spreads over all
// 32 banks, adds 1 and writes it as the partner's new tile. A diagonal
// tile is its own partner. Adds are unsigned, so overflow wraps as two's
// complement without undefined behaviour.
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
// 8 adds per element are a tenth of that time); X reads the index and
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
constexpr int kSubRows = 8;     // T: thread rows; each thread owns 4 rows of a tile
constexpr int kPairs = 10;      // (I, J), I <= J, over the 4 x 4 sub-tiles
constexpr int kRounds = 8;
constexpr int kThreads = 256;
constexpr int kWinRows = 96;
constexpr int kWinCols = 128;

__global__ void __launch_bounds__(kSub * kSubRows) transpose_chain_kernel(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ out) {
  __shared__ uint32_t tile[2][kSub][kSub + 1];  // [0]: (I, J), [1]: (J, I)
  const size_t base = (size_t)(blockIdx.x / kPairs) * kBlk * kBlk;
  int p = blockIdx.x % kPairs, I = 0;
  while (p > 3 - I) {
    p -= 4 - I;
    ++I;
  }
  const int J = I + p;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t at_ij = base + (size_t)I * kSub * kBlk + J * kSub;
  const size_t at_ji = base + (size_t)J * kSub * kBlk + I * kSub;
#pragma unroll
  for (int k = 0; k < kSub / kSubRows; ++k) {
    const int i = ty + kSubRows * k;
    tile[0][i][tx] = src[at_ij + i * kBlk + tx];
    tile[1][i][tx] = src[at_ji + i * kBlk + tx];
  }
  __syncthreads();
  for (int round = 0; round < kRounds; ++round) {
    // New (I, J)[i][j] = old (J, I)[j][i] + 1, and the other way round.
    uint32_t a[kSub / kSubRows], b[kSub / kSubRows];
#pragma unroll
    for (int k = 0; k < kSub / kSubRows; ++k) {
      const int i = ty + kSubRows * k;
      a[k] = tile[1][tx][i] + 1u;
      b[k] = tile[0][tx][i] + 1u;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSub / kSubRows; ++k) {
      const int i = ty + kSubRows * k;
      tile[0][i][tx] = a[k];
      tile[1][i][tx] = b[k];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kSub / kSubRows; ++k) {
    const int i = ty + kSubRows * k;
    out[at_ij + i * kBlk + tx] = tile[0][i][tx];
    if (I != J) out[at_ji + i * kBlk + tx] = tile[1][i][tx];
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

// T. src and out are (nblk * 128, 128) int32.
extern "C" int brisk_probe_transpose_chain(const void* src, void* out, int nblk, void* stream) {
  const dim3 block(kSub, kSubRows);
  transpose_chain_kernel<<<(unsigned)nblk * kPairs, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)src, (uint32_t*)out);
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

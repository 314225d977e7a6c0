// Copies of the TPU gather probes on Hopper (kernels C and W).
//
// C, relayout, replaces tools/probes/probe_sublane_gather.py:135 relay
// (out = pat.reshape(128, 4096).T, written column by column in VMEM) and
// tools/probes/probe_sampler_blocks.py:144 f_resh (out =
// pat.reshape(8192, 64), an in-kernel reshape). For an int32 (rows, cols)
// source it writes the (cols, rows) transpose or a plain copy. Each block
// moves one 32 x 32 tile through shared memory (32 x 33 words, so the
// transposed reads hit 32 different banks): reads and writes are both
// coalesced whether or not the tile is transposed.
//
// W, window_copy, replaces tools/probes/probe_sampler_blocks.py:182 f_dma
// and :238 f_dma2, which copy K windows of 64 x 64 int32 from an image in
// HBM to a VMEM slab by per-window DMAs (one at a time, or 8 in flight):
//   out[k * 64 + r, c] = img[ay[k] + r, ax[k] + c].
// One block per window. Each row is read as 16-byte chunks from the
// aligned column ax & ~3, seventeen of them when ax is not a multiple of
// 4, into shared memory; each output row is written as sixteen 16-byte
// stores from the shifted shared row. An image whose width is not a
// multiple of 4, or whose base is not 16-byte aligned, takes a plain
// element-by-element copy. The TPU's semaphores and overlapped DMAs have no
// counterpart: the blocks run in parallel, and cp.async/TMA staging is
// later work.
//
// Bound: bytes, no arithmetic. C reads and writes every element once. W
// reads the 32-byte sectors its windows cover (8 or 9 per window row) and
// the 2 K offsets, and writes K * 16 KiB. Window offsets are trusted to
// be in range (the plain version checks them).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;
constexpr int kWin = 64;
constexpr int kWinThreads = 256;

template <bool kTranspose>
__global__ void __launch_bounds__(kTile * kRowsPerPass) relayout_kernel(
    const int32_t* __restrict__ src, int32_t* __restrict__ out, int rows, int cols,
    int col_tiles) {
  __shared__ int32_t tile[kTile][kTile + 1];
  const int r0 = (blockIdx.x / col_tiles) * kTile;
  const int c0 = (blockIdx.x % col_tiles) * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int dy = ty; dy < kTile; dy += kRowsPerPass) {
    const int r = r0 + dy, c = c0 + tx;
    if (r < rows && c < cols) tile[dy][tx] = src[(size_t)r * cols + c];
  }
  __syncthreads();
  for (int dy = ty; dy < kTile; dy += kRowsPerPass) {
    if (kTranspose) {
      // Output row c0 + dy holds source column c0 + dy.
      const int orow = c0 + dy, ocol = r0 + tx;
      if (orow < cols && ocol < rows) out[(size_t)orow * rows + ocol] = tile[tx][dy];
    } else {
      const int r = r0 + dy, c = c0 + tx;
      if (r < rows && c < cols) out[(size_t)r * cols + c] = tile[dy][tx];
    }
  }
}

template <bool kVector>
__global__ void __launch_bounds__(kWinThreads) window_copy_kernel(
    const int32_t* __restrict__ img, const int32_t* __restrict__ ax,
    const int32_t* __restrict__ ay, int32_t* __restrict__ out, int width) {
  // Four spare words per row for the seventeenth chunk; rows stay 16-byte aligned.
  __shared__ __align__(16) int32_t rows[kWin][kWin + 4];
  const int x0 = ax[blockIdx.x], y0 = ay[blockIdx.x];
  const int32_t* win = img + (size_t)y0 * width;
  int32_t* dst = out + (size_t)blockIdx.x * kWin * kWin;
  if (!kVector) {
    for (int i = threadIdx.x; i < kWin * kWin; i += kWinThreads) {
      const int r = i / kWin, c = i % kWin;
      dst[i] = win[(size_t)r * width + x0 + c];
    }
    return;
  }
  const int a0 = x0 & ~3, shift = x0 & 3;
  const int chunks = kWin / 4 + (shift != 0);
  // With width % 4 == 0 and x0 + 64 <= width, chunk a0 + 64 exists only
  // when shift != 0 and then ends inside the row.
  for (int i = threadIdx.x; i < kWin * chunks; i += kWinThreads) {
    const int r = i / chunks, q = i % chunks;
    *reinterpret_cast<int4*>(&rows[r][4 * q]) =
        *reinterpret_cast<const int4*>(win + (size_t)r * width + a0 + 4 * q);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kWin * kWin / 4; i += kWinThreads) {
    const int r = i / (kWin / 4), q = i % (kWin / 4);
    const int32_t* s = &rows[r][shift + 4 * q];
    *reinterpret_cast<int4*>(dst + r * kWin + 4 * q) = make_int4(s[0], s[1], s[2], s[3]);
  }
}

}  // namespace

// C. src (rows, cols) int32 -> out (cols, rows) if transpose else (rows, cols).
extern "C" int brisk_probe_relayout(const void* src, void* out, int rows, int cols,
                                    int transpose, void* stream) {
  const int row_tiles = (rows + kTile - 1) / kTile;
  const int col_tiles = (cols + kTile - 1) / kTile;
  const dim3 block(kTile, kRowsPerPass);
  const unsigned blocks = (unsigned)row_tiles * (unsigned)col_tiles;
  if (transpose) {
    relayout_kernel<true><<<blocks, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)src, (int32_t*)out, rows, cols, col_tiles);
  } else {
    relayout_kernel<false><<<blocks, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)src, (int32_t*)out, rows, cols, col_tiles);
  }
  return (int)cudaGetLastError();
}

// W. img (height, width) int32; ax, ay (K,) int32; out (K * 64, 64) int32.
extern "C" int brisk_probe_window_copy(const void* img, const void* ax, const void* ay,
                                       void* out, int width, int K, void* stream) {
  const bool vector = width % 4 == 0 && (uintptr_t)img % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vector) {
    window_copy_kernel<true><<<K, kWinThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)img, (const int32_t*)ax, (const int32_t*)ay, (int32_t*)out, width);
  } else {
    window_copy_kernel<false><<<K, kWinThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)img, (const int32_t*)ax, (const int32_t*)ay, (int32_t*)out, width);
  }
  return (int)cudaGetLastError();
}

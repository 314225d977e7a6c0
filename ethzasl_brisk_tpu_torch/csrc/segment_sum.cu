// Ordered segment sums for the BA's normal equations.
//
// Replaces no TPU kernel: the JAX package scatter-adds in XLA, which on
// the CPU adds the updates one after the other. The port's index_add_ adds
// with atomics on the card, in an order that changes from run to run, so
// two runs of the VO loop drifted apart. A solve's indices are fixed over
// its iterations, so it builds a CSR once (ba/segment.py: a stable argsort
// and segment offsets); this kernel then sums each segment's rows in
// ascending observation order, from 0, in float32 or float64: the CPU
// index_add_'s bits on either device, whatever the launch order. The plain
// version is ba/segment.py's segment_sum_plain.
//
// A block per segment and 256 components of its rows (grid y for wider
// rows). The adds of a component are one serial chain, which the order
// forbids splitting, so the block stages tiles of up to 128 rows in shared
// memory with all its threads, every load in flight, and then the thread
// that owns a component adds the tile's rows in order from shared memory.
// A window's keyframes (~600 rows each) and its landmarks (a few rows
// each) take the same body.
// Bound: bytes (each kept observation row read once, each segment row
// written once, the order and offsets read once); the adds are few. What
// holds it back on long segments is the serial chain: a tile's adds wait
// on one another.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 128;
constexpr int kTileBytes = 40 * 1024;  // under the 48 KB a block takes without opting in

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ values, const int64_t* __restrict__ order,
                                   const int64_t* __restrict__ offsets, T* __restrict__ out,
                                   int width, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int64_t seg = blockIdx.x;
  const int c0 = blockIdx.y * kThreads;                      // this block's first component
  const int cw = width - c0 < kThreads ? width - c0 : kThreads;  // and its count
  const int64_t begin = offsets[seg], end = offsets[seg + 1];
  const int c = threadIdx.x;  // the component this thread adds (c < cw)
  T acc = T(0);
  for (int64_t base = begin; base < end; base += tile_rows) {
    const int rows = static_cast<int>(end - base < tile_rows ? end - base : tile_rows);
    for (int e = threadIdx.x; e < rows * cw; e += kThreads) {
      const int r = e / cw;
      tile[e] = values[order[base + r] * width + c0 + (e - r * cw)];
    }
    __syncthreads();
    if (c < cw) {
      for (int r = 0; r < rows; ++r) acc = add_rn(acc, tile[r * cw + c]);
    }
    __syncthreads();
  }
  if (c < cw) out[seg * width + c0 + c] = acc;
}

}  // namespace

extern "C" int brisk_segment_sum(const void* values, const void* order, const void* offsets,
                                 void* out, int n_seg, int width, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ord = static_cast<const int64_t*>(order);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const int elem = is_double ? 8 : 4;
  const int cw = width < kThreads ? width : kThreads;
  const int tile_rows = kTileBytes / (cw * elem) < kTileRows ? kTileBytes / (cw * elem) : kTileRows;
  const size_t smem = static_cast<size_t>(tile_rows) * cw * elem;
  const dim3 grid(static_cast<unsigned>(n_seg), static_cast<unsigned>((width + kThreads - 1) / kThreads));
  if (is_double) {
    segment_sum_kernel<double><<<grid, kThreads, smem, s>>>(
        static_cast<const double*>(values), ord, off, static_cast<double*>(out), width, tile_rows);
  } else {
    segment_sum_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(values), ord, off, static_cast<float*>(out), width, tile_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

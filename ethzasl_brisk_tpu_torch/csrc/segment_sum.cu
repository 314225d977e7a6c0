// Ordered segment sums for the BA's normal equations, every sum of a call
// site in one launch.
//
// Replaces no TPU kernel: the JAX package scatter-adds in XLA, which on
// the CPU adds the updates one after the other. The port's index_add_ adds
// with atomics on the card, in an order that changes from run to run, so
// two runs of the VO loop drifted apart. A solve's indices are fixed over
// its iterations, so it builds a CSR once (ba/segment.py: a stable argsort
// and segment offsets); this kernel then sums each segment's rows in
// ascending observation order, from 0, in float32 or float64: the CPU
// index_add_'s bits (which the JAX package's scatter gives) on either
// device, whatever the launch order. The plain version is ba/segment.py's
// segment_sum_plain, item by item.
//
// One launch takes up to kMaxItems (values, plan) items, all of one type:
// a Gauss-Newton step's five sums are one launch. The work space is
// flattened over (item, segment, slice of kSlice components); the host
// knows its size from each item's segment count and width, so the launch
// needs no host sync. A warp takes one unit at a time (a persistent grid
// strides over the units: a window's (landmark, keyframe) plan has
// thousands of mostly empty segments), and its lanes take neighbouring
// components, so the loads of a row are coalesced. The adds of a component
// are one serial chain, which the order forbids splitting; a keyframe's
// chain is up to a few hundred rows. So the chain waits on no gather it
// could have issued earlier: a lane keeps a chunk of kRows gathered rows in
// registers, the next chunk's loads in flight while it adds these, and the
// order entries of the chunk after that in flight too (one a lane, handed
// out by shuffles). No load feeds a select: a select on a load's value
// waits for it, and a chunk's loads would go one at a time. A chunk still
// waits one memory latency, so a long segment's rows past its first two
// chunks are prefetched into L2 before the chain starts.
// Empty and short segments cost a warp a few instructions; no block-wide
// barrier is left. The adds are __fadd_rn / __dadd_rn, so no contraction
// or reordering creeps in.
//
// Bound: bytes (each kept observation row read once, each segment row
// written once, the order and offsets read once) or, where it is larger,
// the chain: the longest segment's rows times the dependent add's latency.
// The add-latency probe (brisk_add_latency) measures that latency on the
// card for the second bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 32;    // components a warp sums: one a lane
constexpr int kMaxItems = 8;  // items a launch takes
constexpr int kFields = 6;    // a host item: values, order, offsets, out, segments, width

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The items, by value in the kernel's parameters. first[i] is item i's
// first unit; first[count..kMaxItems] hold the total.
struct Items {
  const void* values[kMaxItems];
  const int64_t* order[kMaxItems];
  const int64_t* offsets[kMaxItems];
  void* out[kMaxItems];
  long long first[kMaxItems + 1];
  int width[kMaxItems];
  int slices[kMaxItems];
};

// a[it] with constant indices only, so the parameters are not copied to
// local memory for a dynamic index.
template <typename X>
__device__ __forceinline__ X pick(const X (&a)[kMaxItems], int it) {
  X r = a[0];
#pragma unroll
  for (int i = 1; i < kMaxItems; ++i) {
    if (i == it) r = a[i];
  }
  return r;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Rows a lane keeps in registers a chunk: 16 floats or 8 doubles, so two
// chunks take 32 registers a lane either way. Longer chunks cost the short
// segments more warps on an SM than they save the long chains.
template <typename T>
__host__ __device__ constexpr int rows_of() { return 64 / static_cast<int>(sizeof(T)); }

// Asks L2 for the `bytes` bytes at `p` (every 128-byte line they touch).
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes) {
  const char* c = static_cast<const char*>(p);
  for (int off = 0; off < bytes; off += 128) asm volatile("prefetch.global.L2 [%0];" ::"l"(c + off));
  asm volatile("prefetch.global.L2 [%0];" ::"l"(c + bytes - 1));
}

// Chunk `base`'s values: row j's observation index comes from lane j's
// `idx`. Every load is unconditional (rows past the segment's end read the
// last row again, lanes past the width column 0), so no select waits on a
// load and all of a chunk's loads are in flight at once; the adds skip
// what lies past the end.
template <typename T>
__device__ __forceinline__ void gather(T (&v)[rows_of<T>()], const T* __restrict__ values,
                                       int64_t idx, int width, int col) {
#pragma unroll
  for (int j = 0; j < rows_of<T>(); ++j) {
    const int64_t row = __shfl_sync(0xffffffffu, idx, j);
    v[j] = values[row * width + col];
  }
}

// The adds of a chunk whose first `left` rows lie in the segment, in order.
template <typename T>
__device__ __forceinline__ T add_chunk(T acc, const T (&v)[rows_of<T>()], int64_t left) {
#pragma unroll
  for (int j = 0; j < rows_of<T>(); ++j) {
    if (j < left) acc = add_rn(acc, v[j]);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) segment_sums_kernel(const Items items) {
  constexpr int kRows = rows_of<T>();
  const int lane = threadIdx.x & 31;
  const long long total = items.first[kMaxItems];
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); u < total;
       u += stride) {
    int it = 0;
    long long first = 0;
#pragma unroll
    for (int i = 1; i < kMaxItems; ++i) {
      if (u >= items.first[i]) {
        it = i;
        first = items.first[i];
      }
    }
    const int width = pick(items.width, it), slices = pick(items.slices, it);
    const long long local = u - first;
    const long long seg = local / slices;
    const int c = static_cast<int>(local - seg * slices) * kSlice + lane;
    const bool live = c < width;
    const T* __restrict__ values = static_cast<const T*>(pick(items.values, it));
    const int64_t* __restrict__ order = pick(items.order, it);
    const int64_t* __restrict__ offsets = pick(items.offsets, it);
    const int64_t begin = offsets[seg], end = offsets[seg + 1];
    T acc = T(0);
    if (begin < end) {
      // Lane j holds the order entry of a chunk's row j (the last row past
      // the end). Two buffers, taken in turns: while one chunk adds, the
      // next one's loads and the order of the one after are in flight.
      const int col = live ? c : 0;
      const int64_t last = end - 1;
      // A long chain would wait on one device-memory latency a chunk: the
      // rows past its first two chunks are asked into L2 first, a row a
      // lane, 128 rows an order load, so its gathers hit L2.
      const int slice_start = c - lane;
      const int slice_bytes = (width - slice_start < kSlice ? width - slice_start : kSlice) *
                              static_cast<int>(sizeof(T));
      for (int64_t r0 = begin + 2 * kRows; r0 < end; r0 += 4 * 32) {
        int64_t rows[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) rows[q] = order[min64(r0 + q * 32 + lane, last)];
#pragma unroll
        for (int q = 0; q < 4; ++q) prefetch_l2(values + rows[q] * width + slice_start, slice_bytes);
      }
      T a[kRows], b[kRows];
      int64_t idx = order[min64(begin + lane, last)];
      gather<T>(a, values, idx, width, col);
      idx = order[min64(begin + kRows + lane, last)];
      for (int64_t base = begin;;) {
        if (base + kRows < end) gather<T>(b, values, idx, width, col);
        idx = order[min64(base + 2 * kRows + lane, last)];
        acc = add_chunk<T>(acc, a, end - base);
        base += kRows;
        if (base >= end) break;
        if (base + kRows < end) gather<T>(a, values, idx, width, col);
        idx = order[min64(base + 2 * kRows + lane, last)];
        acc = add_chunk<T>(acc, b, end - base);
        base += kRows;
        if (base >= end) break;
      }
    }
    if (live) static_cast<T*>(pick(items.out, it))[seg * width + c] = acc;
  }
}

// The add-latency probe: one thread runs `adds` dependent adds (a multiple
// of 16) and writes the SM cycles they took, and the sum so the chain is
// kept.
template <typename T>
__global__ void add_latency_kernel(T x, T y, int adds, long long* cycles, T* sink) {
  const long long t0 = clock64();
  for (int i = 0; i < adds; i += 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) x = add_rn(x, y);
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = x;
}

// Blocks that fit on the card at once, for the persistent grid.
template <typename T>
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_sums_kernel<T>, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

}  // namespace

// items: n_items x kFields int64 (values, order, offsets and out pointers,
// segments, width), every values of one type.
extern "C" int brisk_segment_sums(const void* host_items, int n_items, int is_double,
                                  void* stream) {
  if (n_items < 1 || n_items > kMaxItems) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* f = static_cast<const int64_t*>(host_items);
  Items items = {};
  long long units = 0;
  for (int i = 0; i < n_items; ++i, f += kFields) {
    items.values[i] = reinterpret_cast<const void*>(f[0]);
    items.order[i] = reinterpret_cast<const int64_t*>(f[1]);
    items.offsets[i] = reinterpret_cast<const int64_t*>(f[2]);
    items.out[i] = reinterpret_cast<void*>(f[3]);
    items.width[i] = static_cast<int>(f[5]);
    items.slices[i] = static_cast<int>((f[5] + kSlice - 1) / kSlice);
    items.first[i] = units;
    units += f[4] * items.slices[i];
  }
  for (int i = n_items; i <= kMaxItems; ++i) items.first[i] = units;
  if (units == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (units + kWarps - 1) / kWarps;
  if (is_double) {
    const int grid = static_cast<int>(want < resident_blocks<double>() ? want : resident_blocks<double>());
    segment_sums_kernel<double><<<grid, kThreads, 0, s>>>(items);
  } else {
    const int grid = static_cast<int>(want < resident_blocks<float>() ? want : resident_blocks<float>());
    segment_sums_kernel<float><<<grid, kThreads, 0, s>>>(items);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brisk_add_latency(int is_double, int adds, void* cycles, void* sink, void* stream) {
  if (adds < 16 || adds % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* cyc = static_cast<long long*>(cycles);
  if (is_double) {
    add_latency_kernel<double><<<1, 1, 0, s>>>(1.0, 1e-300, adds, cyc, static_cast<double*>(sink));
  } else {
    add_latency_kernel<float><<<1, 1, 0, s>>>(1.0f, 1e-30f, adds, cyc, static_cast<float*>(sink));
  }
  return static_cast<int>(cudaGetLastError());
}

// Gathers of the TPU gather probes on Hopper (kernels G1 and G2).
//
// G1, take_along_axis, replaces the Pallas probe kernels that gather with
// jnp.take_along_axis:
//   tools/bench_pallas_gather.py:120 pallas_rows, :145 pallas_lane;
//   tools/probes/probe_sublane_gather.py:62 sub_small, :91 sub_big,
//     :112 sub_u8;
//   tools/probes/probe_gather_formulations.py:101 sub_gather (which does
//     not trace in JAX; its intended function is sub_gather2's), :121
//     sub_gather2, :163 gather_big;
//   tools/probes/probe_sampler_blocks.py:84 lane_scaled, :111 f_sub,
//     :121 f_sub_big.
// With src viewed as (B, S, Ws) and idx and out as (B, R, W) (B = 1 for a
// 2-D call), it computes numpy's take_along_axis on int32 or uint8
// elements:
//   along rows:    out[b, i, j] = src[b, idx[b, i, j], j]   (Ws == W)
//   along columns: out[b, i, j] = src[b, i, idx[b, i, j]]   (S == R)
// The leading axis B makes the probes' block-local gathers (B blocks of S
// source rows each, e.g. sub_big's 128 blocks of 4096 rows) one launch.
//
// G2, point_gather, replaces tools/bench_pallas_gather.py:93
// pallas_2stage: out[i] = tab[r[i], c[i]].
//
// The TPU probes pin each source block in VMEM and gather in stages
// (cross-sublane row gather, then lane select) because Mosaic lowers only
// 2-D take_along_axis. A GPU thread loads its element straight from device
// memory through L2, so one thread per output element, with no staging.
//
// Bound: bytes. There is no arithmetic on the values: each output element
// reads a 4-byte index and one source element and writes one element. The
// least traffic is the index and output arrays plus the distinct 32-byte
// sectors of the source that the indices touch (probes/gather.py's
// *_bytes count them from the indices). The design keeps the index reads and output
// writes coalesced (neighbouring threads, neighbouring elements); source
// reads coalesce where neighbouring outputs share a source row (a row
// gather whose indices are equal along a row, as in pallas_rows) and are
// one sector per element otherwise.
//
// Indices are trusted to be in range (the probes make them so; the plain
// versions check it). Element counts are below 2^31 (the wrappers check),
// so index math is 32-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, bool kAlongRows>
__global__ void __launch_bounds__(kThreads) take_kernel(
    const T* __restrict__ src, const int32_t* __restrict__ idx, T* __restrict__ out,
    unsigned R, unsigned W, unsigned S, unsigned Ws, unsigned n) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const unsigned row = t / W;  // b * R + i
  const unsigned j = t - row * W;
  const unsigned k = (unsigned)idx[t];
  size_t s;
  if (kAlongRows) {
    const unsigned b = row / R;
    s = ((size_t)b * S + k) * Ws + j;
  } else {
    s = (size_t)row * Ws + k;
  }
  out[t] = src[s];
}

template <typename T>
cudaError_t launch_take(const void* src, const void* idx, void* out, bool along_rows,
                        unsigned R, unsigned W, unsigned S, unsigned Ws, unsigned n,
                        cudaStream_t stream) {
  const unsigned blocks = (n + kThreads - 1) / kThreads;
  if (along_rows) {
    take_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)src, (const int32_t*)idx, (T*)out, R, W, S, Ws, n);
  } else {
    take_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)src, (const int32_t*)idx, (T*)out, R, W, S, Ws, n);
  }
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads) point_gather_kernel(
    const int32_t* __restrict__ tab, const int32_t* __restrict__ r,
    const int32_t* __restrict__ c, int32_t* __restrict__ out, unsigned cols, unsigned n) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  out[t] = tab[(size_t)(unsigned)r[t] * cols + (unsigned)c[t]];
}

}  // namespace

// G1. elem_bytes is 4 (int32) or 1 (uint8); n = B * R * W output elements.
extern "C" int brisk_probe_take(const void* src, const void* idx, void* out, int elem_bytes,
                                int along_rows, int R, int W, int S, int Ws, int n,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    return (int)launch_take<int32_t>(src, idx, out, along_rows != 0, R, W, S, Ws, n, st);
  }
  if (elem_bytes == 1) {
    return (int)launch_take<uint8_t>(src, idx, out, along_rows != 0, R, W, S, Ws, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

// G2. tab is (rows, cols) int32; r, c and out hold n int32 elements.
extern "C" int brisk_probe_point_gather(const void* tab, const void* r, const void* c,
                                        void* out, int cols, int n, void* stream) {
  const unsigned blocks = ((unsigned)n + kThreads - 1) / kThreads;
  point_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)r, (const int32_t*)c, (int32_t*)out, cols, n);
  return (int)cudaGetLastError();
}

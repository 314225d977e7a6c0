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
//     :121 f_sub_big;
//   tools/probes/probe_mosaic_gather.py:20 probe (its six gathers and the
//     one-hot lane select, which is the gather of index column 0);
//   tools/probes/probe_mosaic_gather2.py:25 probe (taa1), :106 wide;
//   tools/probes/probe_mosaic_gather3.py:61 gather_big, :173 gather8;
//   tools/probes/probe_mosaic_gather4.py:35 gather_big.
// With src viewed as (B, S, Ws) and idx and out as (B, R, W) (B = 1 for a
// 2-D call), it computes numpy's take_along_axis on 4-byte (int32 or
// float32, moved as bits) or uint8 elements:
//   along rows:    out[b, i, j] = src[b, idx[b, i, j], j]        (Ws == W)
//   along columns: out[b, i, j] = src[b, i % S, idx[b, i, j]]    (R % S == 0)
// The leading axis B makes the probes' block-local gathers (B blocks of S
// source rows each, e.g. sub_big's 128 blocks of 4096 rows) one launch.
// Along columns, index rows may be a whole multiple of the source rows:
// every block of S index rows reads the same source (wide's 64 grid steps
// over one (256, 2432) block). A uint8 source may be widened to an int32
// output (gather8's src.astype(int32) before the gather).
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

template <typename Tin, typename Tout, bool kAlongRows>
__global__ void __launch_bounds__(kThreads) take_kernel(
    const Tin* __restrict__ src, const int32_t* __restrict__ idx, Tout* __restrict__ out,
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
    s = (size_t)(row % S) * Ws + k;
  }
  out[t] = (Tout)src[s];
}

template <typename Tin, typename Tout>
cudaError_t launch_take(const void* src, const void* idx, void* out, bool along_rows,
                        unsigned R, unsigned W, unsigned S, unsigned Ws, unsigned n,
                        cudaStream_t stream) {
  const unsigned blocks = (n + kThreads - 1) / kThreads;
  if (along_rows) {
    take_kernel<Tin, Tout, true><<<blocks, kThreads, 0, stream>>>(
        (const Tin*)src, (const int32_t*)idx, (Tout*)out, R, W, S, Ws, n);
  } else {
    take_kernel<Tin, Tout, false><<<blocks, kThreads, 0, stream>>>(
        (const Tin*)src, (const int32_t*)idx, (Tout*)out, R, W, S, Ws, n);
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

// G1. (src_bytes, out_bytes) is (4, 4) (int32 or float32), (1, 1) (uint8)
// or (1, 4) (uint8 widened to int32); n = B * R * W output elements.
extern "C" int brisk_probe_take(const void* src, const void* idx, void* out, int src_bytes,
                                int out_bytes, int along_rows, int R, int W, int S, int Ws,
                                int n, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool rows = along_rows != 0;
  if (src_bytes == 4 && out_bytes == 4) {
    return (int)launch_take<uint32_t, uint32_t>(src, idx, out, rows, R, W, S, Ws, n, st);
  }
  if (src_bytes == 1 && out_bytes == 1) {
    return (int)launch_take<uint8_t, uint8_t>(src, idx, out, rows, R, W, S, Ws, n, st);
  }
  if (src_bytes == 1 && out_bytes == 4) {
    return (int)launch_take<uint8_t, int32_t>(src, idx, out, rows, R, W, S, Ws, n, st);
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

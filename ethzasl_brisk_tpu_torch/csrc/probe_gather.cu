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
// every block of S index rows (a copy) reads the same source (wide's 64
// grid steps over one (256, 2432) block). A uint8 source may be widened to
// an int32 output (gather8's src.astype(int32) before the gather).
//
// Bound: bytes. There is no arithmetic on the values: the least traffic is
// the index and output arrays once plus the distinct 32-byte sectors of
// the source that the indices touch (probes/gather.py's *_bytes count them
// from the indices). A gather that loads each element straight from device
// memory pays a whole 32-byte sector of L2 traffic for each 4-byte element
// whose neighbours in the warp read other rows, which leaves L2, not the
// HBM, as the limit. The TPU probes pin whole source blocks in VMEM; an
// SM's 227 KB holds a slice of one. So G1 has three bodies, and
// probes/gather.py:take_plan picks one per call from its shape, as the
// measurements on an H100 ranked them (PERF.md), and cuts its grid. The
// kernels trust the plan: it never asks for more shared memory than a block
// may take, and it sends a call to a 16-byte move only where every pointer
// moved 16 bytes at a time is 16-byte aligned and the widths are whole
// 16-byte chunks.
//
// R, take_rows_kernel: row gathers from a staged column band. Serves the
//   block-local row gathers of 4096-row blocks, sub_big
//   (probe_sublane_gather.py:91), sub_gather and sub_gather2
//   (probe_gather_formulations.py:101, :121). A CTA owns (block b, 8
//   columns j0 .. j0 + 8) and first stages src[b, :, j0:j0+8] in shared
//   memory, 128 KB at S = 4096, one CTA an SM. Eight columns are one
//   32-byte sector of each index and output row, so each chunk a CTA loads
//   or stores is a whole sector: 4-column bands (two CTAs an SM) split
//   every sector between two CTAs and measured slower than direct loads,
//   and 16 columns would take 256 KB. A cluster of 2 or 4 CTAs holding 16
//   or 32 columns split by rows, read through distributed shared memory,
//   also measured slower (PERF.md). Column j of source row k goes to word
//   j * pitch + k (pitch = S rounded up to 8, plus 4), so the staging
//   stores of a warp's 16 rows x 2 chunks, and its gathers of 32 random
//   rows, spread over the 32 banks. Then the CTA serves its index rows: a
//   thread takes one 16-byte chunk of an index row, reads 4 words from 4
//   columns and stores 16 bytes. Each source element leaves device memory once and each index
//   and output sector moves whole, so the traffic is the bound's (a
//   one-sector-per-element gather moves 2.5 GB from L2 at sub_big for an
//   891 MB bound). CTAs are numbered band-fastest, so a block's bands run
//   together. Where blocks x bands give under two waves, the plan splits a
//   band's index rows across CTAs, each staging the band again from L2.
//   Blocks of more than 7256 rows (f_sub_big's 8192) do not fit a block's
//   shared memory in 8-column bands and go to D.
// L, take_lanes_kernel: lane gathers from staged source rows. Serves the
//   axis-1 gathers of 8 M outputs or more, gather_big
//   (probe_gather_formulations.py:163, probe_mosaic_gather4.py:35 at
//   131072 and 524288 rows) and lane_scaled (probe_sampler_blocks.py:84),
//   and wide (probe_mosaic_gather2.py:106), whose 64 copies of index rows
//   share one source. A CTA copies its source rows into shared memory with
//   16-byte cp.async and loads its 16-byte index chunks in the same breath,
//   so no source load waits for an index; each thread then gathers 4
//   outputs from shared memory and stores them at once. On a source of its
//   own a CTA takes 16 rows of 128, two chunks a thread. On a shared source
//   a CTA keeps 20 KB of source rows and walks its share of the copies, so
//   the source leaves L2 about five times in all instead of once per index
//   row.
// D, take_direct_kernel: every other call: pallas_rows and pallas_lane
//   (bench_pallas_gather.py:120, :145), sub_small and sub_u8
//   (probe_sublane_gather.py:62, :112), f_sub and f_sub_big
//   (probe_sampler_blocks.py:111, :121), probe (probe_mosaic_gather.py:20),
//   taa1 (probe_mosaic_gather2.py:25), gather_big and gather8
//   (probe_mosaic_gather3.py:61, :173) and gather_big at 16384 rows
//   (probe_mosaic_gather4.py:35): a 1-D index, global rows, tables small
//   enough for L2 to serve, rows or blocks too large to stage, and any call
//   with unaligned pointers or widths no multiple of 4. With 1 M outputs or
//   more, and index and output rows of whole aligned 16-byte chunks, 4
//   outputs a thread from one 16-byte index load and one store; below
//   that, one output a thread, which keeps every SM busy on small tables.
//
// G2, point_gather, replaces tools/bench_pallas_gather.py:93
// pallas_2stage (body k_2stage, :82): out[i] = tab[r[i], c[i]]. At the
// probe's size r, c and out stream 24 MB from and to device memory, and the
// table, 1.25 MB, sits in L2; the 2 M taps come in clusters of 2048 within
// +-64 pixels of a centre, and the TPU grid walks one cluster a block. Each
// table load fetches a 32-byte sector for 4 bytes. Two bodies, picked per
// call by probes/gather.py:point_plan:
// V, point_gather4_kernel, where r, c and out are 16-byte aligned: a CTA
//   of 512 threads serves one run of 2048 taps (the TPU's block), a thread
//   four of them: 16-byte loads of r and c, four table loads in flight
//   together through the read-only path, one 16-byte store. r, c and out,
//   touched once, move with the streaming (evict-first) hint, and the run's
//   table sectors meet in L1: the same body with its table loads kept out
//   of L1 (L2 only, or no L1 allocation) ran 1.4x slower. The first
//   threads of CTA 0 serve the last n % 4 taps one a thread. Measured on
//   an H100 (PERF.md §6): 0.0152 ms at site 1 against 0.0179 for S; a
//   persistent grid that loads the next run's r and c while the current
//   run's table loads are in flight (0.0160), 256 threads x 8 taps (0.0172)
//   and the whole table in the distributed shared memory of 8-CTA clusters
//   (0.064) lost; plain read-only loads of r and c tie.
// S, point_gather_kernel, everywhere else: a thread a tap (the first design).
//
// Indices are trusted to be in range (the probes make them so; the plain
// versions check it). Element counts are below 2^31 (the wrappers check),
// so index math is 32-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;      // D and G2's S
constexpr int kPointThreads = 512; // G2's V: a run of 2048 taps a CTA
constexpr int kPointTaps = 4;      // G2's V: taps a thread
constexpr int kRowThreads = 512;   // R, at most
constexpr int kLaneThreads = 256;  // L, at most
constexpr int kStageLoads = 8;     // R: 16-byte staging loads in flight a thread
constexpr int kChunkLoads = 4;     // R and L: 16-byte index loads in flight a thread
constexpr int kBand = 8;           // R: columns a band, one 32-byte sector of a row
enum Body { kDirect = 0, kRows = 1, kLanes = 2 };

// Words between two staged columns of R (probes/gather.py:_pitch).
__host__ __device__ constexpr int band_pitch(int S) { return ((S + 7) & ~7) + 4; }

// Four gathered elements to out[0 .. 3] in one store (16 bytes, or 4 for uint8).
__device__ __forceinline__ void store4(uint32_t* out, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  *reinterpret_cast<uint4*>(out) = make_uint4(a, b, c, d);
}
__device__ __forceinline__ void store4(uint8_t* out, uint8_t a, uint8_t b, uint8_t c,
                                       uint8_t d) {
  *reinterpret_cast<uchar4*>(out) = make_uchar4(a, b, c, d);
}

template <typename Tin, typename Tout, bool kAlongRows, bool kVector>
__global__ void __launch_bounds__(kThreads) take_direct_kernel(
    const Tin* __restrict__ src, const int32_t* __restrict__ idx, Tout* __restrict__ out,
    unsigned R, unsigned W, unsigned S, unsigned Ws, unsigned n) {
  constexpr unsigned kPer = kVector ? 4 : 1;
  const unsigned e = (blockIdx.x * blockDim.x + threadIdx.x) * kPer;
  if (e >= n) return;
  const unsigned row = e / W;  // b * R + i
  const unsigned j = e - row * W;
  // Along rows, source element (k, j) of block b is base + k * Ws; along
  // columns, element k of row i % S is base + k.
  const size_t base = kAlongRows ? (size_t)(row / R) * S * Ws + j : (size_t)(row % S) * Ws;
  const size_t step = kAlongRows ? Ws : 1;
  const size_t lane = kAlongRows ? 1 : 0;  // the next output's column, along rows
  if (!kVector) {
    out[e] = (Tout)src[base + (size_t)(unsigned)idx[e] * step];
    return;
  }
  const int4 k = __ldg(reinterpret_cast<const int4*>(idx + e));
  store4(out + e, (Tout)src[base + (size_t)(unsigned)k.x * step],
         (Tout)src[base + lane + (size_t)(unsigned)k.y * step],
         (Tout)src[base + 2 * lane + (size_t)(unsigned)k.z * step],
         (Tout)src[base + 3 * lane + (size_t)(unsigned)k.w * step]);
}

__global__ void __launch_bounds__(kRowThreads) take_rows_kernel(
    const uint32_t* __restrict__ src, const int32_t* __restrict__ idx,
    uint32_t* __restrict__ out, int R, int W, int S, int splits, int rows) {
  extern __shared__ __align__(16) uint32_t band[];
  constexpr int kChunks = kBand / 4;  // 16-byte chunks in a band's row
  const int bands = W / kBand;
  const int pitch = band_pitch(S);
  const int T = blockDim.x;
  const int w4 = W / 4;
  int u = blockIdx.x;
  const int j0 = (u % bands) * kBand;
  u /= bands;
  const int i0 = (u % splits) * rows;
  const int b = u / splits;

  // Stage src[b, :, j0:j0+kBand]: column j of source row k at band[j * pitch + k].
  const uint4* s4 = reinterpret_cast<const uint4*>(src + (size_t)b * S * W + j0);
  const int staged = S * kChunks;
  for (int x0 = threadIdx.x; x0 < staged; x0 += kStageLoads * T) {
    uint4 v[kStageLoads];
#pragma unroll
    for (int m = 0; m < kStageLoads; ++m) {
      const int x = x0 + m * T;
      if (x < staged) v[m] = __ldg(s4 + (size_t)(x / kChunks) * w4 + x % kChunks);
    }
#pragma unroll
    for (int m = 0; m < kStageLoads; ++m) {
      const int x = x0 + m * T;
      if (x < staged) {
        uint32_t* p = band + (x % kChunks) * 4 * pitch + x / kChunks;
        p[0] = v[m].x;
        p[pitch] = v[m].y;
        p[2 * pitch] = v[m].z;
        p[3 * pitch] = v[m].w;
      }
    }
  }
  __syncthreads();

  // Serve index rows i0 .. i0 + rows of block b, one 16-byte chunk a thread.
  const int n = (min(R, i0 + rows) - i0) * kChunks;
  const size_t first = ((size_t)b * R + i0) * W + j0;
  const int4* idx4 = reinterpret_cast<const int4*>(idx + first);
  uint4* out4 = reinterpret_cast<uint4*>(out + first);
  for (int x0 = threadIdx.x; x0 < n; x0 += kChunkLoads * T) {
    int4 k[kChunkLoads];
#pragma unroll
    for (int m = 0; m < kChunkLoads; ++m) {
      const int x = x0 + m * T;
      if (x < n) k[m] = __ldg(idx4 + (size_t)(x / kChunks) * w4 + x % kChunks);
    }
#pragma unroll
    for (int m = 0; m < kChunkLoads; ++m) {
      const int x = x0 + m * T;
      if (x < n) {
        const uint32_t* p = band + (x % kChunks) * 4 * pitch;
        out4[(size_t)(x / kChunks) * w4 + x % kChunks] = make_uint4(
            p[k[m].x], p[pitch + k[m].y], p[2 * pitch + k[m].z], p[3 * pitch + k[m].w]);
      }
    }
  }
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kLaneThreads) take_lanes_kernel(
    const Tin* __restrict__ src, const int32_t* __restrict__ idx, Tout* __restrict__ out,
    int W, int S, int Ws, int rows, int groups, int copies, int copies_per_cta) {
  extern __shared__ __align__(16) unsigned char staged[];
  const Tin* srow = reinterpret_cast<const Tin*>(staged);
  const int T = blockDim.x;
  const int s0 = (blockIdx.x % groups) * rows;
  const int c0 = (blockIdx.x / groups) * copies_per_cta;
  const int nrows = min(rows, S - s0);

  // Source rows s0 .. s0 + nrows: one run of 16-byte chunks, in flight
  // while the first index chunks load.
  const int chunks = nrows * Ws * (int)sizeof(Tin) / 16;
  const uint4* g = reinterpret_cast<const uint4*>(src + (size_t)s0 * Ws);
  for (int x = threadIdx.x; x < chunks; x += T) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(staged + 16 * x);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(g + x));
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // Chunk y of the CTA: copy c0 + y / per_copy, and within it the chunk
  // y % per_copy of rows s0 .. s0 + nrows, which lie together in idx and out.
  const int w4 = W / 4;
  const int per_copy = nrows * w4;
  const int n = (min(copies, c0 + copies_per_cta) - c0) * per_copy;
  auto at = [&](int y) { return ((size_t)(c0 + y / per_copy) * S + s0) * w4 + y % per_copy; };
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4 k[kChunkLoads];
  auto load = [&](int y0) {
#pragma unroll
    for (int m = 0; m < kChunkLoads; ++m) {
      const int y = y0 + m * T;
      if (y < n) k[m] = __ldg(idx4 + at(y));
    }
  };
  load(threadIdx.x);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int y0 = threadIdx.x; y0 < n; y0 += kChunkLoads * T) {
    if (y0 != (int)threadIdx.x) load(y0);
#pragma unroll
    for (int m = 0; m < kChunkLoads; ++m) {
      const int y = y0 + m * T;
      if (y < n) {
        const Tin* r = srow + (size_t)((y % per_copy) / w4) * Ws;
        store4(out + 4 * at(y), (Tout)r[k[m].x], (Tout)r[k[m].y], (Tout)r[k[m].z],
               (Tout)r[k[m].w]);
      }
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_take(const void* src_, const void* idx_, void* out_, bool along_rows, int R,
                        int W, int S, int Ws, int n, int body, bool vector, int rows, int copies,
                        int smem, int grid, int threads, cudaStream_t st) {
  const Tin* src = (const Tin*)src_;
  const int32_t* idx = (const int32_t*)idx_;
  Tout* out = (Tout*)out_;
  const unsigned u[] = {(unsigned)R, (unsigned)W, (unsigned)S, (unsigned)Ws, (unsigned)n};
  if (body == kDirect) {
    if (along_rows && vector)
      return launch(take_direct_kernel<Tin, Tout, true, true>, grid, threads, 0, st, src, idx,
                    out, u[0], u[1], u[2], u[3], u[4]);
    if (along_rows)
      return launch(take_direct_kernel<Tin, Tout, true, false>, grid, threads, 0, st, src, idx,
                    out, u[0], u[1], u[2], u[3], u[4]);
    if (vector)
      return launch(take_direct_kernel<Tin, Tout, false, true>, grid, threads, 0, st, src, idx,
                    out, u[0], u[1], u[2], u[3], u[4]);
    return launch(take_direct_kernel<Tin, Tout, false, false>, grid, threads, 0, st, src, idx,
                  out, u[0], u[1], u[2], u[3], u[4]);
  }
  if (body == kLanes && !along_rows) {
    return launch(take_lanes_kernel<Tin, Tout>, grid, threads, smem, st, src, idx, out, W, S,
                  Ws, rows, (S + rows - 1) / rows, R / S, copies);
  }
  if constexpr (sizeof(Tin) == 4 && sizeof(Tout) == 4) {
    if (body == kRows && along_rows) {
      return launch(take_rows_kernel, grid, threads, smem, st, src, idx, out, R, W, S,
                    (R + rows - 1) / rows, rows);
    }
  }
  return cudaErrorInvalidValue;
}

__global__ void __launch_bounds__(kThreads) point_gather_kernel(
    const int32_t* __restrict__ tab, const int32_t* __restrict__ r,
    const int32_t* __restrict__ c, int32_t* __restrict__ out, unsigned cols, unsigned n) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  out[t] = tab[(size_t)(unsigned)r[t] * cols + (unsigned)c[t]];
}

__device__ __forceinline__ int32_t tap(const int32_t* __restrict__ tab, unsigned cols, int r,
                                       int c) {
  return __ldg(tab + (size_t)(unsigned)r * cols + (unsigned)c);
}

__global__ void __launch_bounds__(kPointThreads) point_gather4_kernel(
    const int32_t* __restrict__ tab, const int32_t* __restrict__ r,
    const int32_t* __restrict__ c, int32_t* __restrict__ out, unsigned cols, unsigned n) {
  const unsigned quads = n / kPointTaps;
  const unsigned q = blockIdx.x * kPointThreads + threadIdx.x;
  if (q < quads) {
    const int4 rr = __ldcs(reinterpret_cast<const int4*>(r) + q);
    const int4 cc = __ldcs(reinterpret_cast<const int4*>(c) + q);
    __stcs(reinterpret_cast<int4*>(out) + q,
           make_int4(tap(tab, cols, rr.x, cc.x), tap(tab, cols, rr.y, cc.y),
                     tap(tab, cols, rr.z, cc.z), tap(tab, cols, rr.w, cc.w)));
  }
  const unsigned t = quads * kPointTaps + threadIdx.x;
  if (blockIdx.x == 0 && t < n) out[t] = tap(tab, cols, r[t], c[t]);
}

}  // namespace

// G1. (src_bytes, out_bytes) is (4, 4) (int32 or float32), (1, 1) (uint8)
// or (1, 4) (uint8 widened to int32); n = B * R * W output elements. The
// rest is probes/gather.py's TakePlan: body (0 D, 1 R, 2 L), vector (D),
// rows (R: index rows a CTA; L: source rows a CTA), copies (L: copies a
// CTA), dynamic shared memory, grid and block.
extern "C" int brisk_probe_take(const void* src, const void* idx, void* out, int src_bytes,
                                int out_bytes, int along_rows, int R, int W, int S, int Ws,
                                int n, int body, int vector, int rows, int copies, int smem,
                                int grid, int threads, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool by_rows = along_rows != 0, vec = vector != 0;
  if (src_bytes == 4 && out_bytes == 4) {
    return (int)launch_take<uint32_t, uint32_t>(src, idx, out, by_rows, R, W, S, Ws, n, body,
                                                vec, rows, copies, smem, grid, threads,
                                                st);
  }
  if (src_bytes == 1 && out_bytes == 1) {
    return (int)launch_take<uint8_t, uint8_t>(src, idx, out, by_rows, R, W, S, Ws, n, body,
                                              vec, rows, copies, smem, grid, threads, st);
  }
  if (src_bytes == 1 && out_bytes == 4) {
    return (int)launch_take<uint8_t, uint32_t>(src, idx, out, by_rows, R, W, S, Ws, n, body,
                                               vec, rows, copies, smem, grid, threads,
                                               st);
  }
  return (int)cudaErrorInvalidValue;
}

// G2. tab is (rows, cols) int32; r, c and out hold n int32 elements. The
// rest is probes/gather.py's PointPlan: vector (V, else S) and grid.
extern "C" int brisk_probe_point_gather(const void* tab, const void* r, const void* c,
                                        void* out, int cols, int n, int vector, int grid,
                                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* t = (const int32_t*)tab;
  const int32_t *rr = (const int32_t*)r, *cc = (const int32_t*)c;
  int32_t* o = (int32_t*)out;
  if (vector) {
    return (int)launch(point_gather4_kernel, grid, kPointThreads, 0, st, t, rr, cc, o,
                       (unsigned)cols, (unsigned)n);
  }
  return (int)launch(point_gather_kernel, grid, kThreads, 0, st, t, rr, cc, o, (unsigned)cols,
                     (unsigned)n);
}

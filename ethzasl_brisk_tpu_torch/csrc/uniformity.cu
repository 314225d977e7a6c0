// Greedy keypoint uniformity, every layer of every frame of a detection in
// one launch (enforce_uniformity).
//
// Replaces no TPU kernel: the JAX package does this stage in XLA
// (ethzasl_brisk_tpu/detect/uniformity.py:69-318). Its production form,
// enforce_uniformity, is a blocked interval-bound fixpoint that exists
// because scattering 31 x 31 paint patches was slow on the TPU; its oracle,
// enforce_uniformity_sequential, is the reference's greedy loop
// (uniformity-enforcement-inl.h:44-194). This kernel computes the oracle's
// mask bit for bit, so the blocked form's too (the JAX tests hold the two
// equal).
//
// The semantics. A problem is one (frame, layer): K score-sorted candidates
// (x, y, an int32 or float32 score, a valid flag) and a cap. Their cells
// and normalised scores are detect/uniformity.py's _cells, computed here:
// nsc1 = sqrtf(sqrtf(score / max)) * 255 with max the problem's first score,
// cx = (int)((float)x * scaling + 16) with scaling = float32(15 / radius),
// cy alike. Candidate i is accepted iff it is valid, fewer than cap were
// accepted before it, and !(nsc1[i] < occ(i)), where occ(i) is the
// reference's saturating uint8 occupancy grid at (cy_i, cx_i) after the
// accepted j < i painted it: paint_j(cell) = ceil(lut[cy - cy_j + 15][cx -
// cx_j + 15] * (0.99f * nsc1[j])) inside the 31 x 31 patch.
//
// Design. One CTA of kThreads a problem, layer 0's CTAs first in blockIdx
// order (they run longest). A prologue stages each candidate's cell and
// test value (nsc1, or -inf where not valid, so the test needs no flag).
// A rejected candidate changes nothing, so the greedy is a sequence of
// rounds: from the candidate after the last accept, each thread tests one
// candidate of a window of kThreads; a ballot a warp and a min over the
// warps' slots find the first that passes; the ones before it in the window
// are rejected, as the sequential loop rejects them; the accepted one is
// painted, a barrier, and the next round starts after it. A window with no
// accept advances by kThreads. So rounds = accepts + (K - accepts) /
// kThreads or fewer. Two routes, chosen per layer on the host from the
// layer's shape, the radius and K:
//
// * grid: the layer's occupancy grid lies in shared memory as the
//   reference's uint8, (cy_max + 16) x (cx_max + 16) bytes. A round reads
//   each tested candidate's cell; an accept paints its patch with saturating
//   adds, 961 cells over the CTA (two a thread at 512 threads, each thread's
//   LUT taps and offsets kept in registers), whatever K is. The staged cells
//   (the grid offset cy * width + cx) and test values lie in shared memory
//   behind the grid, or in a scratch buffer the wrapper gives (which the
//   wrapper picks: launch_staging). An accept marks its staged cell, and
//   the mask is written after the rounds: the mask's byte stored in the
//   round cost the round ~400 cycles on the card, and a warp a problem
//   lost to a CTA a problem (PERF.md, section 6).
// * candidates: where the grid does not fit (a small radius on a large
//   layer), each candidate keeps its own occupancy occ(i) = min(255, sum of
//   paint_j(cell_i)) over the accepted j < i; the reference's uint8
//   saturating adds commute into that clipped sum because paints are
//   non-negative. An accept paints every later candidate in its patch
//   (occ[q] = min(255, occ[q] + paint)). cx, cy, the test value and occ lie
//   in shared memory (13 bytes a candidate, up to kMaxSharedCandidates), or
//   in the scratch buffer; the 31 x 31 LUT is staged in shared memory.
//
// Both routes give the mask bit for bit. Nothing is read back to the host:
// the launch takes every layer's pointers, problem count, K, cap and grid
// extent by value.
//
// Arithmetic as the oracle's: IEEE division and square roots, int32 to
// float32 rounding to nearest, __fmul_rn for 0.99f * nsc1 and for the LUT
// product, ceilf, the test in float32; built with --fmad=false. A valid
// candidate's cell is clamped into the grid (a no-op for candidates inside
// the layer, as a detection gives them), so no input writes outside it.
//
// Bound: bytes (each candidate's x, y, score and valid read once, the mask
// written once) or, larger here, the chain: the longest CTA's rounds times
// one round's dependent latency (a shared-memory read, the ballot, the
// reduction, a barrier), which the round-latency probe
// (brisk_round_latency) measures on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 512;  // the window: candidates tested a round
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kFields = 12;  // a host layer: xs, ys, scores, valid, accept, scratch, problems, K,
                             // cap, int scores, grid rows, grid cols
constexpr int kLut = 31 * 31;
constexpr int kMaxShared = 232448;  // a CTA's shared memory on Hopper
// The candidates route: the LUT and two sets of warp slots, then cx, cy
// (int32), the test value (float32) and occ (uint8) a candidate.
constexpr int kFixedShared = kLut * 4 + 2 * kWarps * 4;
constexpr int kSharedBytesPerCandidate = 13;
constexpr int kMaxSharedCandidates = (kMaxShared - kFixedShared) / kSharedBytesPerCandidate;
// The grid route: two sets of warp slots (index, cell, value), rounded up
// to 16 bytes, the grid (its bytes rounded up to 16), then the cell and
// test value a candidate where they fit.
constexpr int kGridFixedShared = (2 * 3 * kWarps * 4 + 15) / 16 * 16;
constexpr int kGridStagedBytesPerCandidate = 8;
constexpr int kMaxGridBytes = kMaxShared - kGridFixedShared;  // the route threshold
constexpr int kScratchBytesPerCandidate = 13;  // cx (or cell), cy, value, occ
constexpr int kPaintCells = (kLut + kThreads - 1) / kThreads;  // a thread's cells of a patch
constexpr int kStageUnroll = 4;  // candidates a thread stages at once
static_assert(kWarps >= 1 && kWarps <= 32 && (kThreads & (kThreads - 1)) == 0,
              "a power-of-two CTA of 1 to 32 warps: the slots are reduced by one warp");

// Every layer of the launch, by value in the kernel's parameters.
// scratch[l] null: the layer's problems stage in shared memory, else each
// problem's cx (or cell), cy, value and occ lie there (13 bytes a
// candidate, four arrays over the layer's problems). gw[l] 0: the
// candidates route.
struct Layers {
  const int* xs[kMaxLayers];
  const int* ys[kMaxLayers];
  const void* scores[kMaxLayers];
  const unsigned char* valid[kMaxLayers];
  unsigned char* accept[kMaxLayers];
  unsigned char* scratch[kMaxLayers];
  int k[kMaxLayers];
  int cap[kMaxLayers];
  int int_scores[kMaxLayers];
  int gh[kMaxLayers];
  int gw[kMaxLayers];
  int problems[kMaxLayers];
  int first[kMaxLayers + 1];  // layer l's first CTA; first[n_layers..] the total
  float scaling;
  const float* lut;
  int* rounds;  // each CTA's rounds, or null
};

// a[l] with constant indices only, so the parameters are not copied to
// local memory for a dynamic index.
template <typename X>
__device__ __forceinline__ X pick(const X (&a)[kMaxLayers], int l) {
  X r = a[0];
#pragma unroll
  for (int i = 1; i < kMaxLayers; ++i) {
    if (i == l) r = a[i];
  }
  return r;
}

__device__ __forceinline__ float score_at(const void* scores, bool is_int, long long i) {
  return is_int ? __int2float_rn(static_cast<const int*>(scores)[i])
                : static_cast<const float*>(scores)[i];
}

// _cells' arithmetic: the cell of coordinate v.
__device__ __forceinline__ int cell_of(int v, float scaling) {
  return static_cast<int>(__fadd_rn(__fmul_rn(__int2float_rn(v), scaling), 16.0f));
}

// A candidate's test value: nsc1 where valid, -inf (never passes) where not.
__device__ __forceinline__ float test_value(float s, float max_score, bool valid) {
  const float nsc = __fmul_rn(__fsqrt_rn(__fsqrt_rn(__fdiv_rn(s, max_score))), 255.0f);
  return valid ? nsc : -__int_as_float(0x7f800000);
}

// One paint of the saturating uint8 occupancy: o + ceil(lut * pn), at 255.
__device__ __forceinline__ unsigned char painted(unsigned char o, float lut, float pn) {
  const int v = o + static_cast<int>(ceilf(__fmul_rn(lut, pn)));
  return static_cast<unsigned char>(v < 255 ? v : 255);
}

// The first passing window position of the CTA, from each warp's ballot:
// lane 0 of each warp writes its first passing position (or kThreads) to
// the warp's slot, a barrier, and every thread reduces the slots.
__device__ __forceinline__ int first_pass(unsigned ballot, int* s, int lane, int warp) {
  if (lane == 0) s[warp] = ballot ? warp * 32 + __ffs(ballot) - 1 : kThreads;
  __syncthreads();
  return __reduce_min_sync(0xffffffffu, lane < kWarps ? s[lane] : kThreads);
}

// The grid route of one problem (the file's comment).
__device__ __forceinline__ int grid_route(unsigned char* smem, const int* xs, const int* ys,
                                          const void* scores, bool is_int,
                                          const unsigned char* valid, unsigned char* accept,
                                          int* g_cell, float* g_val, int K, int cap, int gh,
                                          int gw, float scaling, const float* g_lut) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* slots = reinterpret_cast<int*>(smem);  // [parity][index, cell, value][warp]
  const int grid_bytes = (gh * gw + 15) & ~15;
  unsigned char* grid = smem + kGridFixedShared;
  int* cell = g_cell;
  float* val = g_val;
  if (cell == nullptr) {
    cell = reinterpret_cast<int*>(grid + grid_bytes);
    val = reinterpret_cast<float*>(cell + K);
  }
  for (int i = tid; i < grid_bytes / 16; i += kThreads) {
    reinterpret_cast<uint4*>(grid)[i] = make_uint4(0, 0, 0, 0);
  }
  const float max_score = score_at(scores, is_int, 0);
  for (int i0 = tid; i0 < K; i0 += kThreads * kStageUnroll) {  // all loads first
    int x[kStageUnroll], y[kStageUnroll];
    float sc[kStageUnroll];
    bool v[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < K && valid[i];
      x[u] = i < K ? xs[i] : 0;
      y[u] = i < K ? ys[i] : 0;
      sc[u] = i < K ? score_at(scores, is_int, i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < K) {
        val[i] = test_value(sc[u], max_score, v[u]);
        const int cx = min(max(cell_of(x[u], scaling), 15), gw - 16);
        const int cy = min(max(cell_of(y[u], scaling), 15), gh - 16);
        cell[i] = v[u] ? cy * gw + cx : 0;
      }
    }
  }
  // This thread's cells of a patch, tid + q * kThreads, as offsets from
  // the patch's centre and LUT values (past the patch: tap 0, the centre).
  float tap[kPaintCells];
  int rel[kPaintCells];
#pragma unroll
  for (int q = 0; q < kPaintCells; ++q) {
    const int c = tid + q * kThreads;
    tap[q] = c < kLut ? g_lut[c] : 0.0f;
    rel[q] = c < kLut ? (c / 31 - 15) * gw + c % 31 - 15 : 0;
  }
  __syncthreads();

  int cursor = 0, n_acc = 0, rounds = 0, parity = 0;
  while (cursor < K && n_acc < cap) {
    ++rounds;
    const int i = cursor + tid;
    bool ok = false;
    int c = 0;
    float nv = 0.0f;
    if (i < K) {
      c = cell[i];
      nv = val[i];
      ok = !(nv < static_cast<float>(grid[c]));
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    int* s = slots + parity * 3 * kWarps;  // two sets: a round reads one while the next writes the other
    if (ballot && lane == __ffs(ballot) - 1) {  // the warp's first passing candidate
      s[kWarps + warp] = c;
      s[2 * kWarps + warp] = __float_as_int(nv);
    }
    const int m = first_pass(ballot, s, lane, warp);
    parity ^= 1;
    if (m == kThreads) {  // no accept in the window: the grid is unchanged
      cursor += kThreads;
      continue;
    }
    const int j = cursor + m;
    ++n_acc;
    // The accept marks its staged cell negative (no later round reads it),
    // and the mask is written after the rounds.
    if (tid == m) cell[i] = ~c;
    const int jc = s[kWarps + (m >> 5)];
    const float pn = __fmul_rn(0.99f, __int_as_float(s[2 * kWarps + (m >> 5)]));
    // The patch's cells are distinct, so every read (unconditional: each
    // lies in the grid) may go before every write. A zero LUT tap paints 0
    // whatever pn is (ceil of 0 or NaN converts to 0).
    unsigned char old[kPaintCells];
#pragma unroll
    for (int q = 0; q < kPaintCells; ++q) old[q] = grid[jc + rel[q]];
#pragma unroll
    for (int q = 0; q < kPaintCells; ++q) {
      if (tap[q] > 0.0f) grid[jc + rel[q]] = painted(old[q], tap[q], pn);
    }
    __syncthreads();
    cursor = j + 1;
  }
  __syncthreads();
  for (int i = tid; i < K; i += kThreads) accept[i] = cell[i] < 0;
  return rounds;
}

// The candidates route of one problem (the file's comment).
__device__ __forceinline__ int candidates_route(unsigned char* smem, const int* xs,
                                                const int* ys, const void* scores, bool is_int,
                                                const unsigned char* valid,
                                                unsigned char* accept, int* g_cx, int* g_cy,
                                                float* g_val, unsigned char* g_occ, int K,
                                                int cap, float scaling, const float* g_lut) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* lut = reinterpret_cast<float*>(smem);
  int* slots = reinterpret_cast<int*>(smem + kLut * 4);
  for (int i = tid; i < kLut; i += kThreads) lut[i] = g_lut[i];
  int* cx = g_cx;
  int* cy = g_cy;
  float* val = g_val;
  unsigned char* occ = g_occ;
  if (cx == nullptr) {
    cx = reinterpret_cast<int*>(smem + kFixedShared);
    cy = cx + K;
    val = reinterpret_cast<float*>(cy + K);
    occ = reinterpret_cast<unsigned char*>(val + K);
  }
  const float max_score = score_at(scores, is_int, 0);
  for (int i = tid; i < K; i += kThreads) {
    val[i] = test_value(score_at(scores, is_int, i), max_score, valid[i]);
    cx[i] = cell_of(xs[i], scaling);
    cy[i] = cell_of(ys[i], scaling);
    occ[i] = 0;
    accept[i] = 0;
  }
  __syncthreads();

  int cursor = 0, n_acc = 0, rounds = 0, parity = 0;
  while (cursor < K && n_acc < cap) {
    ++rounds;
    const int i = cursor + tid;
    const bool ok = i < K && !(val[i] < static_cast<float>(occ[i]));
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    const int m = first_pass(ballot, slots + parity * kWarps, lane, warp);
    parity ^= 1;
    if (m == kThreads) {  // no accept in the window: occ is unchanged
      cursor += kThreads;
      continue;
    }
    const int j = cursor + m;
    ++n_acc;
    if (tid == 0) accept[j] = 1;
    const float pn = __fmul_rn(0.99f, val[j]);
    const int jx = cx[j], jy = cy[j];
#pragma unroll 4
    for (int q = j + 1 + tid; q < K; q += kThreads) {
      const int dx = cx[q] - jx + 15, dy = cy[q] - jy + 15;
      if (static_cast<unsigned>(dx) < 31u && static_cast<unsigned>(dy) < 31u) {
        occ[q] = painted(occ[q], lut[dy * 31 + dx], pn);
      }
    }
    __syncthreads();
    cursor = j + 1;
  }
  return rounds;
}

__global__ void __launch_bounds__(kThreads) uniformity_kernel(Layers L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  int l = 0, start = 0;  // the CTA's layer and that layer's first CTA
#pragma unroll
  for (int i = 1; i < kMaxLayers; ++i) {
    if (b >= L.first[i]) {
      l = i;
      start = L.first[i];
    }
  }
  const int K = pick(L.k, l);
  const int cap = pick(L.cap, l);
  const int gw = pick(L.gw, l);
  const bool is_int = pick(L.int_scores, l) != 0;
  const long long base = static_cast<long long>(b - start) * K;
  const long long layer_k = static_cast<long long>(pick(L.problems, l)) * K;
  const int* xs = pick(L.xs, l) + base;
  const int* ys = pick(L.ys, l) + base;
  const void* scores = is_int ? static_cast<const void*>(static_cast<const int*>(pick(L.scores, l)) + base)
                              : static_cast<const void*>(static_cast<const float*>(pick(L.scores, l)) + base);
  const unsigned char* valid = pick(L.valid, l) + base;
  unsigned char* accept = pick(L.accept, l) + base;
  unsigned char* scratch = pick(L.scratch, l);
  // The scratch's four arrays over the layer's problems, at this problem.
  int* s_a = nullptr;
  int* s_b = nullptr;
  float* s_val = nullptr;
  unsigned char* s_occ = nullptr;
  if (scratch != nullptr) {
    s_a = reinterpret_cast<int*>(scratch) + base;
    s_b = reinterpret_cast<int*>(scratch) + layer_k + base;
    s_val = reinterpret_cast<float*>(scratch) + 2 * layer_k + base;
    s_occ = scratch + 12 * layer_k + base;
  }
  int rounds;
  if (gw > 0) {
    rounds = grid_route(smem, xs, ys, scores, is_int, valid, accept, s_a, s_val, K, cap,
                        pick(L.gh, l), gw, L.scaling, L.lut);
  } else {
    rounds = candidates_route(smem, xs, ys, scores, is_int, valid, accept, s_a, s_b, s_val,
                              s_occ, K, cap, L.scaling, L.lut);
  }
  if (L.rounds != nullptr && threadIdx.x == 0) L.rounds[b] = rounds;
}

// The round-latency probe: one CTA of kThreads making `rounds` rounds with
// no accept, each a shared-memory read at the cursor, the ballot, the slot
// write, a barrier and the reduction, the next cursor depending on the
// reduction; thread 0 times them by the SM's clock.
__global__ void __launch_bounds__(kThreads) round_latency_kernel(int rounds, long long* cycles,
                                                                 int* sink) {
  __shared__ int slots[2 * kWarps];
  __shared__ unsigned char occ[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  occ[tid] = static_cast<unsigned char>(tid % 200);  // never 255: no window accepts
  __syncthreads();
  int cursor = 0, parity = 0;
  const long long t0 = clock64();
  for (int r = 0; r < rounds; ++r) {
    const bool ok = occ[(cursor + tid) & (kThreads - 1)] == 255;
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    const int m = first_pass(ballot, slots + parity * kWarps, lane, warp);
    parity ^= 1;
    cursor += m - kThreads + 1;
  }
  const long long t1 = clock64();
  if (tid == 0) {
    cycles[0] = t1 - t0;
    sink[0] = cursor;
  }
}

}  // namespace

// layers: n_layers x kFields int64 (xs, ys, scores, valid, accept and
// scratch pointers, problems, K, cap, int scores, grid rows, grid cols);
// grid cols 0 is the candidates route; scratch 0 stages in shared memory.
// scaling: float32(15 / radius). lut: the 31 x 31 float32 LUT on the card.
// rounds: an int32 a CTA (the problems in layer order), or null.
extern "C" int brisk_enforce_uniformity(const void* host_layers, int n_layers, float scaling,
                                        const void* lut, void* rounds, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* f = static_cast<const int64_t*>(host_layers);
  Layers L = {};
  long long blocks = 0, smem = 0;
  for (int l = 0; l < n_layers; ++l, f += kFields) {
    const int64_t problems = f[6], k = f[7], gh = f[10], gw = f[11];
    if (problems < 0 || problems >= (1LL << 31) || k < 0 || k >= (1LL << 31) || f[8] < 0 ||
        gh < 0 || gw < 0 || (gw > 0 && (gh < 31 || gw < 31 || gh * gw > kMaxGridBytes))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.xs[l] = reinterpret_cast<const int*>(f[0]);
    L.ys[l] = reinterpret_cast<const int*>(f[1]);
    L.scores[l] = reinterpret_cast<const void*>(f[2]);
    L.valid[l] = reinterpret_cast<const unsigned char*>(f[3]);
    L.accept[l] = reinterpret_cast<unsigned char*>(f[4]);
    L.scratch[l] = reinterpret_cast<unsigned char*>(f[5]);
    L.k[l] = static_cast<int>(k);
    L.cap[l] = static_cast<int>(f[8] < k ? f[8] : k);
    L.int_scores[l] = f[9] != 0;
    L.gh[l] = static_cast<int>(gh);
    L.gw[l] = static_cast<int>(gw);
    L.problems[l] = static_cast<int>(problems);
    L.first[l] = static_cast<int>(blocks);
    if (k == 0) continue;
    blocks += problems;
    long long need;
    if (gw > 0) {
      need = kGridFixedShared + ((gh * gw + 15) & ~15LL) +
             (f[5] == 0 ? kGridStagedBytesPerCandidate * k : 0);
    } else {
      need = kFixedShared + (f[5] == 0 ? kSharedBytesPerCandidate * k : 0);
    }
    if (need > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
    if (need > smem) smem = need;
  }
  for (int l = n_layers; l <= kMaxLayers; ++l) L.first[l] = static_cast<int>(blocks);
  if (blocks == 0) return 0;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  L.scaling = scaling;
  L.lut = static_cast<const float*>(lut);
  L.rounds = static_cast<int*>(rounds);
  return static_cast<int>(launch(uniformity_kernel, static_cast<int>(blocks), kThreads,
                                 static_cast<int>(smem), static_cast<cudaStream_t>(stream), L));
}

extern "C" int brisk_round_latency(int rounds, void* cycles, void* sink, void* stream) {
  if (rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
  round_latency_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<long long*>(cycles), static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}

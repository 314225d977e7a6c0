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
// with their cells (cx, cy), nsc1 = sqrt(sqrt(score / max)) * 255 and a
// valid flag (detect/uniformity.py's _cells, computed in torch on either
// device), and a cap. Candidate i is accepted iff it is valid, fewer than
// cap were accepted before it, and !(nsc1[i] < occ(i)), where occ(i) is
// min(255, sum of paint_j(cell_i)) over the accepted j < i and
// paint_j(cell) = ceil(lut[cy - cy_j + 15][cx - cx_j + 15] * (0.99f *
// nsc1[j])) inside the 31 x 31 patch, 0 outside. The reference's uint8
// saturating adds commute into that clipped sum because paints are
// non-negative, so a per-candidate occupancy replaces the grid: this
// kernel keeps occ(i) for every candidate, which needs K bytes whatever the
// radius and the layer's size.
//
// Design. One CTA of kThreads a problem, layer 0's CTAs first in blockIdx
// order (they run longest). A rejected candidate changes nothing, so the
// greedy is a sequence of rounds: from the candidate after the last accept,
// each thread tests one candidate of a window of kThreads against the
// current occupancy; a ballot a warp and a min over the warps' slots find
// the first that passes; the ones before it in the window are rejected, as
// the sequential loop rejects them; the accepted candidate paints every
// later candidate in its patch (occ[q] = min(255, occ[q] + paint)), a
// barrier, and the next round starts after it. A window with no accept
// advances by kThreads. So rounds = accepts + (K - accepts) / kThreads or
// fewer. The cells and occ lie in shared memory (9 bytes a candidate, up to
// kMaxSharedCandidates); a problem with more candidates keeps them in
// device memory (occ in a scratch buffer the wrapper gives, the cells read
// where they lie), through the same code. The 31 x 31 LUT (radial_lut(),
// float64 cast to float32 on the host side) is staged in shared memory.
// Nothing is read back to the host: the launch takes every layer's
// pointers, problem count, K and cap by value.
//
// Arithmetic as the oracle's: __fmul_rn for 0.99f * nsc1 and for the LUT
// product, ceilf, the test in float32; built with --fmad=false.
//
// Bound: bytes (each candidate's cx, cy, nsc1 and valid read once, the
// mask written once) or, larger here, the chain: the longest CTA's rounds
// times one round's dependent latency (a shared-memory read, the ballot,
// the reduction, a barrier), which the round-latency probe
// (brisk_round_latency) measures on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 512;  // the window: candidates tested a round
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kFields = 9;  // a host layer: cx, cy, nsc1, valid, accept, occ, problems, K, cap
constexpr int kLut = 31 * 31;
constexpr int kFixedShared = kLut * 4 + 2 * kWarps * 4;  // the LUT, two sets of warp slots
constexpr int kSharedBytesPerCandidate = 9;             // cx, cy (int32), occ (uint8)
constexpr int kMaxShared = 232448;                      // a CTA's shared memory on Hopper
constexpr int kMaxSharedCandidates = (kMaxShared - kFixedShared) / kSharedBytesPerCandidate;
static_assert(kWarps <= 32, "the slots are reduced by one warp");

// Every layer of the launch, by value in the kernel's parameters. occ[l]
// null: the layer's problems keep their cells and occ in shared memory.
struct Layers {
  const int* cx[kMaxLayers];
  const int* cy[kMaxLayers];
  const float* nsc[kMaxLayers];
  const unsigned char* valid[kMaxLayers];
  unsigned char* accept[kMaxLayers];
  unsigned char* occ[kMaxLayers];
  int k[kMaxLayers];
  int cap[kMaxLayers];
  int first[kMaxLayers + 1];  // layer l's first CTA; first[n_layers..] the total
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
  const long long base = static_cast<long long>(b - start) * K;
  const float* nsc = pick(L.nsc, l) + base;
  const unsigned char* valid = pick(L.valid, l) + base;
  unsigned char* accept = pick(L.accept, l) + base;
  unsigned char* occ_g = pick(L.occ, l);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float* lut = reinterpret_cast<float*>(smem);
  int* slots = reinterpret_cast<int*>(smem + kLut * 4);
  for (int i = tid; i < kLut; i += kThreads) lut[i] = L.lut[i];
  const int* cx;
  const int* cy;
  unsigned char* occ;
  if (occ_g == nullptr) {
    int* s_cx = reinterpret_cast<int*>(smem + kFixedShared);
    int* s_cy = s_cx + K;
    occ = reinterpret_cast<unsigned char*>(s_cy + K);
    const int* g_cx = pick(L.cx, l) + base;
    const int* g_cy = pick(L.cy, l) + base;
    for (int i = tid; i < K; i += kThreads) {
      s_cx[i] = g_cx[i];
      s_cy[i] = g_cy[i];
    }
    cx = s_cx;
    cy = s_cy;
  } else {
    cx = pick(L.cx, l) + base;
    cy = pick(L.cy, l) + base;
    occ = occ_g + base;
  }
  for (int i = tid; i < K; i += kThreads) {
    occ[i] = 0;
    accept[i] = 0;
  }
  __syncthreads();

  int cursor = 0, n_acc = 0, rounds = 0, parity = 0;
  while (cursor < K && n_acc < cap) {
    ++rounds;
    const int i = cursor + tid;
    const bool ok = i < K && valid[i] && !(nsc[i] < static_cast<float>(occ[i]));
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    int* s = slots + parity * kWarps;  // two sets: a round reads one while the next writes the other
    if (lane == 0) s[warp] = ballot ? warp * 32 + __ffs(ballot) - 1 : kThreads;
    __syncthreads();
    const int m = __reduce_min_sync(0xffffffffu, lane < kWarps ? s[lane] : kThreads);
    parity ^= 1;
    if (m == kThreads) {  // no accept in the window: occ is unchanged
      cursor += kThreads;
      continue;
    }
    const int j = cursor + m;
    ++n_acc;
    if (tid == 0) accept[j] = 1;
    const float pn = __fmul_rn(0.99f, nsc[j]);
    const int jx = cx[j], jy = cy[j];
#pragma unroll 4
    for (int q = j + 1 + tid; q < K; q += kThreads) {
      const int dx = cx[q] - jx + 15, dy = cy[q] - jy + 15;
      if (static_cast<unsigned>(dx) < 31u && static_cast<unsigned>(dy) < 31u) {
        const int o = occ[q] + static_cast<int>(ceilf(__fmul_rn(lut[dy * 31 + dx], pn)));
        occ[q] = static_cast<unsigned char>(o < 255 ? o : 255);
      }
    }
    __syncthreads();
    cursor = j + 1;
  }
  if (L.rounds != nullptr && tid == 0) L.rounds[b] = rounds;
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
    int* s = slots + parity * kWarps;
    if (lane == 0) s[warp] = ballot ? warp * 32 + __ffs(ballot) - 1 : kThreads;
    __syncthreads();
    const int m = __reduce_min_sync(0xffffffffu, lane < kWarps ? s[lane] : kThreads);
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

// layers: n_layers x kFields int64 (cx, cy, nsc1, valid, accept and occ
// pointers, problems, K, cap); occ 0 keeps a layer in shared memory, which
// takes K <= kMaxSharedCandidates. lut: the 31 x 31 float32 LUT on the card.
// rounds: an int32 a CTA (the problems in layer order), or null.
extern "C" int brisk_enforce_uniformity(const void* host_layers, int n_layers, const void* lut,
                                        void* rounds, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* f = static_cast<const int64_t*>(host_layers);
  Layers L = {};
  long long blocks = 0, shared_k = 0;
  for (int l = 0; l < n_layers; ++l, f += kFields) {
    const int64_t problems = f[6], k = f[7];
    if (problems < 0 || k < 0 || k >= (1LL << 31) || f[8] < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.cx[l] = reinterpret_cast<const int*>(f[0]);
    L.cy[l] = reinterpret_cast<const int*>(f[1]);
    L.nsc[l] = reinterpret_cast<const float*>(f[2]);
    L.valid[l] = reinterpret_cast<const unsigned char*>(f[3]);
    L.accept[l] = reinterpret_cast<unsigned char*>(f[4]);
    L.occ[l] = reinterpret_cast<unsigned char*>(f[5]);
    L.k[l] = static_cast<int>(k);
    L.cap[l] = static_cast<int>(f[8] < k ? f[8] : k);
    L.first[l] = static_cast<int>(blocks);
    if (k > 0) blocks += problems;
    if (f[5] == 0 && k > 0) {
      if (k > kMaxSharedCandidates) return static_cast<int>(cudaErrorInvalidValue);
      if (k > shared_k) shared_k = k;
    }
  }
  for (int l = n_layers; l <= kMaxLayers; ++l) L.first[l] = static_cast<int>(blocks);
  if (blocks == 0) return 0;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  L.lut = static_cast<const float*>(lut);
  L.rounds = static_cast<int*>(rounds);
  const int smem = kFixedShared + static_cast<int>(shared_k) * kSharedBytesPerCandidate;
  return static_cast<int>(launch(uniformity_kernel, static_cast<int>(blocks), kThreads, smem,
                                 static_cast<cudaStream_t>(stream), L));
}

extern "C" int brisk_round_latency(int rounds, void* cycles, void* sink, void* stream) {
  if (rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
  round_latency_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rounds, static_cast<long long*>(cycles), static_cast<int*>(sink));
  return static_cast<int>(cudaGetLastError());
}

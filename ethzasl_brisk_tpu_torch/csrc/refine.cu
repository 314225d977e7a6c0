// The refine of a Harris detection on Hopper (kernel refine_keypoints):
// the accepted-prefix compaction, the 3x3 score taps, the sub-pixel fit,
// the un-mapping and the packing of every layer in one launch, a CTA a
// (layer, frame).
//
// No TPU kernel: it stands for XLA work of the JAX package,
// ethzasl_brisk_tpu/detect/scale_space.py:666-701 (compact_accepted) and
// :772-848 (_refine_keypoints_fused) with detect/subpixel.py:18
// (subpixel2d), and for the certificate's accepted counts (:630-633). Per
// (frame, layer) of k score-ordered candidates (x, y, score) and their
// accept flags, with cap = min(k, max_num_kpt, the refine cap):
//   * the compaction is the stable partition of the candidates, accepted
//     first, each part in its order, cut to cap (none when cap == k);
//   * slot j of it takes the 3x3 patch s[a][b] = Score(x+b-1, y+a-1),
//     clamped to the map, in the refine type T (float, or double for
//     refine_dtype="float64"), and runs the reference's Subpixel2D
//     (scale-space-layer-inl.h:560-693) op for op as the port's
//     detect/subpixel.py does: every product and sum rounds alone
//     (--fmad=false), divisions by tensors are __fdiv_rn / __ddiv_rn, the
//     float casts where it casts, the corner values truncated, the first
//     maximum of [v0, v1 - 0.5, v2 - 0.5, v3 - 0.5], and the boundary
//     branch's delta_y = delta_x{1,2};
//   * x = float(scale * ((x + dx) + offset)), y likewise, size =
//     scale * 12, angle = -1, response = float(score), octave, valid =
//     the accept flag, into column col + j of the layer-major (B, C)
//     packing.
//
// Bound: bytes. Each candidate's accept byte is read once, and a slot's
// candidate (x, y, score: 12 B), its taps (9 sectors of 32 B at most,
// shared by neighbours) and its 25 B of fields (five float32, the int32
// octave, the valid byte); the fit's ~150 float operations a slot are far
// below the card's rate. What a CTA waits on is memory round trips, so the
// design keeps them few and puts every slot's loads in flight at once.
//
// Design: a CTA of 512 threads a (layer, frame). The row of accept flags
// is read in chunks of kChunk = 16,384 flags, a run of 32 consecutive
// flags a thread, as 16-byte loads into registers packed to bit words (the
// row's first byte may lie anywhere in a 16-byte word: chunks are counted
// from the word it lies in, and the bits outside the row are masked). One
// block scan of the runs' accepted counts ranks a chunk: an accepted
// flag's rank among the accepted is the scan's prefix plus its bits before
// it, a rest flag's is its position less that. Each kept flag writes its
// position into the slot table in shared memory (the accepted kept at
// entries 0.., the rest after them), and after one barrier thread t fits
// entries t, t + 512, ...: the candidate, its nine taps and its fields
// are loads in flight together, and the stores of neighbouring slots are
// neighbouring columns.
//   * A row of one chunk (every list of the steps) is read once: the scan's
//     total is the accepted count.
//   * A longer row is counted first, every chunk's 16-byte loads in flight
//     together, each of the first kMaxChunks chunks' accepted count kept;
//     then the walk ranks, places and fits chunk by chunk with the ranks
//     carried, skips a chunk that keeps no slot, and stops once cap slots
//     are placed. A chunk keeps at most kChunk entries, so the table holds
//     any cap.
//   * cap == k (no compaction) counts the row and fits slot j from
//     candidate j.
// The B=128 step's 512 CTAs run in two waves of 264 (two CTAs an SM);
// CTAs of 256 threads would run them in one, but measured no faster there
// and slower at B=16 (PERF.md).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 32;
constexpr int kChunk = 16384;      // flags a chunk, and entries of the slot table
constexpr int kWords = kChunk / (kThreads * kLanes);  // bit words of a thread's run
constexpr int kMaxChunks = 128;    // chunks whose accepted counts the count pass keeps
constexpr int kMaxLayers = 8;
constexpr int kFields = 14;        // int64 fields of a layer in the host table
constexpr int kOuts = 8;           // output pointers
constexpr unsigned kAll = 0xffffffffu;
static_assert(kChunk == kThreads * kLanes * kWords, "a chunk is a run of whole words a thread");
static_assert(kChunk <= 65536, "a chunk's positions fit the table's 16-bit entries");

// A CTA's registers: the float32 fit at 2 CTAs of 512 an SM, 64 registers
// a thread; the float64 one may take twice the registers.
template <typename T>
struct MinCtas {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};

struct Layer {
  const uint32_t* scores;  // (B, h, w) int32 or float32 bits
  const int32_t* xs;       // (B, k)
  const int32_t* ys;       // (B, k)
  const uint32_t* top;     // (B, k), the scores' type
  const uint8_t* accept;   // (B, k) bool
  int h, w, k, cap, col, count_col, octave;
  double scale, offset;
};

struct Layers {
  Layer l[kMaxLayers];
  int frames;
  int n_cols;    // C: the packing's columns
  int n_counts;  // the counts' columns (every layer of the detection)
  float* x;
  float* y;
  float* size;
  float* angle;
  float* response;
  int32_t* octave;
  uint8_t* valid;
  int32_t* counts;  // (B, n_counts)
};

// A (frame, layer)'s accept row as 16-byte words: `base` is the word its
// first flag lies in, `off` that flag's byte in it; flag i is at virtual
// position v = off + i < end, and chunk c holds v in [c * kChunk,
// (c + 1) * kChunk).
struct Row {
  const uint8_t* base;
  int off;
  long long end;
};

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const int t = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The block's exclusive prefix of v and its total (kThreads / 32 + 1 ints
// of shared memory in `warps`).
__device__ __forceinline__ int block_exclusive(int v, int* warps, int& total) {
  constexpr int kWarps = kThreads / kLanes;
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int incl = warp_inclusive(v, lane);
  if (lane == kLanes - 1) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? warps[lane] : 0;
    const int wi = warp_inclusive(w, lane);
    if (lane < kWarps) warps[lane] = wi - w;
    if (lane == kWarps - 1) warps[kWarps] = wi;
  }
  __syncthreads();
  const int out = warps[warp] + incl - v;
  total = warps[kWarps];
  __syncthreads();
  return out;
}

// The bits below n, n clamped to [0, 32].
__device__ __forceinline__ uint32_t bits_below(long long n) {
  return n <= 0 ? 0u : (n >= kLanes ? kAll : (1u << n) - 1u);
}

// Bit j: byte j of w is not zero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// A thread's run of a chunk: kWords bit words of 32 flags from virtual
// position v0; bit j of acc[i] is flag v0 + 32 i + j accepted, of in_row[i]
// that flag one of the row. Words holding no flag of the row are not read.
struct Run {
  uint32_t acc[kWords];
  uint32_t in_row[kWords];

  __device__ __forceinline__ Run(const Row& r, long long v0) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      uint32_t bits = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const long long v = v0 + 32 * i + 16 * q;
        if (v < r.end && v + 16 > r.off) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(r.base + v));
          bits |= (nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 | nonzero_bytes(w.z) << 8 |
                   nonzero_bytes(w.w) << 12)
                  << (16 * q);
        }
      }
      in_row[i] = bits_below(r.end - v0 - 32 * i) & ~bits_below(r.off - v0 - 32 * i);
      acc[i] = bits & in_row[i];
    }
  }

  __device__ __forceinline__ int accepted() const {
    int n = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) n += __popc(acc[i]);
    return n;
  }

  // The run's kept flags into the slot table, by position in the chunk
  // (the run starts at `first`): an accepted flag of rank rank_acc <
  // acc_slots at entry rank_acc - a0, a rest flag of rank rank_rest <
  // rest_slots at entry ka + rank_rest - r0. The ranks of the run's first
  // accepted and rest flags are t_acc and t_rest.
  __device__ __forceinline__ void place(uint16_t* table, int first, int t_acc, int t_rest,
                                        int a0, int r0, int ka, int acc_slots,
                                        int rest_slots) const {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      for (uint32_t m = acc[i]; m != 0 && t_acc < acc_slots; m &= m - 1, ++t_acc) {
        table[t_acc - a0] = static_cast<uint16_t>(first + 32 * i + __ffs(m) - 1);
      }
      for (uint32_t m = in_row[i] & ~acc[i]; m != 0 && t_rest < rest_slots; m &= m - 1, ++t_rest) {
        table[ka + t_rest - r0] = static_cast<uint16_t>(first + 32 * i + __ffs(m) - 1);
      }
    }
  }
};

// The row's accepted flags (the block's total) from every chunk's runs, its
// loads in flight together; where `chunk_acc` is given (zeroed), each of
// the first kMaxChunks chunks' accepted count added into it.
__device__ __forceinline__ int count_row(const Row& r, int n_chunks, int* chunk_acc,
                                         int* warps) {
  const int lane = threadIdx.x % kLanes;
  int mine = 0;
#pragma unroll 4
  for (int c = 0; c < n_chunks; ++c) {
    const int a =
        Run(r, static_cast<long long>(c) * kChunk + threadIdx.x * (kWords * kLanes))
            .accepted();
    mine += a;
    if (chunk_acc != nullptr && c < kMaxChunks) {
      int s = a;
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kAll, s, o);
      if (lane == 0 && s) atomicAdd(&chunk_acc[c], s);
    }
  }
  int total;
  block_exclusive(mine, warps, total);
  return total;
}

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ float trunc_rz(float v) { return truncf(v); }
__device__ __forceinline__ double trunc_rz(double v) { return trunc(v); }

__device__ __forceinline__ float clamp1(float v) {
  return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);  // NaN stays NaN, as torch.clamp
}

// detect/subpixel.py::subpixel2d on one patch s (row-major 3x3): the
// deltas (delta_x, delta_y) in T.
template <typename T>
__device__ __forceinline__ void subpixel2d(const T* s, T& delta_x, T& delta_y) {
  const T s_0_0 = s[0], s_0_1 = s[1], s_0_2 = s[2];
  const T s_1_0 = s[3], s_1_1 = s[4], s_1_2 = s[5];
  const T s_2_0 = s[6], s_2_1 = s[7], s_2_2 = s[8];
  const T two = 2, three = 3, four = 4, five = 5, half = 0.5, eighteen = 18;

  const T tmp1 = (((s_0_0 + s_0_2) - two * s_1_1) + s_2_0) + s_2_2;
  const T coeff1 = three * (((tmp1 + s_0_1) - div_rn(s_1_0 + s_1_2, two)) + s_2_1);
  const T coeff2 = three * (((tmp1 - div_rn(s_0_1 + s_2_1, two)) + s_1_0) + s_1_2);
  const T tmp2 = s_0_2 - s_2_0;
  const T tmp3 = (s_0_0 + tmp2) - s_2_2;
  const T tmp4 = tmp3 - two * tmp2;
  const T coeff3 = -three * ((tmp3 + s_0_1) - s_2_1);
  const T coeff4 = -three * ((tmp4 + s_1_0) - s_1_2);
  const T coeff5 = div_rn(((s_0_0 - s_0_2) - s_2_0) + s_2_2, four);
  const T coeff6 = div_rn(
      -(((((s_0_0 + s_0_2) - div_rn(((s_1_0 + s_0_1) + s_1_2) + s_2_1, two)) - five * s_1_1) +
         s_2_0) +
        s_2_2),
      T(2.01));
  const T h_det = (four * coeff1) * coeff2 - coeff5 * coeff5;

  // The corner fallback: the values truncated, the first maximum of
  // [v0, v1 - 0.5, v2 - 0.5, v3 - 0.5] (a NaN counts as the maximum, as
  // in torch.argmax).
  const T corner[4] = {
      trunc_rz((coeff3 + coeff4) + coeff5),
      trunc_rz(((-coeff3) + coeff4) - coeff5) - half,
      trunc_rz((coeff3 - coeff4) - coeff5) - half,
      trunc_rz(((-coeff3) - coeff4) + coeff5) - half,
  };
  int pick = 0;
  T best = corner[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (!(best != best) && (corner[i] != corner[i] || corner[i] > best)) {
      best = corner[i];
      pick = i;
    }
  }
  const T b_dx = (pick & 1) ? T(-1) : T(1);
  const T b_dy = pick < 2 ? T(1) : T(-1);

  // The interior solution with its boundary correction: float divisions
  // of float casts.
  const float safe_det = static_cast<float>(h_det == T(0) ? T(1) : h_det);
  const float dx0 =
      __fdiv_rn(static_cast<float>((two * coeff2) * coeff3 - coeff4 * coeff5), -safe_det);
  const float dy0 =
      __fdiv_rn(static_cast<float>((two * coeff1) * coeff4 - coeff3 * coeff5), -safe_det);
  const bool tx = dx0 > 1.0f, tx_ = dx0 < -1.0f, ty = dy0 > 1.0f, ty_ = dy0 < -1.0f;
  const bool out_of_bounds = tx || tx_ || ty || ty_;
  const float div_c1 = static_cast<float>(coeff1 == T(0) ? T(1) : two * coeff1);
  const float div_c2 = static_cast<float>(coeff2 == T(0) ? T(1) : two * coeff2);
  const float delta_x1 = tx ? 1.0f : (tx_ ? -1.0f : 0.0f);
  const float delta_y1 = clamp1(
      tx ? __fdiv_rn(-static_cast<float>(coeff4 + coeff5), div_c2)
         : (tx_ ? __fdiv_rn(-static_cast<float>(coeff4 - coeff5), div_c2) : 0.0f));
  const float delta_y2 = ty ? 1.0f : (ty_ ? -1.0f : 0.0f);
  const float delta_x2 = clamp1(
      ty ? __fdiv_rn(-static_cast<float>(coeff3 + coeff5), div_c1)
         : (ty_ ? __fdiv_rn(-static_cast<float>(coeff3 - coeff5), div_c1) : 0.0f));
  // The patches' precision over float deltas, rounded to float.
  auto quad = [&](float dxf, float dyf) {
    const T dx = dxf, dy = dyf;
    return static_cast<float>(div_rn(
        (((((coeff1 * dx) * dx + (coeff2 * dy) * dy) + coeff3 * dx) + coeff4 * dy) +
         (coeff5 * dx) * dy) +
            coeff6,
        eighteen));
  };
  const bool pick1 = quad(delta_x1, delta_y1) > quad(delta_x2, delta_y2);
  const float bnd_d = pick1 ? delta_x1 : delta_x2;  // both deltas: the reference's
  const float c_dx = out_of_bounds ? bnd_d : dx0;
  const float c_dy = out_of_bounds ? bnd_d : dy0;

  const bool is_zero = h_det == T(0);
  const bool is_corner = !(h_det > T(0)) || !(coeff1 < T(0));
  delta_x = is_zero ? T(0) : (is_corner ? b_dx : T(c_dx));
  delta_y = is_zero ? T(0) : (is_corner ? b_dy : T(c_dy));
}

template <bool kFloat, typename T>
__device__ __forceinline__ T score_of(uint32_t bits) {
  return kFloat ? static_cast<T>(__uint_as_float(bits)) : static_cast<T>(static_cast<int>(bits));
}

// Slot `slot` of frame `frame` of layer Y from its candidate i; `valid` is
// the candidate's accept flag, or -1 to read it.
template <bool kFloat, typename T>
__device__ __forceinline__ void write_slot(const Layers& L, const Layer& Y, int frame, int i,
                                           int slot, int valid) {
  const size_t cand = static_cast<size_t>(frame) * Y.k + i;
  const int x = __ldg(Y.xs + cand), y = __ldg(Y.ys + cand);
  const uint32_t top = __ldg(Y.top + cand);
  if (valid < 0) valid = __ldg(Y.accept + cand) != 0;
  const uint32_t* sc = Y.scores + static_cast<size_t>(frame) * Y.h * Y.w;
  T s[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int yy = min(max(y + a - 1, 0), Y.h - 1);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int xx = min(max(x + b - 1, 0), Y.w - 1);
      s[3 * a + b] = score_of<kFloat, T>(__ldg(sc + static_cast<size_t>(yy) * Y.w + xx));
    }
  }
  T dx, dy;
  subpixel2d<T>(s, dx, dy);
  const T scale = static_cast<T>(Y.scale), offset = static_cast<T>(Y.offset);
  const size_t o = static_cast<size_t>(frame) * L.n_cols + Y.col + slot;
  L.x[o] = static_cast<float>(scale * ((static_cast<T>(x) + dx) + offset));
  L.y[o] = static_cast<float>(scale * ((static_cast<T>(y) + dy) + offset));
  L.size[o] = static_cast<float>(Y.scale * 12.0);
  L.angle[o] = -1.0f;
  L.response[o] = score_of<kFloat, float>(top);
  L.octave[o] = Y.octave;
  L.valid[o] = static_cast<uint8_t>(valid);
}

// Chunk c of the walk: rank its runs (one block scan), place its kept
// flags in the table, then fit the table's entries slot-major. a0 and f0
// are the accepted flags and the flags of the row before the chunk, n_acc
// the row's, or -1 where the chunk is the whole row (its scan's total is
// then the accepted count, written to `count`). Returns the chunk's
// accepted count.
template <bool kFloat, typename T>
__device__ __forceinline__ int walk_chunk(const Layers& L, const Layer& Y, int frame,
                                          const Row& r, int c, int a0, int f0, int n_acc,
                                          uint16_t* table, int* warps, int32_t* count) {
  const long long chunk0 = static_cast<long long>(c) * kChunk;
  const int first = threadIdx.x * (kWords * kLanes);
  const long long v0 = chunk0 + first;
  const Run run(r, v0);
  int a_c;
  const int excl = block_exclusive(run.accepted(), warps, a_c);
  if (n_acc < 0) {
    n_acc = a_c;
    if (threadIdx.x == 0) *count = n_acc;
  }
  const int acc_slots = min(n_acc, Y.cap), rest_slots = Y.cap - acc_slots;
  // The flags of the chunk before the run, and in the chunk.
  const long long head = chunk0 > r.off ? chunk0 : r.off;
  const long long tail = chunk0 + kChunk < r.end ? chunk0 + kChunk : r.end;
  const int before = static_cast<int>(v0 > head ? (v0 < tail ? v0 : tail) - head : 0);
  const int flags = static_cast<int>(tail - head);
  const int r0 = f0 - a0;
  const int ka = min(max(acc_slots - a0, 0), a_c);
  const int kr = min(max(rest_slots - r0, 0), flags - a_c);
  run.place(table, first, a0 + excl, r0 + before - excl, a0, r0, ka, acc_slots, rest_slots);
  __syncthreads();
  for (int e = threadIdx.x; e < ka + kr; e += kThreads) {
    const int i = static_cast<int>(chunk0 + table[e] - r.off);
    const bool is_acc = e < ka;
    write_slot<kFloat, T>(L, Y, frame, i, is_acc ? a0 + e : n_acc + r0 + (e - ka), is_acc);
  }
  return a_c;
}

template <bool kFloat, typename T>
__global__ void __launch_bounds__(kThreads, MinCtas<T>::value) refine_kernel(const Layers L) {
  __shared__ uint16_t table[kChunk];
  __shared__ int chunk_acc[kMaxChunks];
  __shared__ int warps[kThreads / kLanes + 1];

  const int li = blockIdx.x / L.frames, frame = blockIdx.x - li * L.frames;
  Layer Y = L.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLayers; ++i) {
    if (i == li) Y = L.l[i];
  }
  const int k = Y.k, cap = Y.cap;
  int32_t* count = L.counts + static_cast<size_t>(frame) * L.n_counts + Y.count_col;
  if (k == 0) {
    if (threadIdx.x == 0) *count = 0;
    return;
  }
  const uint8_t* first = Y.accept + static_cast<size_t>(frame) * k;
  Row r;
  r.off = static_cast<int>(reinterpret_cast<uintptr_t>(first) & 15u);
  r.base = first - r.off;
  r.end = r.off + static_cast<long long>(k);
  const int n_chunks = static_cast<int>((r.end + kChunk - 1) / kChunk);

  if (cap >= k) {  // no compaction: slot j is candidate j
    const int n_acc = count_row(r, n_chunks, nullptr, warps);
    if (threadIdx.x == 0) *count = n_acc;
    for (int j = threadIdx.x; j < k; j += kThreads) write_slot<kFloat, T>(L, Y, frame, j, j, -1);
    return;
  }
  if (n_chunks == 1) {
    walk_chunk<kFloat, T>(L, Y, frame, r, 0, 0, 0, -1, table, warps, count);
    return;
  }
  // Several chunks: count them, then walk them with the ranks carried.
  for (int i = threadIdx.x; i < kMaxChunks; i += kThreads) chunk_acc[i] = 0;
  __syncthreads();
  const int n_acc = count_row(r, n_chunks, chunk_acc, warps);
  if (threadIdx.x == 0) *count = n_acc;
  const int acc_slots = min(n_acc, cap), rest_slots = cap - acc_slots;
  int a0 = 0, f0 = 0;
  for (int c = 0; c < n_chunks; ++c) {
    if (a0 >= acc_slots && f0 - a0 >= rest_slots) break;  // every slot placed
    const long long chunk0 = static_cast<long long>(c) * kChunk;
    const int flags = static_cast<int>((chunk0 + kChunk < r.end ? chunk0 + kChunk : r.end) -
                                       (chunk0 > r.off ? chunk0 : r.off));
    if (c < kMaxChunks) {
      const int a_c = chunk_acc[c];
      if (min(max(acc_slots - a0, 0), a_c) + min(max(rest_slots - (f0 - a0), 0), flags - a_c) ==
          0) {  // the chunk keeps no slot: skip it
        a0 += a_c;
        f0 += flags;
        continue;
      }
    }
    a0 += walk_chunk<kFloat, T>(L, Y, frame, r, c, a0, f0, n_acc, table, warps, count);
    f0 += flags;
  }
}

}  // namespace

// host_layers: n_layers x kFields int64, a layer's: scores, xs, ys, top,
// accept, h, w, k, cap, its first column of the packing, its column of the
// counts, octave, and scale and offset as float64 bits. outs: x, y, size,
// angle, response, octave, valid ((frames, n_cols) each) and the counts
// ((frames, n_counts)). is_float: float32 scores (else int32); is_double:
// the fit in float64.
extern "C" int brisk_refine_keypoints(const int64_t* host_layers, int n_layers,
                                      const int64_t outs[kOuts], int frames, int n_cols, int n_counts,
                                      int is_float, int is_double, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || frames < 0 || n_cols < 0 ||
      n_counts < n_layers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layers L = {};
  for (int l = 0; l < n_layers; ++l) {
    const int64_t* f = host_layers + static_cast<size_t>(l) * kFields;
    const int64_t h = f[5], w = f[6], k = f[7], cap = f[8], col = f[9], count_col = f[10];
    if (h < 1 || w < 1 || h * w >= (1LL << 31) || k < 0 || k >= (1LL << 31) || cap < 0 ||
        cap > k || col < 0 || col + cap > n_cols || count_col < 0 || count_col >= n_counts) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Layer& Y = L.l[l];
    Y.scores = reinterpret_cast<const uint32_t*>(f[0]);
    Y.xs = reinterpret_cast<const int32_t*>(f[1]);
    Y.ys = reinterpret_cast<const int32_t*>(f[2]);
    Y.top = reinterpret_cast<const uint32_t*>(f[3]);
    Y.accept = reinterpret_cast<const uint8_t*>(f[4]);
    Y.h = static_cast<int>(h);
    Y.w = static_cast<int>(w);
    Y.k = static_cast<int>(k);
    Y.cap = static_cast<int>(cap);
    Y.col = static_cast<int>(col);
    Y.count_col = static_cast<int>(count_col);
    Y.octave = static_cast<int>(f[11]);
    std::memcpy(&Y.scale, f + 12, sizeof(double));
    std::memcpy(&Y.offset, f + 13, sizeof(double));
  }
  L.frames = frames;
  L.n_cols = n_cols;
  L.n_counts = n_counts;
  L.x = reinterpret_cast<float*>(outs[0]);
  L.y = reinterpret_cast<float*>(outs[1]);
  L.size = reinterpret_cast<float*>(outs[2]);
  L.angle = reinterpret_cast<float*>(outs[3]);
  L.response = reinterpret_cast<float*>(outs[4]);
  L.octave = reinterpret_cast<int32_t*>(outs[5]);
  L.valid = reinterpret_cast<uint8_t*>(outs[6]);
  L.counts = reinterpret_cast<int32_t*>(outs[7]);
  const long long blocks = static_cast<long long>(frames) * n_layers;
  if (blocks == 0) return 0;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(blocks);
  cudaError_t err;
  if (is_float) {
    err = is_double ? launch(refine_kernel<true, double>, grid, kThreads, 0, s, L)
                    : launch(refine_kernel<true, float>, grid, kThreads, 0, s, L);
  } else {
    err = is_double ? launch(refine_kernel<false, double>, grid, kThreads, 0, s, L)
                    : launch(refine_kernel<false, float>, grid, kThreads, 0, s, L);
  }
  return static_cast<int>(err);
}

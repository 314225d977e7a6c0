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
// octave, the valid byte); the fit's ~120 float operations a slot are far
// below the card's rate.
//
// Design: a CTA of 256 threads counts the accepted flags, then, where the
// layer is cut, walks the flags in tiles of 1024, four consecutive a
// thread, with one block scan a tile of both ranks packed in one word
// (accepted in the low half, the rest in the high): a candidate's rank
// gives its slot, and the walk stops once cap slots are filled. The
// thread that owns a slot's candidate gathers its taps through the
// read-only path and writes the slot. Without a cut, candidate j is slot j.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr int kItems = 4;         // consecutive candidates a thread in the walk
constexpr int kMaxLayers = 8;
constexpr int kFields = 14;       // int64 fields of a layer in the host table
constexpr int kOuts = 8;          // output pointers
constexpr unsigned kAll = 0xffffffffu;
static_assert(kThreads * kItems < (1 << 16), "a tile's ranks fit a half word");

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

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const int t = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The block's exclusive prefix of v and its total (kWarps + 1 ints of
// shared memory in `warps`).
__device__ __forceinline__ int block_exclusive(int v, int* warps, int& total) {
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

// Slot `slot` of frame `frame` of layer Y from its candidate i.
template <bool kFloat, typename T>
__device__ __forceinline__ void write_slot(const Layers& L, const Layer& Y, int frame, int i,
                                           int slot) {
  const size_t cand = static_cast<size_t>(frame) * Y.k + i;
  const int x = Y.xs[cand], y = Y.ys[cand];
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
  L.response[o] = score_of<kFloat, float>(Y.top[cand]);
  L.octave[o] = Y.octave;
  L.valid[o] = Y.accept[cand] != 0;
}

template <bool kFloat, typename T>
__global__ void __launch_bounds__(kThreads) refine_kernel(const Layers L) {
  __shared__ int warps[kWarps + 1];
  __shared__ int accepted;

  const int li = blockIdx.x / L.frames, frame = blockIdx.x - li * L.frames;
  Layer Y = L.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLayers; ++i) {
    if (i == li) Y = L.l[i];
  }
  const int k = Y.k;
  const uint8_t* acc = Y.accept + static_cast<size_t>(frame) * k;
  if (threadIdx.x == 0) accepted = 0;
  __syncthreads();
  int a = 0;
  for (int i = threadIdx.x; i < k; i += kThreads) a += acc[i] != 0;
  a = warp_inclusive(a, threadIdx.x % kLanes);
  if (threadIdx.x % kLanes == kLanes - 1 && a) atomicAdd(&accepted, a);
  __syncthreads();
  const int n_acc = accepted;
  if (threadIdx.x == 0) L.counts[static_cast<size_t>(frame) * L.n_counts + Y.count_col] = n_acc;

  const int cap = Y.cap;
  if (cap >= k) {
    for (int i = threadIdx.x; i < k; i += kThreads) write_slot<kFloat, T>(L, Y, frame, i, i);
    return;
  }
  // The stable partition, accepted first, cut to cap.
  const int acc_slots = n_acc < cap ? n_acc : cap, rest = cap - acc_slots;
  int done_acc = 0, done_rest = 0;
  for (int base = 0; base < k && (done_acc < acc_slots || done_rest < rest);
       base += kThreads * kItems) {
    const int first = base + threadIdx.x * kItems;
    uint32_t hit_acc = 0, hit_rest = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (first + j < k) {
        if (acc[first + j]) {
          hit_acc |= 1u << j;
        } else {
          hit_rest |= 1u << j;
        }
      }
    }
    int total;
    const int excl =
        block_exclusive(__popc(hit_acc) | __popc(hit_rest) << 16, warps, total);
    int rank_acc = done_acc + (excl & 0xffff), rank_rest = done_rest + (excl >> 16);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (hit_acc >> j & 1u) {
        if (rank_acc < acc_slots) write_slot<kFloat, T>(L, Y, frame, first + j, rank_acc);
        ++rank_acc;
      } else if (hit_rest >> j & 1u) {
        if (rank_rest < rest) write_slot<kFloat, T>(L, Y, frame, first + j, n_acc + rank_rest);
        ++rank_rest;
      }
    }
    done_acc += total & 0xffff;
    done_rest += total >> 16;
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

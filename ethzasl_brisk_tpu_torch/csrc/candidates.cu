// The score-ordered candidate lists of a Harris pyramid on Hopper (kernel
// layer_candidates): every layer of a detection in one launch, a CTA a
// (layer, frame).
//
// No TPU kernel: it stands for XLA work of the JAX package,
// ethzasl_brisk_tpu/detect/scale_space.py:704-751 (_layer_candidates:
// lax.top_k over the whole masked map; kernels/topk.py:30, topk_int32, is
// the same selection by bisection and prefix compaction), and for the
// certificate's per-layer mask counts (:613-615). Per (frame, layer), with
// the map's scores s (int32, or float32 on the 16-bit path), its candidate
// mask m and k = min(cap, h*w), the outputs are the first k entries of
// the whole map ordered by score, descending, where a masked-out pixel
// reads the sentinel (INT32_MIN, or -inf) and ties go to the lower flat
// index: (x, y, score, m) a slot, and the count of m.
//   * A survivor is a masked-in pixel that beats the sentinel. Its key is
//     one unique 64-bit word: the order-preserving image of its score,
//     inverted, above its flat index. Ascending keys are the stable
//     descending order, so any sort of the keys gives it. Float scores
//     order as lax.top_k orders them, by the IEEE total order of their
//     bits (+0.0 above -0.0, a NaN by its sign beyond the infinities).
//   * Where fewer than k survive, the slots after them are the lowest-index
//     pixels at the sentinel (masked out, or masked in at the sentinel
//     itself), in flat order: their score is the sentinel and their m the
//     mask's bit.
//   * After those, on float scores, come the masked-in pixels under the
//     sentinel (a NaN with its sign set), ordered by their keys as the
//     survivors are, each with its own score.
//
// Bound: bytes. The mask is read once (1 B a pixel), a masked-in pixel's
// score sector (32 B) once, and each slot written (13 B).
//
// Design: a CTA of 1024 threads walks its map's mask in 16-byte loads
// (the unaligned head and tail a byte a thread), reads the score of each
// masked-in byte and appends the survivors' keys to a list by a warp scan
// and one shared atomic a warp; the mask bits are counted on the way.
// Where the list holds every survivor (up to next_pow2(k) keys) a bitonic
// network sorts it, padded to a power of two, and the first k keys are
// written out. Where more survive, a radix select over the map (four
// passes of 8-bit digits on the inverted score word, as topk_int32
// bisects) finds the k-th key's score word T; the survivors above T and
// the first ties at T in flat order (an ordered block-scan walk) refill the
// list, which is sorted. The slots after the survivors come from the same
// ordered walk over the pixels that do not survive, which stops once they
// are filled; what slots are left take the masked-in pixels under the
// sentinel, listed, selected and sorted as the survivors are. Two routes,
// by next_pow2(k) (candidates.launch_plan): the
// list in shared memory (at most kChunkKeys keys, 128 KB), or in a
// device-memory scratch that the wrapper allocates, sorted in shared
// memory when what survives fits a chunk and otherwise by the same
// network with its strides of a chunk and more in device memory and the
// rest a chunk at a time in shared memory. The grid is layer-major, so
// the largest layer's CTAs start first.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr int kMaxLayers = 8;
constexpr int kFields = 11;          // int64 fields of a layer in the host table
constexpr int kChunkKeys = 16384;    // keys a CTA sorts in shared memory (128 KB)
constexpr int kWalkItems = 4;        // consecutive pixels a thread in an ordered walk
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned long long kPad = ~0ull;
static_assert(kWarps <= kLanes, "one warp scans the warps' totals");
static_assert((kChunkKeys & (kChunkKeys - 1)) == 0, "a chunk is a power of two");

struct Layer {
  const uint32_t* scores;  // (B, h, w) int32 or float32 bits
  const uint8_t* mask;     // (B, h, w) bool
  int32_t* xs;             // (B, k)
  int32_t* ys;             // (B, k)
  uint32_t* top;           // (B, k), the scores' type
  uint8_t* valid;          // (B, k) bool
  unsigned long long* scratch;  // (B, next_pow2(k)) keys: the device route; null: shared
  int h, w, k, col;        // col: the layer's column of the counts
};

struct Layers {
  Layer l[kMaxLayers];
  int n;
  int frames;
  int n_cols;      // columns of the counts (every layer of the detection)
  int is_float;
  int chunk_keys;  // the dynamic shared list's keys
  int32_t* counts;  // (B, n_cols)
};

__device__ __forceinline__ int next_pow2(int v) {
  return v <= 1 ? 1 : 1 << (32 - __clz(v - 1));
}

// The order-preserving unsigned image of a score (on floats, of the IEEE
// total order).
__device__ __forceinline__ uint32_t order_of(uint32_t bits, bool is_float) {
  if (!is_float) return bits ^ 0x80000000u;
  return (bits & 0x80000000u) ? ~bits : bits | 0x80000000u;
}

__device__ __forceinline__ int warp_inclusive(int v, int lane) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const int t = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The block's exclusive prefix of v and its total. Every thread calls it;
// `warps` is kWarps + 1 ints of shared memory.
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

// The map's pixels in groups: the unaligned head and the tail a pixel a
// group, the rest 16 a group (one 16-byte load of the mask).
struct Groups {
  int head, vecs, tail, total;
};

__device__ __forceinline__ Groups groups_of(const uint8_t* m, int n) {
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(m) & 15)) & 15);
  head = head < n ? head : n;
  const int vecs = (n - head) / 16;
  const int tail = head + vecs * 16;
  return {head, vecs, tail, head + vecs + (n - tail)};
}

// Group g's first pixel and its mask bits (bit j: pixel first + j).
__device__ __forceinline__ uint32_t group_bits(const uint8_t* m, const Groups& G, int g,
                                               int& first) {
  if (g < G.head || g >= G.head + G.vecs) {
    first = g < G.head ? g : G.tail + (g - G.head - G.vecs);
    return m[first] != 0;
  }
  first = G.head + 16 * (g - G.head);
  const uint4 v = *reinterpret_cast<const uint4*>(m + first);
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) bits |= (((words[q] >> (8 * b)) & 0xffu) != 0) << (4 * q + b);
  }
  return bits;
}

struct Map {
  const uint32_t* sc;
  const uint8_t* m;
  uint32_t sentinel;  // the sentinel's order image
  bool is_float;
  bool below;  // the tier listed: masked-in pixels under the sentinel; else the survivors
  __device__ __forceinline__ uint32_t order(int idx) const {
    return order_of(__ldg(sc + idx), is_float);
  }
  __device__ __forceinline__ bool in_tier(uint32_t o) const {
    return below ? o < sentinel : o > sentinel;
  }
};

// Shared memory of the scans, the list's cursor, the counts and the select.
struct Shared {
  int warps[kWarps + 1];
  int cursor, mask_total;
  int hist[256];
  uint32_t select_word;
  int select_left;
};

// Calls body(first, tier bits) for every group of the map, every thread
// the same number of times (body may use warp collectives); returns the
// thread's count of mask bits.
template <typename Body>
__device__ __forceinline__ int for_groups(const Map& M, const Groups& G, Body body) {
  int mask_bits = 0;
  for (int base = 0; base < G.total; base += kThreads) {
    const int g = base + threadIdx.x;
    int first = 0;
    uint32_t surv = 0;
    if (g < G.total) {
      uint32_t bits = group_bits(M.m, G, g, first);
      mask_bits += __popc(bits);
      while (bits) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        if (M.in_tier(M.order(first + j))) surv |= 1u << j;
      }
    }
    body(first, surv);
  }
  return mask_bits;
}

// Appends keys of the tier's pixels in `take` (bits of the group at `first`) at
// a shared cursor, a warp scan and one atomic a warp; keys past `capacity`
// are counted and dropped.
__device__ __forceinline__ void append_keys(const Map& M, int first, uint32_t take,
                                            int* cursor, unsigned long long* list,
                                            int capacity) {
  const int lane = threadIdx.x % kLanes;
  const int c = __popc(take);
  const int incl = warp_inclusive(c, lane);
  int base = 0;
  if (lane == kLanes - 1 && incl) base = atomicAdd(cursor, incl);
  base = __shfl_sync(kAll, base, kLanes - 1);
  int pos = base + incl - c;
  while (take) {
    const int j = __ffs(take) - 1;
    take &= take - 1;
    if (pos < capacity) {
      const uint32_t hi = ~M.order(first + j);
      list[pos] = (static_cast<unsigned long long>(hi) << 32) | static_cast<uint32_t>(first + j);
    }
    ++pos;
  }
}

// Calls emit(pixel, rank) for the first `limit` pixels of the map, in flat
// order, for which pred(pixel) holds: tiles of kThreads x kWalkItems
// pixels, a block scan a tile, stopping once `limit` are found. Returns
// how many were emitted.
template <typename Pred, typename Emit>
__device__ int ordered_walk(int n, int limit, int* warps, Pred pred, Emit emit) {
  int done = 0;
  for (int base = 0; base < n && done < limit; base += kThreads * kWalkItems) {
    const int first = base + threadIdx.x * kWalkItems;
    uint32_t hits = 0;
#pragma unroll
    for (int j = 0; j < kWalkItems; ++j) {
      if (first + j < n && pred(first + j)) hits |= 1u << j;
    }
    int total;
    int rank = done + block_exclusive(__popc(hits), warps, total);
    while (hits) {
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      if (rank < limit) emit(first + j, rank);
      ++rank;
    }
    done += total;
  }
  return done < limit ? done : limit;
}

// Bitonic steps of sequence size `size`, strides `stride` down to 1, on the
// n keys at s (a power of two), whose first key is key `base` of the list.
__device__ void bitonic_steps(unsigned long long* s, int n, int base, int size, int stride) {
  for (; stride > 0; stride >>= 1) {
    for (int t = threadIdx.x; t < n / 2; t += kThreads) {
      const int i = 2 * t - (t & (stride - 1)), j = i + stride;
      const bool up = ((base + i) & size) == 0;
      const unsigned long long a = s[i], b = s[j];
      if ((a > b) == up) {
        s[i] = b;
        s[j] = a;
      }
    }
    __syncthreads();
  }
}

// Sorts the n keys at s (n a power of two) ascending, or for base != 0 in
// the direction the whole network gives key `base`'s run.
__device__ void bitonic_sort(unsigned long long* s, int n, int base) {
  for (int size = 2; size <= n; size <<= 1) bitonic_steps(s, n, base, size, size >> 1);
}

__device__ void copy_keys(unsigned long long* dst, const unsigned long long* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  __syncthreads();
}

// Sorts p keys of device memory (p a power of two above the chunk): each
// chunk in shared memory, then for each larger sequence size its strides
// of a chunk and more in device memory and the rest a chunk at a time.
__device__ void sort_device(unsigned long long* g, int p, unsigned long long* s, int chunk) {
  for (int c0 = 0; c0 < p; c0 += chunk) {
    copy_keys(s, g + c0, chunk);
    bitonic_sort(s, chunk, c0);
    copy_keys(g + c0, s, chunk);
  }
  for (int size = 2 * chunk; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride >= chunk; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const bool up = (i & size) == 0;
        const unsigned long long a = g[i], b = g[j];
        if ((a > b) == up) {
          g[i] = b;
          g[j] = a;
        }
      }
      __syncthreads();
    }
    for (int c0 = 0; c0 < p; c0 += chunk) {
      copy_keys(s, g + c0, chunk);
      bitonic_steps(s, chunk, c0, size, chunk >> 1);
      copy_keys(g + c0, s, chunk);
    }
  }
}

// Writes the first k pixels of M's tier in key order to slots [at, at + k)
// of the frame's lists (out: the frame's first slot). `found` of the
// tier's keys were appended to `list` (at most `capacity` kept); where
// more were found, a radix select of the k-th key's score word (four 8-bit
// digits from the top) and an ordered walk for its ties refill the list.
__device__ void write_tier(const Map& M, const Groups& G, const Layer& Y, size_t out, int at,
                           int k, int found, int capacity, unsigned long long* list,
                           unsigned long long* chunk, int chunk_keys, Shared& S) {
  const int n = Y.h * Y.w;
  int listed = found;
  if (found > capacity) {
    if (threadIdx.x == 0) {
      S.select_word = 0u;
      S.select_left = k;
    }
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < 256; i += kThreads) S.hist[i] = 0;
      __syncthreads();
      const uint32_t prefix = S.select_word;
      const uint32_t high = shift == 24 ? 0u : ~0u << (shift + 8);
      for_groups(M, G, [&](int first, uint32_t surv) {
        while (surv) {
          const int j = __ffs(surv) - 1;
          surv &= surv - 1;
          const uint32_t hi = ~M.order(first + j);
          if ((hi & high) == prefix) atomicAdd(&S.hist[(hi >> shift) & 0xffu], 1);
        }
      });
      __syncthreads();
      if (threadIdx.x == 0) {
        int left = S.select_left, d = 0;
        while (S.hist[d] < left) left -= S.hist[d++];
        S.select_word = prefix | static_cast<uint32_t>(d) << shift;
        S.select_left = left;
      }
      __syncthreads();
    }
    const uint32_t word = S.select_word;
    const int ties = S.select_left;
    if (threadIdx.x == 0) S.cursor = 0;
    __syncthreads();
    for_groups(M, G, [&](int first, uint32_t surv) {
      uint32_t above = 0;
      for (uint32_t s = surv; s;) {
        const int j = __ffs(s) - 1;
        s &= s - 1;
        if (~M.order(first + j) < word) above |= 1u << j;
      }
      append_keys(M, first, above, &S.cursor, list, capacity);
    });
    __syncthreads();
    const int above = S.cursor;
    ordered_walk(
        n, ties, S.warps,
        [&](int p) { return M.m[p] != 0 && ~M.order(p) == word; },
        [&](int p, int rank) {
          list[above + rank] = (static_cast<unsigned long long>(word) << 32) |
                               static_cast<uint32_t>(p);
        });
    __syncthreads();
    listed = k;
  }

  // Sort the listed keys, padded to a power of two.
  const int p = next_pow2(listed);
  for (int i = listed + threadIdx.x; i < p; i += kThreads) list[i] = kPad;
  __syncthreads();
  const unsigned long long* sorted = list;
  if (list == chunk) {
    bitonic_sort(chunk, p, 0);
  } else if (p <= chunk_keys) {
    copy_keys(chunk, list, p);
    bitonic_sort(chunk, p, 0);
    sorted = chunk;
  } else {
    sort_device(list, p, chunk, chunk_keys);
  }

  const int head = listed < k ? listed : k;
  for (int i = threadIdx.x; i < head; i += kThreads) {
    const int idx = static_cast<int>(static_cast<uint32_t>(sorted[i]));
    const int y = idx / Y.w;
    const size_t slot = out + at + i;
    Y.xs[slot] = idx - y * Y.w;
    Y.ys[slot] = y;
    Y.top[slot] = __ldg(M.sc + idx);
    Y.valid[slot] = 1;
  }
}

__global__ void __launch_bounds__(kThreads, 1) candidates_kernel(const Layers L) {
  extern __shared__ unsigned long long chunk[];
  __shared__ Shared S;

  const int li = blockIdx.x / L.frames, frame = blockIdx.x - li * L.frames;
  Layer Y = L.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLayers; ++i) {
    if (i == li) Y = L.l[i];
  }
  const int n = Y.h * Y.w, k = Y.k;
  const size_t plane = static_cast<size_t>(frame) * n;
  const bool is_float = L.is_float != 0;
  const uint32_t sentinel_bits = is_float ? 0xff800000u : 0x80000000u;
  Map M{Y.scores + plane, Y.mask + plane, order_of(sentinel_bits, is_float), is_float, false};
  const Groups G = groups_of(M.m, n);
  const int capacity = next_pow2(k);
  unsigned long long* list =
      Y.scratch ? Y.scratch + static_cast<size_t>(frame) * capacity : chunk;
  if (threadIdx.x == 0) {
    S.cursor = 0;
    S.mask_total = 0;
  }
  __syncthreads();

  // Every survivor's key into the list, while it fits; the mask bits counted.
  int bits = for_groups(M, G, [&](int first, uint32_t surv) {
    append_keys(M, first, surv, &S.cursor, list, capacity);
  });
  bits = warp_inclusive(bits, threadIdx.x % kLanes);
  if (threadIdx.x % kLanes == kLanes - 1 && bits) atomicAdd(&S.mask_total, bits);
  __syncthreads();
  const int survivors = S.cursor;
  if (threadIdx.x == 0) L.counts[static_cast<size_t>(frame) * L.n_cols + Y.col] = S.mask_total;
  if (k == 0) return;

  const size_t out = static_cast<size_t>(frame) * k;
  write_tier(M, G, Y, out, 0, k, survivors, capacity, list, chunk, L.chunk_keys, S);
  if (survivors >= k) return;

  // The slots after the survivors: the first pixels at the sentinel.
  const int fills = ordered_walk(
      n, k - survivors, S.warps,
      [&](int idx) { return M.m[idx] == 0 || M.order(idx) == M.sentinel; },
      [&](int idx, int rank) {
        const size_t at = out + survivors + rank;
        const int y = idx / Y.w;
        Y.xs[at] = idx - y * Y.w;
        Y.ys[at] = y;
        Y.top[at] = sentinel_bits;
        Y.valid[at] = M.m[idx] != 0;
      });
  const int rest = k - survivors - fills;
  if (rest == 0) return;

  // The slots left: the masked-in pixels under the sentinel (float scores
  // only), as many as there are slots or more, listed like the survivors.
  M.below = true;
  __syncthreads();
  if (threadIdx.x == 0) S.cursor = 0;
  __syncthreads();
  for_groups(M, G, [&](int first, uint32_t below) {
    append_keys(M, first, below, &S.cursor, list, capacity);
  });
  __syncthreads();
  write_tier(M, G, Y, out, survivors + fills, rest, S.cursor, capacity, list, chunk,
             L.chunk_keys, S);
}

}  // namespace

// host_layers: n_layers x kFields int64, a layer's: scores, mask, xs, ys,
// top, valid, scratch (0: the shared route), h, w, k, its column of the
// counts. Every layer holds `frames` frames; counts is (frames, n_cols).
extern "C" int brisk_layer_candidates(const int64_t* host_layers, int n_layers, int frames,
                                      int n_cols, int is_float, void* counts, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || frames < 0 || n_cols < n_layers) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layers L = {};
  int keys = 1;
  for (int l = 0; l < n_layers; ++l) {
    const int64_t* f = host_layers + static_cast<size_t>(l) * kFields;
    const int64_t h = f[7], w = f[8], k = f[9], col = f[10];
    if (h < 1 || w < 1 || h * w >= (1LL << 30) || k < 0 || k > h * w || col < 0 ||
        col >= n_cols) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int cap = 1;
    while (cap < k) cap <<= 1;
    if (f[6] == 0 && cap > kChunkKeys) return static_cast<int>(cudaErrorInvalidValue);
    const int need = f[6] == 0 ? cap : kChunkKeys;
    keys = need > keys ? need : keys;
    Layer& Y = L.l[l];
    Y.scores = reinterpret_cast<const uint32_t*>(f[0]);
    Y.mask = reinterpret_cast<const uint8_t*>(f[1]);
    Y.xs = reinterpret_cast<int32_t*>(f[2]);
    Y.ys = reinterpret_cast<int32_t*>(f[3]);
    Y.top = reinterpret_cast<uint32_t*>(f[4]);
    Y.valid = reinterpret_cast<uint8_t*>(f[5]);
    Y.scratch = reinterpret_cast<unsigned long long*>(f[6]);
    Y.h = static_cast<int>(h);
    Y.w = static_cast<int>(w);
    Y.k = static_cast<int>(k);
    Y.col = static_cast<int>(col);
  }
  L.n = n_layers;
  L.frames = frames;
  L.n_cols = n_cols;
  L.is_float = is_float != 0;
  L.chunk_keys = keys;
  L.counts = static_cast<int32_t*>(counts);
  const long long blocks = static_cast<long long>(frames) * n_layers;
  if (blocks == 0) return 0;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(candidates_kernel, static_cast<int>(blocks), kThreads,
                                 keys * static_cast<int>(sizeof(unsigned long long)),
                                 static_cast<cudaStream_t>(stream), L));
}

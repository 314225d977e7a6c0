// The score-ordered candidate lists of a Harris pyramid on Hopper (kernel
// layer_candidates): every layer of a detection in one launch, a cluster of
// C CTAs a (layer, frame).
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
//   * A survivor is a masked-in pixel that beats the sentinel. Its sort key
//     is the order-preserving image of its score, inverted (the "word"):
//     ascending words are descending scores. Float scores order as
//     lax.top_k orders them, by the IEEE total order of their bits (+0.0
//     above -0.0, a NaN by its sign beyond the infinities). The survivors
//     are listed in flat order, so a stable sort of the words alone gives
//     the ties to the lower index.
//   * Where fewer than k survive, the slots after them are the lowest-index
//     pixels at the sentinel (masked out, or masked in at the sentinel
//     itself), in flat order: their score is the sentinel and their m the
//     mask's bit.
//   * After those, on float scores, come the masked-in pixels under the
//     sentinel (a NaN with its sign set), ordered by their words as the
//     survivors are, each with its own score.
//
// Bound: bytes. The mask is read once (1 B a pixel), a masked-in pixel's
// score sector (32 B) once, and each slot written (13 B).
//
// Design: the map of a (layer, frame) is cut into C contiguous slices of
// its mask groups (16 pixels, one 16-byte load; the plane's unaligned head
// and tail a pixel a group), one CTA of a thread-block cluster a slice, so
// a VGA layer is walked by C SMs. A thread takes 4 groups of a tile (64
// pixels as 64-bit sets) and loads their masked-in pixels' scores 8 at a
// time, so a tile costs about two round trips to memory. The walk counts
// the slice's survivors, pixels under the sentinel and mask bits, and
// stages its survivors' keys (word above flat index) in flat order, a
// block scan a tile, in the CTA's own room: half again its share of the
// list in shared memory, or its k / C places of a device-memory scratch.
// The counts, exchanged through distributed shared memory (DSMEM), give
// each CTA its offset in the list; each staged key is then stored at its
// place, by a DSMEM store into the CTA that owns it (an even cut of the
// list over the cluster) or into the scratch. A CTA whose survivors passed
// its room lists them by a second walk. The list is sorted by a stable LSD
// radix sort on the 32-bit word, 8 bits a pass: each pass builds the
// cluster's 256-bin histogram through DSMEM and scans it; each warp ranks
// a contiguous segment of the CTA's keys in rounds of 32 (__match_any_sync,
// so in thread order: the rank of a key counts the equal digits before it
// in the CTA, the warp and the round), and stores each key at its rank. A
// pass whose digit is one bin for every key would leave the order as it
// is and is skipped before it starts: the AND and OR of the listed words,
// gathered with the listing, show the digits that vary (int32 Harris
// scores above the threshold share their top bytes). Where more than k
// survive, a radix select over the slices (four passes of 8-bit digits
// from the top, histograms summed through DSMEM) finds the k-th key's word
// T and how many of the ties at T are taken; a listing walk takes the
// survivors under T and, in flat order over the cluster, the first ties
// at T, so the sort runs on k keys. The fills come from an ordered walk of
// each slice from its offset among the cluster's pixels at the sentinel,
// which stops once the slots are filled; what slots are left take the
// tier under the sentinel, listed, selected and sorted as the survivors
// are. Every decision follows the cluster's totals, so the CTAs of a
// cluster pass the same cluster barriers. The keys live in shared memory
// (a CTA's share of the list, ceil(k / C) keys, and the staging room)
// where the share fits kPartKeys, else in the wrapper's device scratch
// (two lists of k keys a frame, L2-resident), where the same passes run.
// candidates.launch_plan picks C for the launch: about one wave of CTAs
// (8 a list, halved while the launch passes 256 CTAs), 16 for one or two
// VGA lists. The grid is layer-major, so the largest layer's clusters
// start first.

#include <cooperative_groups.h>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr int kMaxLayers = 8;
constexpr int kFields = 11;         // int64 fields of a layer in the host table
constexpr int kMaxCluster = 16;     // CTAs a list (above 8: a non-portable cluster)
constexpr int kPartKeys = 5632;     // keys of a CTA's share of a list in shared memory
constexpr int kBufferKeys = 11264;  // keys of a CTA's two shared buffers together
constexpr int kSharedBytes = 18432; // the Shared struct's room at the front of shared memory
constexpr int kTileGroups = 4;      // mask groups a thread takes a tile (64 pixels)
constexpr int kInFlight = 8;        // score loads a thread issues together
constexpr int kMinSegment = 128;    // keys a warp ranks at least in a sort pass
constexpr int kBins = 256;          // 8-bit digits
constexpr unsigned kAll = 0xffffffffu;
static_assert(kWarps <= kLanes, "one warp scans the warps' totals");
static_assert(kBins <= kThreads, "a thread a bin");
static_assert(kThreads * kTileGroups * 16 <= 32768, "a tile's counts pack in 16 bits");

struct Layer {
  const uint32_t* scores;  // (B, h, w) int32 or float32 bits
  const uint8_t* mask;     // (B, h, w) bool
  int32_t* xs;             // (B, k)
  int32_t* ys;             // (B, k)
  uint32_t* top;           // (B, k), the scores' type
  uint8_t* valid;          // (B, k) bool
  unsigned long long* scratch;  // (B, 2, k) keys: the device route; null: shared memory
  int h, w, k, col;        // col: the layer's column of the counts
};

struct Layers {
  Layer l[kMaxLayers];
  int n;
  int frames;
  int n_cols;      // columns of the counts (every layer of the detection)
  int is_float;
  int cluster;     // CTAs a list
  int part;        // keys of the first shared buffer
  int stage;       // keys of the second (>= part), which first stages a slice's survivors
  int32_t* counts;  // (B, n_cols)
  int32_t* passes;  // (B, n_cols) or null: the survivors' radix passes run (bits 0-3), skipped (4-7)
};

// A CTA's shared scalars and tables, at the front of its shared memory; the
// fields marked "cluster" are read by the cluster's other CTAs.
struct Shared {
  int whist[kWarps][kBins];  // a warp's digit counts, then its keys' first ranks
  int hist[kBins];           // cluster: this CTA's digit counts
  unsigned warps[kWarps + 1];
  int pub[4];                // cluster: this CTA's published counts
  int all[4][kMaxCluster];   // every rank's published counts
  int sums[4];
  unsigned word_and, word_or;  // cluster: the AND and OR of this CTA's listed words
  unsigned all_and, all_or;    // the cluster's
  int sel_digit, sel_left, sel_above, sel_ties;
};
static_assert(sizeof(Shared) <= kSharedBytes, "the shared struct fits its room");

// The order-preserving unsigned image of a score (on floats, of the IEEE
// total order).
__device__ __forceinline__ uint32_t order_of(uint32_t bits, bool is_float) {
  if (!is_float) return bits ^ 0x80000000u;
  return (bits & 0x80000000u) ? ~bits : bits | 0x80000000u;
}

__device__ __forceinline__ unsigned warp_inclusive(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const unsigned t = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The block's exclusive prefix of v and its total. Every thread calls it.
__device__ __forceinline__ unsigned block_exclusive(unsigned v, unsigned* warps,
                                                    unsigned& total) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const unsigned incl = warp_inclusive(v, lane);
  if (lane == kLanes - 1) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < kWarps ? warps[lane] : 0u;
    const unsigned wi = warp_inclusive(w, lane);
    if (lane < kWarps) warps[lane] = wi - w;
    if (lane == kWarps - 1) warps[kWarps] = wi;
  }
  __syncthreads();
  const unsigned out = warps[warp] + incl - v;
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

__device__ __forceinline__ int group_first(const Groups& G, int g) {
  if (g < G.head) return g;
  if (g < G.head + G.vecs) return G.head + 16 * (g - G.head);
  return G.tail + (g - G.head - G.vecs);
}

struct Map {
  const uint32_t* sc;
  const uint8_t* m;
  uint32_t sentinel;  // the sentinel's order image
  bool is_float;
  __device__ __forceinline__ uint32_t word(int idx) const {
    return ~order_of(__ldg(sc + idx), is_float);
  }
};

// A thread's groups of a tile: each group's first pixel and the tile's
// pixels as 64-bit sets (bit 16 * j + b: pixel first[j] + b): all of them,
// the masked-in ones, the survivors and those under the sentinel.
struct Tile {
  int first[kTileGroups];
  unsigned long long all, mask, surv, below;
  __device__ __forceinline__ int pixel(int pos) const {
    const int j = pos >> 4;
    int f = first[0];
#pragma unroll
    for (int i = 1; i < kTileGroups; ++i) f = j == i ? first[i] : f;
    return f + (pos & 15);
  }
  __device__ __forceinline__ unsigned long long tier(bool under) const {
    return under ? below : surv;
  }
};

__device__ __forceinline__ int lowest(unsigned long long bits) {
  return __ffsll(static_cast<long long>(bits)) - 1;
}

// This thread's groups of the tile at `base` (groups base + t * kTileGroups
// + j of the slice ending at g1): the mask loads first, then the scores of
// the masked-in pixels, kInFlight loads issued together a round.
__device__ __forceinline__ void load_tile(const Map& M, const Groups& G, int base, int g1,
                                          Tile& t) {
  uint4 v[kTileGroups];
  t.all = t.mask = t.surv = t.below = 0ull;
#pragma unroll
  for (int j = 0; j < kTileGroups; ++j) {
    const int g = base + static_cast<int>(threadIdx.x) * kTileGroups + j;
    t.first[j] = 0;
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (g >= g1) continue;
    t.first[j] = group_first(G, g);
    if (g < G.head || g >= G.head + G.vecs) {
      t.all |= 1ull << (16 * j);
      v[j].x = M.m[t.first[j]];
    } else {
      t.all |= 0xffffull << (16 * j);
      v[j] = __ldg(reinterpret_cast<const uint4*>(M.m + t.first[j]));
    }
  }
#pragma unroll
  for (int j = 0; j < kTileGroups; ++j) {
    const uint32_t words[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    unsigned long long bits = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        bits |= static_cast<unsigned long long>(((words[a] >> (8 * b)) & 0xffu) != 0)
                << (4 * a + b);
      }
    }
    t.mask |= (bits << (16 * j)) & t.all;
  }
  for (unsigned long long rest = t.mask; rest;) {
    int pos[kInFlight];
    uint32_t sc[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      pos[k] = rest ? lowest(rest) : -1;
      rest &= rest - 1;
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) sc[k] = pos[k] >= 0 ? __ldg(M.sc + t.pixel(pos[k])) : 0u;
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (pos[k] < 0) continue;
      const uint32_t o = order_of(sc[k], M.is_float);
      if (o > M.sentinel) t.surv |= 1ull << pos[k];
      else if (o < M.sentinel) t.below |= 1ull << pos[k];
    }
  }
}

// Calls body(tile) for every tile of the slice [g0, g1), every thread the
// same number of times (body may use barriers), while it returns true
// (which it must do alike in every thread).
template <typename Body>
__device__ __forceinline__ void walk(const Map& M, const Groups& G, int g0, int g1, Body body) {
  for (int base = g0; base < g1; base += kThreads * kTileGroups) {
    Tile t;
    load_tile(M, G, base, g1, t);
    if (!body(t)) break;
  }
}

// Publishes this CTA's four counts and gathers every rank's into S.all.
__device__ void gather(cg::cluster_group& cl, Shared& S, int C, int a, int b, int c, int d) {
  if (threadIdx.x == 0) {
    S.pub[0] = a;
    S.pub[1] = b;
    S.pub[2] = c;
    S.pub[3] = d;
  }
  cl.sync();
  if (threadIdx.x < 4 * C) {
    const int r = threadIdx.x / 4, f = threadIdx.x % 4;
    S.all[f][r] = cl.map_shared_rank(S.pub, r)[f];
  }
  __syncthreads();
  cl.sync();  // no CTA rewrites S.pub while another reads it
}

// The cluster's sum of hist[d] (and the ranks' before `rank`), every
// rank's count loaded before any is added.
__device__ __forceinline__ unsigned cluster_sum(cg::cluster_group& cl, int* hist, int d, int C,
                                                int rank, unsigned& earlier) {
  int v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = r < C ? cl.map_shared_rank(hist, r)[d] : 0;
  unsigned tot = 0;
  earlier = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    tot += static_cast<unsigned>(v[r]);
    if (r < rank) earlier += static_cast<unsigned>(v[r]);
  }
  return tot;
}

// Where a list's keys live: two buffers, each cut evenly over the cluster
// (rank r owns places [r * part, (r + 1) * part)).
struct Keys {
  unsigned long long* buf[2];  // shared: this CTA's buffers; device: the frame's two lists
  bool shared;
  int part;
  __device__ __forceinline__ unsigned long long* place(cg::cluster_group& cl, int b,
                                                       int pos) const {
    if (!shared) return buf[b] + pos;
    const int owner = pos / part;
    return cl.map_shared_rank(buf[b], owner) + (pos - owner * part);
  }
  __device__ __forceinline__ unsigned long long* mine(int b, int rank) const {
    return shared ? buf[b] : buf[b] + static_cast<size_t>(rank) * part;
  }
  // Key i of a part that mine() gave: from device memory past L1, which
  // may hold the lines of an earlier pass.
  __device__ __forceinline__ unsigned long long load(const unsigned long long* p, int i) const {
    return shared ? p[i] : __ldcg(p + i);
  }
};

__device__ __forceinline__ unsigned long long key_of(uint32_t word, int idx) {
  return (static_cast<unsigned long long>(word) << 32) | static_cast<uint32_t>(idx);
}

// One list: its map, its slice and where its keys and slots go.
struct List {
  Map M;
  Groups G;
  Layer Y;
  int rank, C, g0, g1;
  size_t out;  // the frame's first slot
  unsigned long long* buf[2];
  unsigned long long* staging;  // this CTA's room for its slice's survivors
  int stage;                    // keys it holds
};

// Lists the first `limit` pixels of a tier (the survivors, or with `under`
// the masked-in pixels under the sentinel) by word, ties in flat order, at
// slots [at, at + listed) and returns listed = min(total, limit). `total`
// is the cluster's count of the tier, `before` the ranks' before this one,
// `mine` this slice's. `staged`: this slice's whole tier sits in flat order
// in its staging room (the survivors, where the count walk staged them).
// Every CTA of the cluster calls it alike.
__device__ int list_tier(cg::cluster_group& cl, Shared& S, const List& T, bool under, int total,
                         int before, int mine, int limit, int at, bool staged, int* passes) {
  const int listed = total < limit ? total : limit;
  if (listed <= 0) return 0;
  const int tid = threadIdx.x, lane = tid % kLanes, warp = tid / kLanes;
  const Map& M = T.M;

  // Where more are in the tier than listed: the listed-th word T and the
  // ties at it to take, by four 8-bit digits from the top over the cluster.
  const bool select = total > limit;
  uint32_t cut = 0u;
  int taken_before = before, ties_mine = 0;  // this CTA's first place; the ties it takes
  if (select) {
    int left = limit, above = 0, ties = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < kBins; i += kThreads) S.hist[i] = 0;
      __syncthreads();
      const uint32_t high = shift == 24 ? 0u : ~0u << (shift + 8);
      walk(M, T.G, T.g0, T.g1, [&](const Tile& t) {
        for (unsigned long long bits = t.tier(under); bits; bits &= bits - 1) {
          const uint32_t w = M.word(t.pixel(lowest(bits)));
          if ((w & high) == cut) atomicAdd(&S.hist[(w >> shift) & 0xffu], 1);
        }
        return true;
      });
      __syncthreads();
      cl.sync();
      unsigned tot = 0, own = 0, earlier;
      if (tid < kBins) {
        own = static_cast<unsigned>(S.hist[tid]);
        tot = cluster_sum(cl, S.hist, tid, T.C, T.rank, earlier);
      }
      unsigned sum;
      const unsigned ex_tot = block_exclusive(tot, S.warps, sum);
      const unsigned ex_own = block_exclusive(own, S.warps, sum);
      if (tid < kBins && static_cast<int>(ex_tot) < left && left <= static_cast<int>(ex_tot + tot)) {
        S.sel_digit = tid;
        S.sel_left = left - static_cast<int>(ex_tot);
        S.sel_above = static_cast<int>(ex_own);
        S.sel_ties = static_cast<int>(own);
      }
      __syncthreads();
      cut |= static_cast<uint32_t>(S.sel_digit) << shift;
      left = S.sel_left;
      above += S.sel_above;
      ties = S.sel_ties;
      cl.sync();  // every rank has read S.hist
    }
    // Each slice's count under T and ties at T; the ties taken are the
    // first `left` in flat order over the cluster.
    gather(cl, S, T.C, above, ties, 0, 0);
    int ties_before = 0;
    taken_before = 0;
    for (int r = 0; r < T.C; ++r) {
      const int a = S.all[0][r], t = S.all[1][r];
      int take = left - ties_before;
      take = take < 0 ? 0 : (take > t ? t : take);
      if (r < T.rank) taken_before += a + take;
      if (r == T.rank) ties_mine = take;
      ties_before += t;
    }
  }

  // The listing: the tier's keys in flat order, each at its place, from
  // the staging buffer or by a walk, and the AND and OR of their words,
  // which tell the passes whose digit is one bin for every key.
  const int part = (listed + T.C - 1) / T.C;
  const Keys K{{T.buf[0], T.buf[1]}, T.Y.scratch == nullptr, part};
  if (tid == 0) {
    S.word_and = S.all_and = ~0u;
    S.word_or = S.all_or = 0u;
  }
  __syncthreads();
  unsigned word_and = ~0u, word_or = 0u;
  if (staged && !select) {
    const unsigned long long* st = T.staging;
    for (int i = tid; i < mine; i += kThreads) {
      const unsigned long long key = st[i];
      *K.place(cl, 0, taken_before + i) = key;
      word_and &= static_cast<uint32_t>(key >> 32);
      word_or |= static_cast<uint32_t>(key >> 32);
    }
  } else {
    unsigned done_a = 0, done_e = 0;  // this slice's keys under T and ties at T so far
    walk(M, T.G, T.g0, T.g1, [&](const Tile& t) {
      unsigned long long a = t.tier(under), e = 0;
      if (select) {
        for (unsigned long long bits = a; bits; bits &= bits - 1) {
          const int pos = lowest(bits);
          const uint32_t w = M.word(t.pixel(pos));
          if (w == cut) e |= 1ull << pos;
          else if (w > cut) a &= ~(1ull << pos);
        }
        a &= ~e;
      }
      unsigned sum;
      const unsigned pre =
          block_exclusive(static_cast<unsigned>(__popcll(a)) |
                          (static_cast<unsigned>(__popcll(e)) << 16), S.warps, sum);
      unsigned pa = done_a + (pre & 0xffffu), pe = done_e + (pre >> 16);
      for (unsigned long long bits = a | e; bits; bits &= bits - 1) {
        const int pos = lowest(bits), idx = t.pixel(pos);
        const uint32_t w = M.word(idx);
        int place = -1;
        if ((a >> pos) & 1ull) {
          place = static_cast<int>(pa + (pe < static_cast<unsigned>(ties_mine) ? pe : ties_mine));
          ++pa;
        } else {
          if (pe < static_cast<unsigned>(ties_mine)) place = static_cast<int>(pa + pe);
          ++pe;
        }
        if (place >= 0) {
          *K.place(cl, 0, taken_before + place) = key_of(w, idx);
          word_and &= w;
          word_or |= w;
        }
      }
      done_a += sum & 0xffffu;
      done_e += sum >> 16;
      return true;
    });
  }
  word_and = __reduce_and_sync(kAll, word_and);
  word_or = __reduce_or_sync(kAll, word_or);
  if (lane == 0) {
    atomicAnd(&S.word_and, word_and);
    atomicOr(&S.word_or, word_or);
  }
  __syncthreads();
  cl.sync();  // every key is in place and every rank's word bits published
  if (tid < T.C) {
    atomicAnd(&S.all_and, cl.map_shared_rank(&S.word_and, tid)[0]);
    atomicOr(&S.all_or, cl.map_shared_rank(&S.word_or, tid)[0]);
  }
  __syncthreads();
  const unsigned varies = S.all_and ^ S.all_or;  // the word bits that differ between keys

  // The stable LSD radix sort of the words, 8 bits a pass, each warp
  // ranking a contiguous segment of at least kMinSegment keys.
  int n_mine = listed - T.rank * part;
  n_mine = n_mine < 0 ? 0 : (n_mine > part ? part : n_mine);
  int seg = (n_mine + kWarps - 1) / kWarps;
  seg = seg > kMinSegment ? seg : kMinSegment;
  const int ranking = (n_mine + seg - 1) / seg;  // warps with keys
  const int lo = warp * seg < n_mine ? warp * seg : n_mine;
  const int hi = lo + seg < n_mine ? lo + seg : n_mine;
  int src = 0, ran = 0;
  for (int p = 0; p < 4; ++p) {
    // A digit that is one bin for every key leaves the order as it is.
    if (((varies >> (8 * p)) & 0xffu) == 0) {
      ran |= 1 << (4 + p);
      continue;
    }
    ran |= 1 << p;
    const int shift = 32 + 8 * p;
    for (int i = tid; i < ranking * kBins; i += kThreads) (&S.whist[0][0])[i] = 0;
    __syncthreads();
    const unsigned long long* own = K.mine(src, T.rank);
    for (int i = lo + lane; i < hi; i += kLanes) {
      atomicAdd(&S.whist[warp][static_cast<int>(K.load(own, i) >> shift) & 0xff], 1);
    }
    __syncthreads();
    if (tid < kBins) {
      int run = 0;
      for (int w = 0; w < ranking; ++w) {
        const int t = S.whist[w][tid];
        S.whist[w][tid] = run;
        run += t;
      }
      S.hist[tid] = run;
    }
    __syncthreads();
    cl.sync();
    unsigned tot = 0, earlier = 0;
    if (tid < kBins) tot = cluster_sum(cl, S.hist, tid, T.C, T.rank, earlier);
    unsigned sum;
    const unsigned base = block_exclusive(tot, S.warps, sum);
    if (tid < kBins) {
      for (int w = 0; w < ranking; ++w) S.whist[w][tid] += static_cast<int>(base + earlier);
    }
    __syncthreads();
    for (int i0 = lo; i0 < hi; i0 += kLanes) {
      const int i = i0 + lane;
      const bool act = i < hi;
      const unsigned am = __ballot_sync(kAll, act);
      if (act) {
        const unsigned long long key = K.load(own, i);
        const int d = static_cast<int>(key >> shift) & 0xff;
        const unsigned peers = __match_any_sync(am, d);
        const int r = S.whist[warp][d] + __popc(peers & ((1u << lane) - 1u));
        __syncwarp(am);
        if (lane == __ffs(peers) - 1) S.whist[warp][d] += __popc(peers);
        __syncwarp(am);
        *K.place(cl, src ^ 1, r) = key;
      }
    }
    cl.sync();  // every key is in place; every rank has read S.hist
    src ^= 1;
  }
  if (passes) *passes = ran;

  // The slots of this CTA's places.
  const unsigned long long* fin = K.mine(src, T.rank);
  const Layer& Y = T.Y;
  for (int i = tid; i < n_mine; i += kThreads) {
    const int idx = static_cast<int>(static_cast<uint32_t>(K.load(fin, i)));
    const int y = idx / Y.w;
    const size_t slot = T.out + at + static_cast<size_t>(T.rank) * part + i;
    Y.xs[slot] = idx - y * Y.w;
    Y.ys[slot] = y;
    Y.top[slot] = __ldg(M.sc + idx);
    Y.valid[slot] = 1;
  }
  cl.sync();  // the buffers are free again, and no CTA leaves while another reads its memory
  return listed;
}

__global__ void __launch_bounds__(kThreads, 2) candidates_kernel(const Layers L) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& S = *reinterpret_cast<Shared*>(smem);
  unsigned long long* shared_keys = reinterpret_cast<unsigned long long*>(smem + kSharedBytes);
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  const int C = L.cluster, rank = static_cast<int>(cl.block_rank());
  const int list = blockIdx.x / C;
  const int li = list / L.frames, frame = list - li * L.frames;
  Layer Y = L.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLayers; ++i) {
    if (i == li) Y = L.l[i];
  }
  const int n = Y.h * Y.w, k = Y.k;
  const size_t plane = static_cast<size_t>(frame) * n;
  const bool is_float = L.is_float != 0;
  const uint32_t sentinel_bits = is_float ? 0xff800000u : 0x80000000u;
  List T;
  T.M = {Y.scores + plane, Y.mask + plane, order_of(sentinel_bits, is_float), is_float};
  T.G = groups_of(T.M.m, n);
  T.Y = Y;
  T.rank = rank;
  T.C = C;
  T.g0 = static_cast<int>(static_cast<long long>(T.G.total) * rank / C);
  T.g1 = static_cast<int>(static_cast<long long>(T.G.total) * (rank + 1) / C);
  T.out = static_cast<size_t>(frame) * k;
  if (Y.scratch) {
    // The frame's two lists in device memory; this CTA stages in its own
    // k / C places of the second.
    T.buf[0] = Y.scratch + static_cast<size_t>(frame) * 2 * k;
    T.buf[1] = T.buf[0] + k;
    T.stage = k / C;
    T.staging = T.buf[1] + static_cast<size_t>(rank) * T.stage;
  } else {
    T.buf[0] = shared_keys;
    T.buf[1] = shared_keys + L.part;
    T.stage = L.stage;
    T.staging = T.buf[1];
  }
  const int p0 = T.g0 < T.G.total ? group_first(T.G, T.g0) : n;
  const int p1 = T.g1 < T.G.total ? group_first(T.G, T.g1) : n;

  // The slice's counts (survivors, pixels under the sentinel, mask bits),
  // and its survivors' keys in flat order into the staging buffer while
  // they fit.
  if (tid < 4) S.sums[tid] = 0;
  __syncthreads();
  unsigned c_surv = 0, c_below = 0, c_mask = 0;
  walk(T.M, T.G, T.g0, T.g1, [&](const Tile& t) {
    const unsigned s = static_cast<unsigned>(__popcll(t.surv));
    c_below += static_cast<unsigned>(__popcll(t.below));
    c_mask += static_cast<unsigned>(__popcll(t.mask));
    if (T.stage > 0) {
      unsigned sum;
      unsigned place = c_surv + block_exclusive(s, S.warps, sum);
      for (unsigned long long bits = t.surv; bits && place < static_cast<unsigned>(T.stage);) {
        // kInFlight keys a round, their words loaded together.
        int idx[kInFlight];
        uint32_t word[kInFlight];
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          idx[q] = bits ? t.pixel(lowest(bits)) : -1;
          bits &= bits - 1;
        }
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) word[q] = idx[q] >= 0 ? T.M.word(idx[q]) : 0u;
#pragma unroll
        for (int q = 0; q < kInFlight; ++q) {
          if (idx[q] >= 0 && place < static_cast<unsigned>(T.stage)) {
            T.staging[place] = key_of(word[q], idx[q]);
          }
          place += idx[q] >= 0;
        }
      }
      c_surv += sum;
    } else {
      c_surv += s;
    }
    return true;
  });
  if (T.stage > 0) {
    if (tid == 0) S.sums[0] = static_cast<int>(c_surv);  // a block total already
  } else {
    c_surv = __reduce_add_sync(kAll, c_surv);
  }
  c_below = __reduce_add_sync(kAll, c_below);
  c_mask = __reduce_add_sync(kAll, c_mask);
  if (tid % kLanes == 0) {
    if (T.stage == 0) atomicAdd(&S.sums[0], static_cast<int>(c_surv));
    atomicAdd(&S.sums[1], static_cast<int>(c_below));
    atomicAdd(&S.sums[2], static_cast<int>(c_mask));
  }
  __syncthreads();
  const int my_surv = S.sums[0], my_below = S.sums[1];
  gather(cl, S, C, my_surv, my_below, S.sums[2], p1 - p0);
  int surv = 0, surv_before = 0, below = 0, below_before = 0, masked = 0, fills = 0,
      fills_before = 0;
  for (int r = 0; r < C; ++r) {
    const int s = S.all[0][r], b = S.all[1][r], f = S.all[3][r] - s - b;
    surv += s;
    below += b;
    masked += S.all[2][r];
    fills += f;
    if (r < rank) {
      surv_before += s;
      below_before += b;
      fills_before += f;
    }
  }
  const size_t at_count = static_cast<size_t>(frame) * L.n_cols + Y.col;
  if (rank == 0 && tid == 0) {
    L.counts[at_count] = masked;
    if (L.passes) L.passes[at_count] = 0;
  }
  if (k == 0) return;

  const int head = list_tier(cl, S, T, false, surv, surv_before, my_surv, k, 0,
                             my_surv <= T.stage,
                             L.passes && rank == 0 && tid == 0 ? L.passes + at_count : nullptr);
  const int needed = k - head;
  if (needed == 0) return;

  // The slots after the survivors: the first pixels at the sentinel, each
  // slice from its offset among the cluster's.
  if (fills_before < needed) {
    unsigned done = static_cast<unsigned>(fills_before);
    walk(T.M, T.G, T.g0, T.g1, [&](const Tile& t) {
      const unsigned long long f = t.all & ~(t.surv | t.below);
      unsigned sum;
      unsigned r = done + block_exclusive(static_cast<unsigned>(__popcll(f)), S.warps, sum);
      for (unsigned long long bits = f; bits && r < static_cast<unsigned>(needed);
           bits &= bits - 1, ++r) {
        const int pos = lowest(bits), idx = t.pixel(pos);
        const int y = idx / Y.w;
        const size_t slot = T.out + head + r;
        Y.xs[slot] = idx - y * Y.w;
        Y.ys[slot] = y;
        Y.top[slot] = sentinel_bits;
        Y.valid[slot] = (t.mask >> pos) & 1ull;
      }
      done += sum;
      return done < static_cast<unsigned>(needed);
    });
  }
  const int filled = fills < needed ? fills : needed;
  const int rest = needed - filled;

  // The slots left: the masked-in pixels under the sentinel (float scores
  // only), listed like the survivors.
  list_tier(cl, S, T, true, below, below_before, my_below, rest, head + filled, false, nullptr);
}

// Whether a launch of `cfg` (a cluster of `cluster` CTAs, `smem` bytes of
// dynamic shared memory each) fits the current card, as
// cudaOccupancyMaxActiveClusters says, with the kernel's attributes set for
// it; the answer cached per card and (cluster, smem), the shared-memory
// limit only ever raised, so a launch that passed once costs no more host
// calls.
cudaError_t check_launch(const cudaLaunchConfig_t& cfg, int cluster, int smem) {
  constexpr int kCards = 64;
  constexpr int kPlans = 32;  // (cluster, smem) pairs kept a card
  static std::mutex mu;
  static int limit[kCards] = {};       // the smem limit set, 0: the default 48 KB
  static bool wide[kCards] = {};       // non-portable cluster sizes allowed
  static int plans[kCards][kPlans][2] = {};
  static int n_plans[kCards] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kCards) dev = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_plans[dev]; ++i) {
    if (plans[dev][i][0] == cluster && plans[dev][i][1] == smem) return cudaSuccess;
  }
  if (smem > 48 * 1024 && smem > limit[dev]) {
    err = cudaFuncSetAttribute(candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    limit[dev] = smem;
  }
  if (cluster > 8 && !wide[dev]) {
    err = cudaFuncSetAttribute(candidates_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    wide[dev] = true;
  }
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, candidates_kernel, &cfg);
  if (err == cudaSuccess && active < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess && n_plans[dev] < kPlans) {
    plans[dev][n_plans[dev]][0] = cluster;
    plans[dev][n_plans[dev]][1] = smem;
    ++n_plans[dev];
  }
  return err;
}

}  // namespace

// host_layers: n_layers x kFields int64, a layer's: scores, mask, xs, ys,
// top, valid, scratch (0: the shared route), h, w, k, its column of the
// counts. Every layer holds `frames` frames; counts and passes (or null)
// are (frames, n_cols); `cluster` CTAs a list (1, 2, 4, 8 or 16).
extern "C" int brisk_layer_candidates(const int64_t* host_layers, int n_layers, int frames,
                                      int n_cols, int is_float, int cluster, void* counts,
                                      void* passes, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || frames < 0 || n_cols < n_layers ||
      cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Layers L = {};
  int part = 0, stage = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int64_t* f = host_layers + static_cast<size_t>(l) * kFields;
    const int64_t h = f[7], w = f[8], k = f[9], col = f[10];
    if (h < 1 || w < 1 || h * w >= (1LL << 30) || k < 0 || k > h * w || col < 0 ||
        col >= n_cols) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (f[6] == 0) {
      // A CTA's share of the list, and half as much again (within the two
      // buffers' room) to stage its slice's survivors; more survivors fall
      // back to a second walk of the slice.
      const int need = static_cast<int>((k + cluster - 1) / cluster);
      if (need > kPartKeys) return static_cast<int>(cudaErrorInvalidValue);
      int staged = need + need / 2 < k ? need + need / 2 : static_cast<int>(k);
      staged = staged < kBufferKeys - need ? staged : kBufferKeys - need;
      part = need > part ? need : part;
      stage = staged > stage ? staged : stage;
    }
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
  L.cluster = cluster;
  L.part = part;
  L.stage = stage > part ? stage : part;
  L.counts = static_cast<int32_t*>(counts);
  L.passes = static_cast<int32_t*>(passes);
  const long long blocks = static_cast<long long>(frames) * n_layers * cluster;
  if (blocks == 0) return 0;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem =
      kSharedBytes + (part + L.stage) * static_cast<int>(sizeof(unsigned long long));

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // A cluster of this size with this shared memory must fit the card.
  cudaError_t err = check_launch(cfg, cluster, smem);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, candidates_kernel, L);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

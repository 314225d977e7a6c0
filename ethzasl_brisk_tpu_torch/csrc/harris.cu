// Reference-exact integer Harris scores on Hopper (kernel K1), and the
// same scores with their 2-D maxima mask (kernel K3).
//
// K1 replaces the Pallas TPU kernel ethzasl_brisk_tpu/kernels/pallas_harris.py
// (_harris_tile_kernel, reached through harris_score_i32_fused). It computes
// the reference's fixed-point HarrisScoresSSE (harris-scores.cc:53-279),
// uint8 (B, H, W) -> int32 (B, H, W):
//   * Scharr gradients x8 on rows/cols [1, n-2];
//   * products (a*b) >> 16;
//   * 3x3 binomial smoothing (4c + 2*edges + corners) >> 4;
//   * score = sxx*syy - sxy^2 - (((sxx+syy) >> 1)^2 >> 2) on [2, n-3], 0
//     elsewhere.
// K3 replaces _harris_mask_tile_kernel (harris_score_mask_fused): K1's
// scores and, beside them, the mask of kernels/nms.py's maxima2d_mask with
// border 2, as 0/1 bytes:
//   mask = (2 <= y <= H-3) & (2 <= x <= W-3) & score >= thr
//          & max(8 neighbours' scores) <= score.
// Every neighbour of an in-border cell lies on rows/cols [1, n-2], inside
// the image, so the INT32_MIN padding of maxima2d_mask is never observed:
// the mask needs only the scores as K1 writes them (0 off [2, n-3]) on a
// one-cell ring. And max(8 neighbours) <= s is max(the 3x3 cells) <= s,
// which is separable: a horizontal max of 3, then a vertical max of 3.
//
// Separable integer passes, each sum equal to the 2-D one term for term:
//   dx = 24*(hd[y-1] + hd[y+1]) + 80*hd[y],  hd = P[x-1] - P[x+1];
//   dy = 8*(hs[y-1] - hs[y+1]),  hs = 3*(P[x-1] + P[x+1]) + 10*P[x];
//   s.. = (h[y-1] + 2*h[y] + h[y+1]) >> 4,  h = p[x-1] + 2*p[x] + p[x+1].
// Ranges: |hd| <= 255 and |hs| <= 4080, so |dx|, |dy| <= 8*16*255 = 32640
// and dx*dx <= 1,065,369,600 < 2^31; every product, sum and score stays
// inside int32 (|s..| <= 16256, |score| < 2^30): no signed overflow can
// occur. Right shifts of negative values are arithmetic under nvcc, as in
// the reference and in torch. Products need no interior mask: the score at
// [2, n-3] reads products on [1, n-2] only, whose gradients read pixels
// inside the image; everything else is masked to 0 at the end.
//
// Design: registers and shuffles, no shared memory; one body for both
// kernels, K3's additions under a compile-time flag. A warp owns a tile of
// 120 columns and a strip of output rows of one frame; lane l holds
// columns x0 + 4l - 4 .. x0 + 4l - 1, lanes 1..30 write them and lanes 0
// and 31 are the tile's halo. The warp walks down the strip's pixel rows
// (K1: a 2-row halo above and below; K3: 3, for the ring). Per row each lane
//   * reads one aligned 4-byte word, takes its neighbour lane's next word
//     by shuffle and funnel-shifts its 4 pixels out of the pair (rows of
//     426 and 213 bytes are not 4-byte aligned);
//   * takes the pixels left and right of its columns from its neighbours,
//     forms hd and hs, then dx, dy and the products of the row above, and
//     the horizontal [1, 2, 1] sums of the products with the neighbours'
//     edge products by shuffle;
//   * completes the vertical sums of the row above that and writes its
//     scores, as one 16-byte store where the row pitch allows (W = 640,
//     320), two 8-byte (W = 426) or four 4-byte (W = 213).
// K3's ring: lane 0's columns 2-3 (the tile's columns -2, -1) and lane 31's
// columns 0-1 (120, 121) read only pixels and products that their
// neighbour lanes hold correctly, so their scores are right; lanes 0 and
// 31 compute them too. Per score row K3 then takes the horizontal max of 3
// (the edge scores by shuffle), carries the row's scores and the pairwise
// max of the last two rows of horizontal maxima, and one row after a score
// row writes that row's mask: 4 bytes a lane, one 4-byte store where the
// address is aligned (W = 640, 320), else two 2-byte or four 1-byte stores.
// Each lane carries down its columns the partial sums that the next rows
// complete (hd and hs of two rows, two rows of horizontal sums). K1's
// registers are capped at 96 so that five blocks of four warps fit on an
// SM (a few bytes spill to L1; four blocks without spills measured 1.5 %
// slower). K3 carries 12 values more and is capped at 128, four blocks
// (five spilled more and measured ~50 % slower, three 6-10 % slower;
// strips of 24 and 60 rows measured 2-8 % slower than 40). Once every
// carried value is live, every row emits a score row (K3: and a mask row):
// that steady loop is unrolled by three without branches, so the carried
// values rename without copies and one row's loads and shuffles overlap
// the previous row's arithmetic. Each pixel row is loaded three rows ahead
// of its use. All pyramid layers go in one
// launch: the grid is flattened over every layer's (frame, strip, tile)
// warps, and each warp finds its layer in a by-value table of at most 8
// layers.
//
// Bound: bytes. Per pixel K1 moves 1 byte in and 4 out, K3 one byte more,
// against 46 int32 operations for K1 (gradients 11, products 6, smoothing
// 21, score 8) and 53 for K3 (the maximum 4: the horizontal max of 3, and
// the vertical max of the carried pair with the new row and the new pair;
// the two compares and their and, 3) at 33.5 Tops/s. The tiles overlap by
// 2 lanes and the strips by 4 rows (K3: 6); the ragged last tile of a row
// leaves ~12 % of the lanes idle at the four VGA widths.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kTileCols = (kLanes - 2) * 4;  // output columns of a warp
constexpr int kStrip = 40;                   // output rows of a warp
constexpr int kWarps = 4;                    // warps per block
constexpr int kMaxLayers = 8;
constexpr unsigned kAll = 0xffffffffu;

struct Layer {
  const uint8_t* img;
  int32_t* out;
  uint8_t* mask;      // K3 only
  int B, H, W;
  int tiles, strips;  // column tiles of a row, row strips of a frame
  int first_warp;     // the layer's first warp in the flattened grid
};

struct Layers {
  Layer l[kMaxLayers];
  int n;
  int warps;
  int thr;  // K3's threshold, one for all layers
};

template <bool kMask>
__device__ __forceinline__ void harris_rows(const Layers& layers) {
  // K3 computes one more score row above and below the strip (the ring).
  constexpr int kRing = kMask ? 1 : 0;
  const int warp = blockIdx.x * kWarps + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  if (warp >= layers.warps) return;
  int li = 0;
  while (li + 1 < layers.n && warp >= layers.l[li + 1].first_warp) ++li;
  const Layer L = layers.l[li];
  int w = warp - L.first_warp;
  const int tile = w % L.tiles;
  w /= L.tiles;
  const int strip = w % L.strips;
  const int b = w / L.strips;
  const int H = L.H, W = L.W;
  const int x0 = tile * kTileCols - 4 + 4 * lane;  // this lane's first column
  const int r0 = strip * kStrip;
  const int r1 = min(r0 + kStrip, H);
  // Byte positions count from the aligned word at or below the layer's
  // base (32-bit: the wrapper keeps layers under 2^31 bytes); the layer's
  // bytes are positions [mis, end).
  const int mis = (int)(reinterpret_cast<uintptr_t>(L.img) & 3);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(L.img - mis);
  const int end = mis + L.B * H * W;
  const int frame = mis + b * H * W + x0;  // this lane's first byte of row 0
  int32_t* out = L.out + (size_t)b * H * W;

  // Pixel rows r0-2-kRing .. r1+1+kRing; row y_first+i lives in slot i % 3.
  const int y_first = r0 - 2 - kRing;
  const int n_rows = r1 - r0 + 4 + 2 * kRing;
  uint32_t wv[3], wx[3];  // a row's aligned word, and lane 31's next one
  // The aligned words holding row y's bytes of this lane (0 off the layer
  // and off the rows the strip reads).
  auto fetch = [&](int slot, int y) {
    const bool row_ok = y >= 0 && y < H && y < r1 + 2 + kRing;
    const int a = (frame + y * W) >> 2;  // word index (floor)
    wv[slot] = row_ok && 4 * a + 4 > mis && 4 * a < end ? __ldg(words + a) : 0u;
    wx[slot] = row_ok && lane == kLanes - 1 && 4 * a + 8 > mis && 4 * a + 4 < end
                   ? __ldg(words + a + 1) : 0u;
  };
  fetch(0, y_first);
  fetch(1, y_first + 1);
  fetch(2, y_first + 2);

  // Carried down the strip, per column: hd of row y-1; 24*hd[y-2] +
  // 80*hd[y-1]; hs of rows y-1 and y-2; and of the horizontal sums, h[g-1]
  // and h[g-2] + 2*h[g-1] (g = y-1, the gradient row of step y).
  int hd1[4] = {}, pdx[4] = {}, hs1[4] = {}, hs2[4] = {};
  int col_in = 0;  // bit c: column x0 + c lies in [2, W-3]
#pragma unroll
  for (int c = 0; c < 4; ++c) col_in |= (x0 + c >= 2 && x0 + c <= W - 3) << c;
  int hm1[3][4] = {}, acc[3][4] = {};  // [xx, yy, xy][column]
  // K3: the scores of score row s-1, the horizontal max of 3 of row s-1,
  // and the max of rows s-2 and s-1 of those (s, the score row of a step).
  int sc1[4] = {}, hx1[4] = {}, hx2max[4] = {};

  // Step i reads pixel row y = y_first + i into slot i % 3; phase 0 only
  // forms hd and hs, phase 1 also the gradient row y-1, phase 2 also the
  // score row y-2, phase 3 (K3) also the mask row y-3. Phases are
  // compile-time, so the steady loop below is straight-line code whose
  // rows the compiler can overlap.
  auto step = [&](auto slot_c, auto phase_c, int i) {
    constexpr int k = decltype(slot_c)::value;
    constexpr int phase = decltype(phase_c)::value;
    const int y = y_first + i;
    // This lane's 4 pixels from its word and the next lane's word.
    const uint32_t nxt = __shfl_down_sync(kAll, wv[k], 1);
    const uint32_t pix = __funnelshift_r(wv[k], lane == kLanes - 1 ? wx[k] : nxt,
                                         8 * ((frame + y * W) & 3));
    fetch(k, y + 3);
    const uint32_t left = __shfl_up_sync(kAll, pix, 1) >> 24;
    const uint32_t right = __shfl_down_sync(kAll, pix, 1) & 0xffu;
    int q[6];
    q[0] = (int)left;
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c + 1] = (int)((pix >> (8 * c)) & 0xffu);
    q[5] = (int)right;
    int hd[4], hs[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      hd[c] = q[c] - q[c + 2];
      hs[c] = 3 * (q[c] + q[c + 2]) + 10 * q[c + 1];
    }
    if constexpr (phase >= 1) {
      // Gradient row g = y-1: its products, and their horizontal [1, 2, 1]
      // sums with the neighbour lanes' edge products.
      int p[3][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dx = pdx[c] + 24 * hd[c];
        const int dy = 8 * (hs2[c] - hs[c]);
        p[0][c] = (dx * dx) >> 16;
        p[1][c] = (dy * dy) >> 16;
        p[2][c] = (dx * dy) >> 16;
      }
      int hm[3][4];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int pl = __shfl_up_sync(kAll, p[m][3], 1);
        const int pr = __shfl_down_sync(kAll, p[m][0], 1);
        hm[m][0] = pl + 2 * p[m][0] + p[m][1];
        hm[m][1] = p[m][0] + 2 * p[m][1] + p[m][2];
        hm[m][2] = p[m][1] + 2 * p[m][2] + p[m][3];
        hm[m][3] = p[m][2] + 2 * p[m][3] + pr;
      }
      // Score row s = g-1 = y-2 from the sums of rows g-2, g-1 and g.
      const int s = y - 2;
      const bool inner = lane != 0 && lane != kLanes - 1;
      int v[4];
      auto scores = [&] {
        const bool row_in = s >= 2 && s <= H - 3;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int sxx = (acc[0][c] + hm[0][c]) >> 4;
          const int syy = (acc[1][c] + hm[1][c]) >> 4;
          const int sxy = (acc[2][c] + hm[2][c]) >> 4;
          const int th = (sxx + syy) >> 1;
          const int score = sxx * syy - sxy * sxy - ((th * th) >> 2);
          v[c] = row_in && (col_in >> c & 1) ? score : 0;
        }
      };
      auto store_scores = [&] {
        int32_t* o = out + (size_t)s * W + x0;
        const uintptr_t oa = reinterpret_cast<uintptr_t>(o);
        if (x0 + 3 < W) {
          if (oa % 16 == 0) {
            *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
          } else if (oa % 8 == 0) {
            reinterpret_cast<int2*>(o)[0] = make_int2(v[0], v[1]);
            reinterpret_cast<int2*>(o)[1] = make_int2(v[2], v[3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) o[c] = v[c];
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (x0 + c < W) o[c] = v[c];
          }
        }
      };
      if constexpr (!kMask) {
        if (phase == 2 && inner) {
          scores();
          store_scores();
        }
      } else if constexpr (phase >= 2) {
        // Every lane scores, for the ring; rows r0-1 and r1 are not written.
        scores();
        if (inner && s >= r0 && s < r1) store_scores();
        const int sl = __shfl_up_sync(kAll, v[3], 1);
        const int sr = __shfl_down_sync(kAll, v[0], 1);
        int hx[4];
        hx[0] = max(max(sl, v[0]), v[1]);
        hx[1] = max(max(v[0], v[1]), v[2]);
        hx[2] = max(max(v[1], v[2]), v[3]);
        hx[3] = max(max(v[2], v[3]), sr);
        if (phase == 3 && inner) {
          // Mask row s-1: its scores, against the max of 3 x 3 cells.
          const int ms = s - 1;
          const bool row_in = ms >= 2 && ms <= H - 3;
          uint32_t bits = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bool m = row_in && (col_in >> c & 1) && sc1[c] >= layers.thr &&
                           max(hx2max[c], hx[c]) <= sc1[c];
            bits |= (uint32_t)m << (8 * c);
          }
          uint8_t* o = L.mask + (size_t)b * H * W + (size_t)ms * W + x0;
          const uintptr_t oa = reinterpret_cast<uintptr_t>(o);
          if (x0 + 3 < W && oa % 4 == 0) {
            *reinterpret_cast<uint32_t*>(o) = bits;
          } else if (x0 + 3 < W && oa % 2 == 0) {
            reinterpret_cast<uint16_t*>(o)[0] = (uint16_t)bits;
            reinterpret_cast<uint16_t*>(o)[1] = (uint16_t)(bits >> 16);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (x0 + c < W) o[c] = (uint8_t)(bits >> (8 * c));
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          hx2max[c] = max(hx1[c], hx[c]);
          hx1[c] = hx[c];
          sc1[c] = v[c];
        }
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[m][c] = hm1[m][c] + 2 * hm[m][c];
          hm1[m][c] = hm[m][c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pdx[c] = 24 * hd1[c] + 80 * hd[c];
      hd1[c] = hd[c];
      hs2[c] = hs1[c];
      hs1[c] = hs[c];
    }
  };

  using P0 = std::integral_constant<int, 0>;
  using P1 = std::integral_constant<int, 1>;
  using P2 = std::integral_constant<int, 2>;
  using P3 = std::integral_constant<int, 3>;
  step(P0{}, P0{}, 0);  // the first two rows: hd, hs only
  step(P1{}, P0{}, 1);
  step(P2{}, P1{}, 2);  // the next two: gradient rows
  step(P0{}, P1{}, 3);
  int i = 4;
  if constexpr (kMask) {
    step(P1{}, P2{}, 4);  // score rows r0-1 (the ring) and r0
    step(P2{}, P2{}, 5);
    i = 6;
  }
  // Steady: K1's score rows r0 .. r1-1; K3's score rows r0+1 .. r1 and mask
  // rows r0 .. r1-1. The first steady step reads slot i % 3.
  constexpr int F = kMask ? 0 : 1;
  using Steady = std::conditional_t<kMask, P3, P2>;
  using SA = std::integral_constant<int, F>;
  using SB = std::integral_constant<int, (F + 1) % 3>;
  using SC = std::integral_constant<int, (F + 2) % 3>;
  for (; i + 3 <= n_rows; i += 3) {
    step(SA{}, Steady{}, i);
    step(SB{}, Steady{}, i + 1);
    step(SC{}, Steady{}, i + 2);
  }
  if (i < n_rows) step(SA{}, Steady{}, i);
  if (i + 1 < n_rows) step(SB{}, Steady{}, i + 1);
}

__global__ void __launch_bounds__(kWarps * kLanes, 5) harris_rows_kernel(const Layers layers) {
  harris_rows<false>(layers);
}

__global__ void __launch_bounds__(kWarps * kLanes, 4) harris_mask_rows_kernel(const Layers layers) {
  harris_rows<true>(layers);
}

// The layer table of n layers: imgs[i] uint8 (B, H, W), outs[i] int32 and
// masks[i] (K3; null for K1) of the same shape, dims[3i .. 3i+2] = B, H, W.
int layer_table(const void* const* imgs, void* const* outs, void* const* masks,
                const int* dims, int n, int thr, Layers& layers) {
  if (n < 1 || n > kMaxLayers) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    if ((long long)dims[3 * i] * dims[3 * i + 1] * dims[3 * i + 2] + 2LL * dims[3 * i + 2] + 256 >
        INT_MAX)
      return (int)cudaErrorInvalidValue;
  }
  int warps = 0;
  for (int i = 0; i < n; ++i) {
    Layer& L = layers.l[i];
    L.img = (const uint8_t*)imgs[i];
    L.out = (int32_t*)outs[i];
    L.mask = masks ? (uint8_t*)masks[i] : nullptr;
    L.B = dims[3 * i];
    L.H = dims[3 * i + 1];
    L.W = dims[3 * i + 2];
    L.tiles = (L.W + kTileCols - 1) / kTileCols;
    L.strips = (L.H + kStrip - 1) / kStrip;
    L.first_warp = warps;
    warps += L.B * L.tiles * L.strips;
  }
  layers.n = n;
  layers.warps = warps;
  layers.thr = thr;
  return 0;
}

}  // namespace

// K1 on n pyramid layers in one launch: imgs[i] uint8 (B, H, W) and outs[i]
// int32 (B, H, W) with dims[3i .. 3i+2] = B, H, W.
extern "C" int brisk_harris_score_layers(const void* const* imgs, void* const* outs,
                                         const int* dims, int n, void* stream) {
  Layers layers{};
  if (const int err = layer_table(imgs, outs, nullptr, dims, n, 0, layers)) return err;
  if (layers.warps == 0) return 0;
  const unsigned blocks = (unsigned)((layers.warps + kWarps - 1) / kWarps);
  harris_rows_kernel<<<blocks, kWarps * kLanes, 0, (cudaStream_t)stream>>>(layers);
  return (int)cudaGetLastError();
}

// K3 on n pyramid layers in one launch: K1's arguments, and masks[i] bool
// (B, H, W) for the 2-D maxima at threshold thr.
extern "C" int brisk_harris_score_mask_layers(const void* const* imgs, void* const* outs,
                                              void* const* masks, const int* dims, int n,
                                              int thr, void* stream) {
  Layers layers{};
  if (const int err = layer_table(imgs, outs, masks, dims, n, thr, layers)) return err;
  if (layers.warps == 0) return 0;
  const unsigned blocks = (unsigned)((layers.warps + kWarps - 1) / kWarps);
  harris_mask_rows_kernel<<<blocks, kWarps * kLanes, 0, (cudaStream_t)stream>>>(layers);
  return (int)cudaGetLastError();
}

extern "C" const char* brisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

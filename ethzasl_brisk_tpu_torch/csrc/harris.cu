// Reference-exact integer Harris scores on Hopper (kernel K1).
//
// Replaces the Pallas TPU kernel ethzasl_brisk_tpu/kernels/pallas_harris.py
// (_harris_tile_kernel, reached through harris_score_i32_fused). It computes
// the reference's fixed-point HarrisScoresSSE (harris-scores.cc:53-279),
// uint8 (B, H, W) -> int32 (B, H, W):
//   * Scharr gradients x8 on rows/cols [1, n-2];
//   * products (a*b) >> 16;
//   * 3x3 binomial smoothing (4c + 2*edges + corners) >> 4;
//   * score = sxx*syy - sxy^2 - (((sxx+syy) >> 1)^2 >> 2) on [2, n-3], 0
//     elsewhere.
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
// Design: registers and shuffles, no shared memory. A warp owns a tile of
// 120 columns and a strip of 40 output rows of one frame; lane l holds
// columns x0 + 4l - 4 .. x0 + 4l - 1, lanes 1..30 write them and lanes 0
// and 31 are the tile's halo. The warp walks down the strip's 44 pixel rows
// (2-row halo above and below). Per row each lane
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
// Each lane carries down its columns the partial sums that the next rows
// complete (hd and hs of two rows, two rows of horizontal sums). Registers
// are capped at 96 so that five blocks of four warps fit on an SM (a few
// bytes spill to L1; four blocks without spills measured 1.5 % slower).
// After the first four rows every row emits a score row: that steady loop
// is unrolled by three without branches, so the carried values rename
// without copies and one row's loads and shuffles overlap the previous
// row's arithmetic. Each pixel row is loaded three rows ahead of its use.
// All pyramid layers go in one launch: the grid is flattened over every
// layer's (frame, strip, tile) warps, and each warp finds its layer in a
// by-value table of at most 8 layers.
//
// Bound: bytes. Per pixel 1 byte in and 4 out, against 46 int32 operations
// (gradients 11, products 6, smoothing 21, score 8) at 33.5 Tops/s. The
// tiles overlap by 2 lanes and the strips by 4 rows (10 %); the ragged last
// tile of a row leaves ~12 % of the lanes idle at the four VGA widths.

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
  int B, H, W;
  int tiles, strips;  // column tiles of a row, row strips of a frame
  int first_warp;     // the layer's first warp in the flattened grid
};

struct Layers {
  Layer l[kMaxLayers];
  int n;
  int warps;
};

__global__ void __launch_bounds__(kWarps * kLanes, 5) harris_rows_kernel(const Layers layers) {
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

  // Pixel rows r0-2 .. r1+1; row r0-2+i lives in slot i % 3.
  const int y_first = r0 - 2;
  const int n_rows = r1 - r0 + 4;
  uint32_t wv[3], wx[3];  // a row's aligned word, and lane 31's next one
  // The aligned words holding row y's bytes of this lane (0 off the layer
  // and off the rows the strip reads).
  auto fetch = [&](int slot, int y) {
    const bool row_ok = y >= 0 && y < H && y < r1 + 2;
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

  // Step i reads pixel row y = y_first + i into slot i % 3; phase 0 only
  // forms hd and hs, phase 1 also the gradient row y-1, phase 2 also the
  // score row y-2. Phases are compile-time, so the steady loop below is
  // straight-line code whose rows the compiler can overlap.
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
      if (phase == 2 && lane != 0 && lane != kLanes - 1) {
        // Score row s = g-1 = y-2 from the sums of rows g-2, g-1 and g.
        const int s = y - 2;
        const bool row_in = s >= 2 && s <= H - 3;
        int v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int sxx = (acc[0][c] + hm[0][c]) >> 4;
          const int syy = (acc[1][c] + hm[1][c]) >> 4;
          const int sxy = (acc[2][c] + hm[2][c]) >> 4;
          const int th = (sxx + syy) >> 1;
          const int score = sxx * syy - sxy * sxy - ((th * th) >> 2);
          v[c] = row_in && (col_in >> c & 1) ? score : 0;
        }
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

  using S0 = std::integral_constant<int, 0>;
  using S1 = std::integral_constant<int, 1>;
  using S2 = std::integral_constant<int, 2>;
  step(S0{}, S0{}, 0);  // rows r0-2, r0-1
  step(S1{}, S0{}, 1);
  step(S2{}, S1{}, 2);  // rows r0, r0+1: gradient rows r0-1, r0
  step(S0{}, S1{}, 3);
  int i = 4;  // rows r0+2 .. r1+1: score rows r0 .. r1-1
  for (; i + 3 <= n_rows; i += 3) {
    step(S1{}, S2{}, i);
    step(S2{}, S2{}, i + 1);
    step(S0{}, S2{}, i + 2);
  }
  if (i < n_rows) step(S1{}, S2{}, i);
  if (i + 1 < n_rows) step(S2{}, S2{}, i + 1);
}

}  // namespace

// K1 on n pyramid layers in one launch: imgs[i] uint8 (B, H, W) and outs[i]
// int32 (B, H, W) with dims[3i .. 3i+2] = B, H, W.
extern "C" int brisk_harris_score_layers(const void* const* imgs, void* const* outs,
                                         const int* dims, int n, void* stream) {
  if (n < 1 || n > kMaxLayers) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    if ((long long)dims[3 * i] * dims[3 * i + 1] * dims[3 * i + 2] + 2LL * dims[3 * i + 2] + 256 >
        INT_MAX)
      return (int)cudaErrorInvalidValue;
  }
  Layers layers{};
  int warps = 0;
  for (int i = 0; i < n; ++i) {
    Layer& L = layers.l[i];
    L.img = (const uint8_t*)imgs[i];
    L.out = (int32_t*)outs[i];
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
  if (warps == 0) return 0;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  harris_rows_kernel<<<blocks, kWarps * kLanes, 0, (cudaStream_t)stream>>>(layers);
  return (int)cudaGetLastError();
}

extern "C" const char* brisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

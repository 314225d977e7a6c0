// The integer candidate masks of a Harris pyramid on Hopper (kernel
// score_masks): the 2-D maxima and the 3-D checks against the neighbour
// layers, every layer of a detection in one launch.
//
// No TPU kernel: it stands for XLA work of the JAX package,
// ethzasl_brisk_tpu/detect/scale_space.py:429-550 (layer_score_masks'
// integer path: maxima2d_mask of kernels/nms.py:29-37, warp_scores_split,
// _max3x3_pair, center_ge_warped). Per pixel (x, y) of layer i, int32
// scores s, bool output:
//   * 2-D: s >= thr and no 8-neighbour greater, on rows and columns
//     [2, n-3] (whose neighbours all lie in the map, so the reference's
//     INT32_MIN outside it is never read); or K3's mask byte, where the
//     table gives one (fused_mask);
//   * above (layer i+1; map (A, B, D) = (4, -1, 6) on octave layers,
//     (6, -1, 8) between): s * D^2 >= the maximum of the 9 probes at
//     (x+dx, y+dy), dx, dy in {-1, 0, 1}. A probe outside layer i reads 0;
//     inside, the D^2-scaled bilinear sum of layer i+1 at
//     u = (A*x'+B)/D, v = (A*y'+B)/D:
//       W = (D-fv)*((D-fu)*p00 + fu*p01) + fv*((D-fu)*p10 + fu*p11),
//     with u0 = trunc((A*x'+B)/D) (C division), fu = A*x'+B - u0*D (signed:
//     u0 = 0 at A*x'+B = -1 takes fu = -1 and extrapolates), and W = 0
//     where u0 < 0, u0+1 >= cols, v0 < 0 or v0+1 >= rows (the reference's
//     bilinear is undefined; harris-score-calculator.h:57-74);
//   * below (layer i-1; (12, 2, 9) or (24, 3, 16)): one probe at (x, y).
// Products and sums in int64: |W| <= 4 * 17^2 * 2^31 < 2^42.
//
// Bound: bytes. Each score is read once (4 B) and each mask byte written
// once (1 B; the fused path reads K3's byte too), against 25 int32
// operations a pixel for the 2-D test and ~275 a survivor of it for the
// probes (~5 % of the pixels on the bench frames).
//
// Design: a CTA of 256 threads takes a tile of 32 rows x 128 columns of
// one (frame, layer). It stages the tile's scores with a one-pixel halo in
// shared memory (asynchronous word copies, 18 a thread, no registers;
// word copies and byte stores need no row alignment, so widths 426 and 213
// take the same path). Each warp then takes a strip of 4 rows, a lane a
// column in 4 steps of 32: per column it reads the strip's 6 halo rows'
// 3 cells (4.5 shared reads a pixel), takes the 3x3 maximum separably (no
// 8-neighbour greater is the 3x3 maximum, centre included, at most the
// centre), stores the bytes that fail the 2-D test (32 consecutive bytes a
// warp store) and appends the survivors to the warp's own segment of a
// shared list by ballot and popcount: no atomic, no shuffle. After a
// barrier the CTA's threads take the survivors in turn and run the 10
// probes, every tap an __ldg from L2 or L1: a tap that the sum does not
// use reads the survivor's own score instead, so all 40 loads issue
// together and none leaves its layer. The grid is frame-major: a frame's tiles of every layer are neighbours
// in the grid, so the neighbour layers' taps are read while L2 still
// holds them. Every layer of the launch lies in a by-value table of at
// most 8; an entry carries its neighbours' pointers, so a longer pyramid
// splits into launches without an entry losing its neighbour.

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;
constexpr int kTileW = 128;  // columns of a CTA's tile
constexpr int kTileH = 32;   // rows of a CTA's tile
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloH = kTileH + 2;
constexpr int kStaged = kHaloW * kHaloH;
constexpr int kStripRows = kTileH / kWarps;  // a warp's rows
constexpr int kMaxLayers = 8;
constexpr int kFields = 17;  // int64 fields of a layer in the host table
constexpr unsigned kAll = 0xffffffffu;
static_assert(kTileW % kLanes == 0, "a warp row covers the tile's columns in whole steps");
static_assert(kTileH % kWarps == 0, "the warps' strips cover the tile's rows");
static_assert(kTileW * kTileH <= 65536, "a survivor's place in the tile fits 16 bits");

struct Neighbour {
  const int32_t* scores;  // (B, rows, cols)
  int rows, cols;
  int a, b, d;            // u -> (a*u + b) / d; d == 0: no such layer
};

struct Layer {
  const int32_t* scores;   // (B, h, w)
  const uint8_t* in_mask;  // K3's 2-D maxima, (B, h, w), or null
  uint8_t* out;            // (B, h, w)
  int h, w;
  int tiles_x;             // column tiles of a row
  int first_tile;          // the layer's first tile in a frame's run of tiles
  Neighbour above, below;
};

struct Layers {
  Layer l[kMaxLayers];
  int n;
  int tiles;  // tiles a frame, over every layer
  int thr;
};

struct Axis {
  int i0, f;
  bool ok;
};

// The map (a*u + b) / d at u: index truncated toward zero (C division, as
// the reference), the signed fraction numerator, and whether the bilinear
// is defined along this axis.
__device__ __forceinline__ Axis axis(int u, int limit, int a, int b, int d) {
  const int val = a * u + b;
  const int i0 = val / d;
  return {i0, val - i0 * d, i0 >= 0 && i0 + 1 < limit};
}

// The D^2-scaled bilinear sum of one frame of a neighbour layer, or 0 where
// !ok; then every tap reads `safe` (a valid word) instead.
__device__ __forceinline__ long long bilinear(const int32_t* src, int cols, Axis v, Axis u,
                                              int d, bool ok, const int32_t* safe) {
  const int32_t* p = ok ? src + ((long long)v.i0 * cols + u.i0) : safe;
  const int dc = ok ? 1 : 0, dr = ok ? cols : 0;
  const long long p00 = __ldg(p), p01 = __ldg(p + dc);
  const long long p10 = __ldg(p + dr), p11 = __ldg(p + dr + dc);
  const long long gu = d - u.f, gv = d - v.f;
  const long long s = gv * (gu * p00 + u.f * p01) + v.f * (gu * p10 + u.f * p11);
  return ok ? s : 0;
}

// The 3-D checks of a survivor at (x, y) of frame `frame` of layer Y.
__device__ __forceinline__ bool passes_3d(const Layer& Y, int frame, int x, int y,
                                          long long s, const int32_t* safe) {
  bool pass = true;
  if (Y.above.d) {
    const Neighbour& N = Y.above;
    const int32_t* src = N.scores + (size_t)frame * N.rows * N.cols;
    Axis vs[3], us[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      vs[k] = axis(y + k - 1, N.rows, N.a, N.b, N.d);
      us[k] = axis(x + k - 1, N.cols, N.a, N.b, N.d);
    }
    long long top = LLONG_MIN;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = y + ky - 1;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = x + kx - 1;
        // Outside layer i the probe reads 0, as an undefined sum does.
        const bool inside = yy >= 0 && yy < Y.h && xx >= 0 && xx < Y.w;
        const long long p = bilinear(src, N.cols, vs[ky], us[kx], N.d,
                                     inside && vs[ky].ok && us[kx].ok, safe);
        top = p > top ? p : top;
      }
    }
    pass = s * (N.d * N.d) >= top;
  }
  if (Y.below.d) {
    const Neighbour& N = Y.below;
    const int32_t* src = N.scores + (size_t)frame * N.rows * N.cols;
    const Axis v = axis(y, N.rows, N.a, N.b, N.d), u = axis(x, N.cols, N.a, N.b, N.d);
    const long long below = bilinear(src, N.cols, v, u, N.d, v.ok && u.ok, safe);
    pass = pass && s * (N.d * N.d) >= below;
  }
  return pass;
}

__global__ void __launch_bounds__(kThreads, 4) score_masks_kernel(const Layers L) {
  __shared__ int32_t tile[kHaloH][kHaloW];
  __shared__ uint16_t survivors[kWarps][kStripRows * kTileW];  // a segment a warp
  __shared__ int counts[kWarps];

  const int frame = blockIdx.x / L.tiles;
  int t = blockIdx.x - frame * L.tiles;
  int li = 0;
  while (li + 1 < L.n && t >= L.l[li + 1].first_tile) ++li;
  Layer Y = L.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLayers; ++i) {
    if (i == li) Y = L.l[i];
  }
  t -= Y.first_tile;
  const int h = Y.h, w = Y.w;
  const int x0 = (t % Y.tiles_x) * kTileW, y0 = (t / Y.tiles_x) * kTileH;
  const size_t plane = (size_t)frame * h * w;
  const int32_t* sc = Y.scores + plane;

  // Stage rows y0-1 .. y0+kTileH and columns x0-1 .. x0+kTileW by
  // asynchronous copies, 0 outside the map: a pixel on rows and columns
  // [2, n-3], the only ones the 2-D test can pass, reads no such cell.
  for (int i = threadIdx.x; i < kStaged; i += kThreads) {
    const int r = i / kHaloW, c = i - r * kHaloW;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    const bool in_map = y >= 0 && y < h && x >= 0 && x < w;
    __pipeline_memcpy_async(&tile[0][0] + i, in_map ? sc + (size_t)y * w + x : sc, 4,
                            in_map ? 0 : 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const bool checks = Y.above.d != 0 || Y.below.d != 0;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int r0 = warp * kStripRows;  // the strip's first tile row
  int n_warp = 0;                    // the warp's survivors so far
#pragma unroll
  for (int k = 0; k < kTileW / kLanes; ++k) {
    const int c = lane + k * kLanes;
    const int x = x0 + c;
    // Horizontal maxima of the strip's halo rows r0-1 .. r0+kStripRows.
    int hmax[kStripRows + 2] = {};
    if (!Y.in_mask) {
#pragma unroll
      for (int j = 0; j < kStripRows + 2; ++j) {
        hmax[j] = max(max(tile[r0 + j][c], tile[r0 + j][c + 1]), tile[r0 + j][c + 2]);
      }
    }
#pragma unroll
    for (int j = 0; j < kStripRows; ++j) {
      const int r = r0 + j, y = y0 + r;
      const bool in = x < w && y < h;
      const size_t at = plane + (size_t)y * w + x;
      bool pass = false;
      if (in) {
        if (Y.in_mask) {
          pass = Y.in_mask[at] != 0;
        } else {
          const int s = tile[r + 1][c + 1];
          pass = x >= 2 && x <= w - 3 && y >= 2 && y <= h - 3 && s >= L.thr &&
                 max(max(hmax[j], hmax[j + 1]), hmax[j + 2]) <= s;
        }
      }
      if (!checks) {
        if (in) Y.out[at] = pass;
        continue;
      }
      const unsigned ballot = __ballot_sync(kAll, pass);
      if (pass) {
        survivors[warp][n_warp + __popc(ballot & ((1u << lane) - 1u))] =
            (uint16_t)(r * kTileW + c);
      }
      n_warp += __popc(ballot);
      if (in && !pass) Y.out[at] = 0;
    }
  }
  if (!checks) return;
  if (lane == 0) counts[warp] = n_warp;
  __syncthreads();

  // The survivors of every warp in turn: j -> (warp segment, place).
  int first[kWarps + 1];
  first[0] = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) first[i + 1] = first[i] + counts[i];
  for (int j = threadIdx.x; j < first[kWarps]; j += kThreads) {
    int seg = 0;
#pragma unroll
    for (int i = 1; i < kWarps; ++i) seg += j >= first[i];
    int place = j;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) place -= i == seg ? first[i] : 0;
    const int idx = survivors[seg][place];
    const int r = idx / kTileW, c = idx % kTileW;
    const int x = x0 + c, y = y0 + r;
    const size_t at = (size_t)y * w + x;
    Y.out[plane + at] = passes_3d(Y, frame, x, y, tile[r + 1][c + 1], sc + at);
  }
}

}  // namespace

// host_layers: n_layers x kFields int64, a layer's: scores, K3's mask (0:
// the kernel's own 2-D test), out, h, w; then above and below, each
// scores, rows, cols, a, b, d (d 0: no such layer). Every layer holds
// `frames` frames. thr: the 2-D test's threshold.
extern "C" int brisk_score_masks(const int64_t* host_layers, int n_layers, int frames, int thr,
                                 void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || frames < 0) return (int)cudaErrorInvalidValue;
  Layers L = {};
  long long tiles = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int64_t* f = host_layers + (size_t)l * kFields;
    const int64_t h = f[3], w = f[4];
    if (h < 1 || w < 1 || h >= (1 << 24) || w >= (1 << 24)) return (int)cudaErrorInvalidValue;
    Layer& Y = L.l[l];
    Y.scores = reinterpret_cast<const int32_t*>(f[0]);
    Y.in_mask = reinterpret_cast<const uint8_t*>(f[1]);
    Y.out = reinterpret_cast<uint8_t*>(f[2]);
    Y.h = (int)h;
    Y.w = (int)w;
    Y.tiles_x = (int)((w + kTileW - 1) / kTileW);
    Y.first_tile = (int)tiles;
    tiles += Y.tiles_x * ((h + kTileH - 1) / kTileH);
    Neighbour* nb[2] = {&Y.above, &Y.below};
    for (int k = 0; k < 2; ++k) {
      const int64_t* g = f + 5 + 6 * k;
      const int64_t rows = g[1], cols = g[2], a = g[3], b = g[4], d = g[5];
      if (d < 0 || d > 64 || rows < 0 || cols < 0 || rows >= (1 << 24) || cols >= (1 << 24) ||
          a < 0 || a > 64 || b < -64 || b > 64) {
        return (int)cudaErrorInvalidValue;
      }
      *nb[k] = {reinterpret_cast<const int32_t*>(g[0]), (int)rows, (int)cols, (int)a, (int)b,
                (int)d};
    }
  }
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  L.n = n_layers;
  L.tiles = (int)tiles;
  L.thr = thr;
  const long long blocks = (long long)frames * tiles;
  if (blocks == 0) return 0;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  score_masks_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

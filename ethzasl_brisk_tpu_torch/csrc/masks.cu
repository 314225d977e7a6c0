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
// Design: a CTA of 256 threads a tile of 32 rows x 128 columns of one
// (frame, layer), 4 CTAs an SM. The tile's scores with a one-pixel halo,
// and on the fused path K3's mask bytes, are staged in shared memory as the
// 16-byte chunks of device memory that cover each row, a warp a row and a
// lane a chunk; each staged row starts at its address mod 16, kept a row,
// so rows of widths 426 and 213 copy in 16 bytes too and the reads shift by
// the row's offset. A chunk's bytes past the row are never read: a pixel on
// rows and columns [2, n-3], the only ones the 2-D test can pass, reads no
// cell outside the map. Each warp then takes a strip of 4 rows, a lane a
// column in 4 steps of 32: per column it reads the strip's 6 halo rows' 3
// cells, takes the 3x3 maximum separably (no 8-neighbour greater is the
// 3x3 maximum, centre included, at most the centre; the bounds tested once
// a row and once a column), stores the bytes that fail the 2-D test and
// appends the survivors to the warp's own segment of a shared list by
// ballot and popcount. After a barrier the CTA's threads take the survivors
// in turn: the 9 probes above load the survivor's patch
// of layer i+1 (at most 4 x 4 words: the maps shrink, so three neighbouring
// probes' taps span at most 4 columns and 4 rows) into registers once, sum
// its rows at the three probe columns and then each probe down its pair of
// rows; the probe below loads its 4 taps. Those taps come from L2 (and L1):
// staging the tile's footprints of the neighbour layers in shared memory
// too was slower on this card (the times in PERF.md), and so was a
// persistent CTA walking tiles with two staging buffers.
// The grid is frame-major: a frame's tiles of every layer are neighbours,
// so the neighbour layers' taps are read while L2 still holds them. Every
// layer of the launch lies in a by-value table of at most 8; an entry
// carries its neighbours' pointers, so a longer pyramid splits into
// launches without an entry losing its neighbour.

#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;
constexpr int kTileW = 128;  // columns of a tile
constexpr int kTileH = 32;   // rows of a tile
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloH = kTileH + 2;
constexpr int kStripRows = kTileH / kWarps;  // a warp's rows
constexpr int kMaxLayers = 8;
constexpr int kFields = 17;      // int64 fields of a layer in the host table
constexpr int kRowWords = 140;   // a staged score row: 4 words of lead, then the halo row
constexpr int kMaskRowBytes = 160;  // a staged row of K3's mask bytes
constexpr int kScoreBytes = kHaloH * kRowWords * 4;
constexpr int kMaskBytes = kTileH * kMaskRowBytes;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kTileW % kLanes == 0, "a warp row covers the tile's columns in whole steps");
static_assert(kTileH % kWarps == 0, "the warps' strips cover the tile's rows");
static_assert(kTileW * kTileH <= 65536, "a survivor's place in the tile fits 16 bits");
static_assert((kRowWords * 4) % 16 == 0 && kMaskRowBytes % 16 == 0,
              "staged rows start on 16 bytes");
static_assert(kRowWords >= 4 + 3 + kHaloW + 3, "a halo row fits its staged row");
static_assert(kMaskRowBytes >= kTileW + 30, "a mask row fits its staged row");
static_assert(kScoreBytes + kMaskBytes + 2 * kTileH * kTileW + 1024 <= 48 * 1024,
              "the staged rows and the survivor lists need no opt-in past 48 KB");

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

__device__ __forceinline__ int clamp_to(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A neighbour layer's plane of one frame in device memory; a tap's row and
// column clamped into the layer (a patch may reach past it, where its
// probes are undefined and read 0).
struct Taps {
  const int32_t* base;
  int rows, cols;
  __device__ __forceinline__ const int32_t* row(int v) const {
    return base + static_cast<size_t>(clamp_to(v, 0, rows - 1)) * cols;
  }
  __device__ __forceinline__ int32_t at(const int32_t* row, int u) const {
    return __ldg(row + clamp_to(u, 0, cols - 1));
  }
};

__device__ __forceinline__ Taps device_taps(const Neighbour& N, int frame) {
  return {N.scores + static_cast<size_t>(frame) * N.rows * N.cols, N.rows, N.cols};
}

// The value in a row of three picked by o (0, 1, else 2).
template <typename T>
__device__ __forceinline__ T pick(int o, T a, T b, T c) {
  return o == 0 ? a : (o == 1 ? b : c);
}

// The maximum of the 9 probes above a survivor at (x, y) of layer Y: its
// 4 x 4 patch of layer i+1 into registers, the patch rows' sums at the
// three probe columns, then each probe's sum down its pair of rows.
__device__ __forceinline__ long long top_above(const Layer& Y, const Taps& F, int x, int y) {
  const Neighbour& N = Y.above;
  Axis vs[3], us[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    vs[k] = axis(y + k - 1, N.rows, N.a, N.b, N.d);
    us[k] = axis(x + k - 1, N.cols, N.a, N.b, N.d);
  }
  const int pr = vs[0].i0, pc = us[0].i0;
  int32_t P[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int32_t* row = F.row(pr + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) P[i][j] = F.at(row, pc + j);
  }
  long long H[4][3];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    const int o = us[kx].i0 - pc;
    const long long fu = us[kx].f, gu = N.d - us[kx].f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      H[i][kx] = gu * pick(o, P[i][0], P[i][1], P[i][2]) + fu * pick(o, P[i][1], P[i][2], P[i][3]);
    }
  }
  long long top = LLONG_MIN;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int o = vs[ky].i0 - pr, yy = y + ky - 1;
    const long long fv = vs[ky].f, gv = N.d - vs[ky].f;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int xx = x + kx - 1;
      // Outside layer i the probe reads 0, as an undefined sum does.
      const bool ok = yy >= 0 && yy < Y.h && xx >= 0 && xx < Y.w && vs[ky].ok && us[kx].ok;
      const long long s = gv * pick(o, H[0][kx], H[1][kx], H[2][kx]) +
                          fv * pick(o, H[1][kx], H[2][kx], H[3][kx]);
      const long long p = ok ? s : 0;
      top = p > top ? p : top;
    }
  }
  return top;
}

// The probe below a survivor at (x, y): the D^2-scaled bilinear sum of
// layer i-1's 4 taps, or 0 where undefined.
__device__ __forceinline__ long long probe_below(const Layer& Y, const Taps& F, int x, int y) {
  const Neighbour& N = Y.below;
  const Axis v = axis(y, N.rows, N.a, N.b, N.d), u = axis(x, N.cols, N.a, N.b, N.d);
  const int32_t* r0 = F.row(v.i0);
  const int32_t* r1 = F.row(v.i0 + 1);
  const long long p00 = F.at(r0, u.i0), p01 = F.at(r0, u.i0 + 1);
  const long long p10 = F.at(r1, u.i0), p11 = F.at(r1, u.i0 + 1);
  const long long gu = N.d - u.f, gv = N.d - v.f;
  const long long s = gv * (gu * p00 + u.f * p01) + v.f * (gu * p10 + u.f * p11);
  return v.ok && u.ok ? s : 0;
}

// Issues the 16-byte copies of rows [0, rows) of a region, a warp a row and
// a lane a chunk: row r covers device bytes [from, to) (row(r, from, to)
// returns false for no row) and lands at dst + r * stride + lead, the byte
// at `from` at offset (from mod 16) past that, which shifts[r] keeps in
// `unit`s (0 for no row).
template <typename Row>
__device__ __forceinline__ void stage_rows(char* dst, int stride, int lead, int rows,
                                           uint8_t* shifts, int unit, Row row) {
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  for (int r = warp; r < rows; r += kWarps) {
    uintptr_t from = 0, to = 0;
    const bool any = row(r, from, to);
    if (lane == 0) shifts[r] = any ? static_cast<uint8_t>((from & 15) / unit) : 0;
    if (!any) continue;
    const uintptr_t first = from & ~static_cast<uintptr_t>(15);
    for (uintptr_t chunk = first + 16 * lane; chunk < to; chunk += 16 * kLanes) {
      __pipeline_memcpy_async(dst + r * stride + lead + (chunk - first),
                              reinterpret_cast<const void*>(chunk), 16);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4) score_masks_kernel(const Layers L) {
  extern __shared__ __align__(16) char staged[];  // scores, K3's mask
  __shared__ uint16_t survivors[kWarps][kStripRows * kTileW];  // a segment a warp
  __shared__ int counts[kWarps];
  __shared__ uint8_t score_sh[kHaloH], mask_sh[kTileH];

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
  const size_t plane = static_cast<size_t>(frame) * h * w;
  const int32_t* sc = Y.scores + plane;
  int32_t* tile = reinterpret_cast<int32_t*>(staged);
  uint8_t* mask = reinterpret_cast<uint8_t*>(staged + kScoreBytes);
  const int xe = x0 + kTileW < w ? x0 + kTileW : w;  // the tile's columns end

  // Rows y0-1 .. y0+kTileH, columns x0-1 .. x0+kTileW of the scores (those
  // in the map: from column 0 where x0 is 0), and K3's bytes of the tile.
  const int xlo = x0 > 0 ? x0 - 1 : 0, xhi = x0 + kTileW + 1 < w ? x0 + kTileW + 1 : w;
  stage_rows(staged, kRowWords * 4, 16, kHaloH, score_sh, 4,
             [&](int r, uintptr_t& from, uintptr_t& to) {
               const int y = y0 - 1 + r;
               if (y < 0 || y >= h) return false;
               const uintptr_t row = reinterpret_cast<uintptr_t>(sc + static_cast<size_t>(y) * w);
               from = row + 4 * static_cast<uintptr_t>(xlo);
               to = row + 4 * static_cast<uintptr_t>(xhi);
               return true;
             });
  if (Y.in_mask) {
    const uint8_t* m = Y.in_mask + plane;
    stage_rows(reinterpret_cast<char*>(mask), kMaskRowBytes, 0, kTileH, mask_sh, 1,
               [&](int r, uintptr_t& from, uintptr_t& to) {
                 const int y = y0 + r;
                 if (y >= h) return false;
                 const uintptr_t row = reinterpret_cast<uintptr_t>(m + static_cast<size_t>(y) * w);
                 from = row + x0;
                 to = row + xe;
                 return true;
               });
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // The 2-D test: the bytes that fail it stored, its survivors listed.
  const bool checks = Y.above.d != 0 || Y.below.d != 0;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int r0 = warp * kStripRows;  // the strip's first tile row
  // Staged row r (tile row r-1) from column x0-1: where x0 is 0 the row
  // starts at column 0, one word on.
  const int shift0 = x0 == 0 ? 1 : 0;
  const int32_t* rows[kStripRows + 2];
#pragma unroll
  for (int j = 0; j < kStripRows + 2; ++j) {
    rows[j] = tile + (r0 + j) * kRowWords + 4 + score_sh[r0 + j] - shift0;
  }
  uint8_t* orow[kStripRows];  // the strip's output rows from column x0
  bool row_in[kStripRows], row_ok[kStripRows];  // in the map; on rows [2, h-3]
#pragma unroll
  for (int j = 0; j < kStripRows; ++j) {
    const int y = y0 + r0 + j;
    orow[j] = Y.out + plane + static_cast<size_t>(y) * w + x0;
    row_in[j] = y < h;
    row_ok[j] = y >= 2 && y <= h - 3;
  }
  int n_warp = 0;  // the warp's survivors so far
#pragma unroll
  for (int k = 0; k < kTileW / kLanes; ++k) {
    const int c = lane + k * kLanes;
    const int x = x0 + c;
    const bool col_in = x < w;
    bool pass[kStripRows];
    if (Y.in_mask) {
#pragma unroll
      for (int j = 0; j < kStripRows; ++j) {
        pass[j] = col_in && row_in[j] &&
                  mask[(r0 + j) * kMaskRowBytes + mask_sh[r0 + j] + c] != 0;
      }
    } else {
      // Horizontal maxima of the strip's halo rows, then each row's 3x3.
      const bool col_ok = x >= 2 && x <= w - 3;
      int hmax[kStripRows + 2], mid[kStripRows + 2];
#pragma unroll
      for (int j = 0; j < kStripRows + 2; ++j) {
        mid[j] = rows[j][c + 1];
        hmax[j] = max(max(rows[j][c], mid[j]), rows[j][c + 2]);
      }
#pragma unroll
      for (int j = 0; j < kStripRows; ++j) {
        const int s = mid[j + 1];
        pass[j] = col_ok && row_ok[j] && s >= L.thr &&
                  max(max(hmax[j], hmax[j + 1]), hmax[j + 2]) <= s;
      }
    }
#pragma unroll
    for (int j = 0; j < kStripRows; ++j) {
      const bool in = col_in && row_in[j];
      if (!checks) {
        if (in) orow[j][c] = pass[j];
        continue;
      }
      const unsigned ballot = __ballot_sync(kAll, pass[j]);
      if (pass[j]) {
        survivors[warp][n_warp + __popc(ballot & ((1u << lane) - 1u))] =
            static_cast<uint16_t>((r0 + j) * kTileW + c);
      }
      n_warp += __popc(ballot);
      if (in && !pass[j]) orow[j][c] = 0;
    }
  }
  if (!checks) return;
  if (lane == 0) counts[warp] = n_warp;
  __syncthreads();

  // The survivors of every warp in turn: j -> (warp segment, place).
  const Taps above = device_taps(Y.above, frame), below = device_taps(Y.below, frame);
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
    const long long s = tile[(r + 1) * kRowWords + 4 + score_sh[r + 1] - shift0 + c + 1];
    bool pass = true;
    if (Y.above.d) {
      pass = s * (static_cast<long long>(Y.above.d) * Y.above.d) >= top_above(Y, above, x, y);
    }
    if (Y.below.d) {
      pass = pass &&
             s * (static_cast<long long>(Y.below.d) * Y.below.d) >= probe_below(Y, below, x, y);
    }
    Y.out[plane + static_cast<size_t>(y) * w + x] = pass;
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
  bool fused = false;
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
    fused = fused || Y.in_mask != nullptr;
    Neighbour* nb[2] = {&Y.above, &Y.below};
    for (int k = 0; k < 2; ++k) {
      const int64_t* g = f + 5 + 6 * k;
      const int64_t rows = g[1], cols = g[2], a = g[3], b = g[4], d = g[5];
      if (d < 0 || d > 64 || rows < 0 || cols < 0 || rows >= (1 << 24) || cols >= (1 << 24) ||
          a < 0 || a > 64 || b < -64 || b > 64) {
        return (int)cudaErrorInvalidValue;
      }
      // The above probes' patch of 4 x 4 words needs a shrinking map.
      if (d && k == 0 && a >= d) return (int)cudaErrorInvalidValue;
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
  const int smem = kScoreBytes + (fused ? kMaskBytes : 0);
  score_masks_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

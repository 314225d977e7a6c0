// The uint8 scale-space pyramid on Hopper (kernel pyramid_u8): every
// derived layer of a batch of frames in one launch.
//
// No TPU kernel: it stands for XLA work of the JAX package, the resamplers
// ethzasl_brisk_tpu/kernels/downsample.py:19-66 (halfsample8,
// twothirdsample8) in the layer order of detect/scale_space.build_pyramid:
// layer 1 is the two-thirds sample of layer 0 (the frame), layer i >= 2
// the half sample of layer i - 2. Every pairwise average is
// (a + b + 1) >> 1 in int32:
//   * half: out(r, c) = avg(avg(s(2r, 2c), s(2r+1, 2c)),
//                           avg(s(2r, 2c+1), s(2r+1, 2c+1))), clamped to
//     255;
//   * two-thirds: a 3 x 3 block of rows A, B, C gives 2 x 2 outputs: the
//     upper row avg(avg(A, B), A) and the lower avg(avg(C, B), C) a column,
//     then each row's left avg(avg(x0, x1), x0) and right
//     avg(avg(x2, x1), x2), kept & 0xFF.
// Each layer has its own floored size (h/2, w/2; 2 (h/3), 2 (w/3)).
//
// Bound: bytes. The frames read once and the derived layers written once
// (70.3 MB at the B=128 step's four layers), against ~15 int32 operations
// a two-thirds output and ~10 a half output.
//
// Design: a CTA of 256 threads takes a tile of 48 x 96 pixels of one
// frame. Both sides are multiples of 3 * 2^4, so every derived layer's
// tile is whole blocks of its source's tile, up to 10 layers: layer i's
// tile (th_i, tw_i) is (32, 64) at i = 1 and half of layer i-2's after, and
// its rows and columns start at the tile's index times that size. The
// frame's tile is staged in shared memory by 16-byte loads where the frame's
// rows allow them (else bytes), zero outside the frame. The layers are then
// computed in phases, layers 2k-1 and 2k in phase k from the tiles of phase
// k-1, each tile kept in shared memory for the next phase and written once
// to device memory where it lies inside its layer: an output inside its
// layer reads only source pixels inside theirs, so the zero fill never
// reaches it. Every layer of the call lies in one output buffer; the
// wrapper passes each layer's pointer and size.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 48, kTileW = 96;  // multiples of 3 * 2^4
constexpr int kMaxLayers = 10;

struct Layers {
  uint8_t* out[kMaxLayers];  // layer i's (B, h, w) rows; [0] unused
  int h[kMaxLayers], w[kMaxLayers];
};

// The tile of layer i in the CTA: its size and its offset in shared memory
// (compile-time constants: every layer's code is instantiated for its i).
__host__ __device__ constexpr int tile_h(int i) {
  return i == 0 ? kTileH : i == 1 ? 2 * kTileH / 3 : tile_h(i - 2) / 2;
}
__host__ __device__ constexpr int tile_w(int i) {
  return i == 0 ? kTileW : i == 1 ? 2 * kTileW / 3 : tile_w(i - 2) / 2;
}
__host__ __device__ constexpr int tile_offset(int i) {
  return i == 0 ? 0 : tile_offset(i - 1) + tile_h(i - 1) * tile_w(i - 1);
}
// Layer i's tile is whole blocks of its source's tile, for every layer.
constexpr bool whole_blocks(int i) {
  return i == 0 || ((i == 1 ? 3 * tile_h(1) == 2 * kTileH && 3 * tile_w(1) == 2 * kTileW
                            : 2 * tile_h(i) == tile_h(i - 2) && 2 * tile_w(i) == tile_w(i - 2)) &&
                    whole_blocks(i - 1));
}
static_assert(whole_blocks(kMaxLayers - 1), "a tile that does not halve exactly");
constexpr int kSharedBytes = tile_offset(kMaxLayers);

__device__ __forceinline__ int avg(int a, int b) { return (a + b + 1) >> 1; }

// Store value v of layer I at tile cell (r, c): into the tile, and into the
// layer where the cell lies inside it.
template <int I>
__device__ __forceinline__ void put(uint8_t* tiles, const Layers& L, int frame, int ty, int tx,
                                    int r, int c, int v) {
  constexpr int off = tile_offset(I), th = tile_h(I), tw = tile_w(I);
  tiles[off + r * tw + c] = (uint8_t)v;
  const int gr = ty * th + r, gc = tx * tw + c;
  if (gr < L.h[I] && gc < L.w[I]) {
    L.out[I][((size_t)frame * L.h[I] + gr) * L.w[I] + gc] = (uint8_t)v;
  }
}

// Layer I and the layers after it, from the tiles in shared memory. Layers
// 2k-1 and 2k form phase k and read only phase k-1's tiles, so a barrier
// follows each even layer.
template <int I>
__device__ __forceinline__ void layers_from(uint8_t* tiles, const Layers& L, int n_layers,
                                            int frame, int ty, int tx) {
  if constexpr (I < kMaxLayers) {
    if (I >= n_layers) return;
    if constexpr (I == 1) {
      // Two-thirds: a thread a 3 x 3 block of the frame's tile.
      constexpr int bw = kTileW / 3;
      for (int e = threadIdx.x; e < (kTileH / 3) * bw; e += kThreads) {
        const int br = e / bw, bc = e - br * bw;
        const uint8_t* a = tiles + 3 * br * kTileW + 3 * bc;
        const uint8_t* b = a + kTileW;
        const uint8_t* c = b + kTileW;
        int up[3], lo[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          up[k] = avg(avg(a[k], b[k]), a[k]);
          lo[k] = avg(avg(c[k], b[k]), c[k]);
        }
        put<1>(tiles, L, frame, ty, tx, 2 * br, 2 * bc, avg(avg(up[0], up[1]), up[0]) & 0xFF);
        put<1>(tiles, L, frame, ty, tx, 2 * br, 2 * bc + 1, avg(avg(up[2], up[1]), up[2]) & 0xFF);
        put<1>(tiles, L, frame, ty, tx, 2 * br + 1, 2 * bc, avg(avg(lo[0], lo[1]), lo[0]) & 0xFF);
        put<1>(tiles, L, frame, ty, tx, 2 * br + 1, 2 * bc + 1,
               avg(avg(lo[2], lo[1]), lo[2]) & 0xFF);
      }
    } else {
      // Half: a thread an output of layer I from layer I - 2's tile.
      constexpr int sw = tile_w(I - 2), th = tile_h(I), tw = tile_w(I), off = tile_offset(I - 2);
      const uint8_t* s = tiles + off;
      for (int e = threadIdx.x; e < th * tw; e += kThreads) {
        const int r = e / tw, c = e - r * tw;
        const uint8_t* p = s + 2 * r * sw + 2 * c;
        put<I>(tiles, L, frame, ty, tx, r, c,
               min(avg(avg(p[0], p[sw]), avg(p[1], p[sw + 1])), 255));
      }
    }
    if constexpr (I % 2 == 0) __syncthreads();
    layers_from<I + 1>(tiles, L, n_layers, frame, ty, tx);
  }
}

__global__ void __launch_bounds__(kThreads)
    pyramid_u8_kernel(const uint8_t* __restrict__ src, Layers L, int n_layers, int tiles_x,
                      int tiles_y, int vec16) {
  __shared__ __align__(16) uint8_t tiles[kSharedBytes];
  const int per_frame = tiles_x * tiles_y;
  const int frame = blockIdx.x / per_frame;
  const int ty = (blockIdx.x - frame * per_frame) / tiles_x;
  const int tx = blockIdx.x - frame * per_frame - ty * tiles_x;
  const int H = L.h[0], W = L.w[0];
  const int r0 = ty * kTileH, c0 = tx * kTileW;
  const uint8_t* img = src + (size_t)frame * H * W;

  // The frame's tile, zero outside the frame.
  if (vec16) {  // W % 16 == 0 and the frames 16-byte aligned: a chunk is all in or all out
    constexpr int kChunks = kTileW / 16;
    for (int e = threadIdx.x; e < kTileH * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e - r * kChunks) * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < H && c0 + c < W) {
        v = *reinterpret_cast<const uint4*>(img + (size_t)(r0 + r) * W + c0 + c);
      }
      *reinterpret_cast<uint4*>(tiles + r * kTileW + c) = v;
    }
  } else {
    for (int e = threadIdx.x; e < kTileH * kTileW; e += kThreads) {
      const int r = e / kTileW, c = e - r * kTileW;
      tiles[e] = (r0 + r < H && c0 + c < W) ? img[(size_t)(r0 + r) * W + c0 + c] : 0;
    }
  }
  __syncthreads();
  layers_from<1>(tiles, L, n_layers, frame, ty, tx);
}

}  // namespace

// src: (B, H, W) uint8 frames, contiguous on the current card;
// host_layers: n_layers - 1 rows of (out pointer, h, w), layer 1 first, each
// a contiguous (B, h, w) uint8 buffer, its size the layer's floored size.
// 2 <= n_layers <= kMaxLayers.
extern "C" int brisk_pyramid_u8(const void* src, const int64_t* host_layers, int n_layers, int B,
                                int H, int W, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || B < 1 || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Layers L = {};
  L.h[0] = H;
  L.w[0] = W;
  for (int i = 1; i < n_layers; ++i) {
    const int64_t* f = host_layers + 3 * (i - 1);
    const int h = i == 1 ? 2 * (H / 3) : L.h[i - 2] / 2;
    const int w = i == 1 ? 2 * (W / 3) : L.w[i - 2] / 2;
    if (f[1] != h || f[2] != w || (f[0] == 0 && (long long)h * w > 0)) {
      return (int)cudaErrorInvalidValue;
    }
    L.out[i] = reinterpret_cast<uint8_t*>(f[0]);
    L.h[i] = h;
    L.w[i] = w;
  }
  const long long tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  if (tiles_x * tiles_y * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec16 = W % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  return (int)launch(pyramid_u8_kernel, (int)(tiles_x * tiles_y * B), kThreads, 0,
                     static_cast<cudaStream_t>(stream), static_cast<const uint8_t*>(src), L,
                     n_layers, (int)tiles_x, (int)tiles_y, vec16);
}

// Reference-exact integer Harris scores on Hopper (kernel K1).
//
// Replaces the Pallas TPU kernel ethzasl_brisk_tpu/kernels/pallas_harris.py
// (_harris_tile_kernel, reached through harris_score_i32_fused). It computes
// the reference's fixed-point HarrisScoresSSE (harris-scores.cc:53-279):
//   * Scharr gradients x8 on rows/cols [1, n-2], zero elsewhere;
//   * products (a*b) >> 16;
//   * 3x3 binomial smoothing (4c + 2*edges + corners) >> 4;
//   * score = sxx*syy - sxy^2 - (((sxx+syy) >> 1)^2 >> 2) on [2, n-3].
// The arithmetic (and its int32 range argument) is in harris.cuh.
//
// Design: one block per (frame, 32-row tile, 64-column tile). The block
// stages the (32+4) x (64+4) uint8 tile with its 2-pixel halo in shared
// memory, computes the three product planes on the (32+2) x (64+2) ring
// into shared memory, then smooths them and writes the int32 scores. The
// ragged right and bottom edges (widths 426 and 213, any height) are masked
// here; the TPU kernel's divisibility rule and 128-lane padding are Mosaic
// constraints and have no counterpart.
//
// Bound: int32 operations. 65 per pixel (harris.cuh: gradients 18, products
// 6, smoothing 33, score 8) at the card's int32 rate take longer than the
// 1 byte in and 4 bytes out per pixel at its memory rate; the halo re-reads
// 12% of the input from L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "harris.cuh"

namespace {

constexpr int TH = 32;
constexpr int TW = 64;

__global__ void __launch_bounds__(256) harris_tile_kernel(
    const uint8_t* __restrict__ img, int32_t* __restrict__ out, int H, int W) {
  __shared__ int pix[TH + 4][TW + 4];
  __shared__ int pxx[TH + 2][TW + 2];
  __shared__ int pyy[TH + 2][TW + 2];
  __shared__ int pxy[TH + 2][TW + 2];

  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const uint8_t* src = img + (size_t)blockIdx.z * H * W;
  int32_t* dst = out + (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // Tile row 0 is image row r0 - 2; pixels outside the image read 0 (they
  // only feed gradients that the interior mask zeroes).
  for (int i = tid; i < (TH + 4) * (TW + 4); i += nthr) {
    const int ty = i / (TW + 4), tx = i % (TW + 4);
    const int y = r0 - 2 + ty, x = c0 - 2 + tx;
    pix[ty][tx] = (y >= 0 && y < H && x >= 0 && x < W) ? src[(size_t)y * W + x] : 0;
  }
  __syncthreads();

  // Products on the ring: ring row 0 is image row r0 - 1.
  for (int i = tid; i < (TH + 2) * (TW + 2); i += nthr) {
    const int ty = i / (TW + 2), tx = i % (TW + 2);
    const int y = r0 - 1 + ty, x = c0 - 1 + tx;
    int xx = 0, yy = 0, xy = 0;
    if (y >= 1 && y <= H - 2 && x >= 1 && x <= W - 2) {
      brisk_harris::products<TW + 4>(pix, ty + 1, tx + 1, xx, yy, xy);
    }
    pxx[ty][tx] = xx;
    pyy[ty][tx] = yy;
    pxy[ty][tx] = xy;
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += nthr) {
    const int ty = i / TW, tx = i % TW;
    const int y = r0 + ty, x = c0 + tx;
    if (y >= H || x >= W) continue;
    int score = 0;
    if (y >= 2 && y <= H - 3 && x >= 2 && x <= W - 3) {
      score = brisk_harris::score<TW + 2>(pxx, pyy, pxy, ty + 1, tx + 1);
    }
    dst[(size_t)y * W + x] = score;
  }
}

}  // namespace

extern "C" int brisk_harris_score_i32(const void* img, void* out, int B, int H,
                                      int W, void* stream) {
  const dim3 block(64, 4);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  harris_tile_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (int32_t*)out, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* brisk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Harris scores and their 2-D maxima mask in one pass on Hopper (kernel K3).
//
// Replaces the Pallas TPU kernel ethzasl_brisk_tpu/kernels/pallas_harris.py
// (_harris_mask_tile_kernel, reached through harris_score_mask_fused). It
// writes K1's scores and, beside them, the mask of kernels/nms.py's
// maxima2d_mask with border 2:
//   mask = (2 <= y <= H-3) & (2 <= x <= W-3) & score >= thr
//          & max(8 neighbours' scores) <= score.
// Every neighbour of an in-border cell lies on rows/cols [1, n-2], inside
// the image, so the INT32_MIN padding of maxima2d_mask is never observed:
// the kernel needs only real scores (0 outside [2, n-3]) on a 1-pixel ring.
//
// Design: one block per (frame, 32-row tile, 64-column tile), staging
// tiles in shared memory (harris.cuh's 2-D form; K1 in harris.cu is
// separable and works in registers instead), every staged area one pixel
// wider so that the scores cover the NMS ring:
//   pixels   (32+6) x (64+6) uint8  (2,660 B; image rows r0-3 .. r0+34),
//   products 3 x (32+4) x (64+4) int32 (29,376 B),
//   scores   (32+2) x (64+2) int32 (8,976 B),
// 41,012 B of static shared memory in all, under the 48 KB static limit
// (int32 pixels would make it 49 KB). The ragged right and bottom edges are
// masked here. The mask is written as bytes 0/1 into a torch.bool tensor.
//
// Bound: int32 operations: 65 per pixel (harris.cuh) and 9 for the maximum,
// against 1 byte in and 5 bytes out per pixel. Against K1 followed by the
// plain NMS it saves the score map's re-read and the NMS temporaries.

#include <cstdint>
#include <cuda_runtime.h>

#include "harris.cuh"

namespace {

constexpr int TH = 32;
constexpr int TW = 64;

__global__ void __launch_bounds__(256) harris_mask_tile_kernel(
    const uint8_t* __restrict__ img, int32_t* __restrict__ out,
    uint8_t* __restrict__ mask, int H, int W, int thr) {
  __shared__ uint8_t pix[TH + 6][TW + 6];
  __shared__ int pxx[TH + 4][TW + 4];
  __shared__ int pyy[TH + 4][TW + 4];
  __shared__ int pxy[TH + 4][TW + 4];
  __shared__ int sc[TH + 2][TW + 2];

  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* src = img + frame;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // Pixel row 0 is image row r0 - 3; outside the image reads 0 (it only
  // feeds gradients that the interior test zeroes).
  for (int i = tid; i < (TH + 6) * (TW + 6); i += nthr) {
    const int ty = i / (TW + 6), tx = i % (TW + 6);
    const int y = r0 - 3 + ty, x = c0 - 3 + tx;
    pix[ty][tx] = (y >= 0 && y < H && x >= 0 && x < W) ? src[(size_t)y * W + x] : 0;
  }
  __syncthreads();

  // Products: plane row 0 is image row r0 - 2.
  for (int i = tid; i < (TH + 4) * (TW + 4); i += nthr) {
    const int ty = i / (TW + 4), tx = i % (TW + 4);
    const int y = r0 - 2 + ty, x = c0 - 2 + tx;
    int xx = 0, yy = 0, xy = 0;
    if (y >= 1 && y <= H - 2 && x >= 1 && x <= W - 2) {
      brisk_harris::products<TW + 6>(pix, ty + 1, tx + 1, xx, yy, xy);
    }
    pxx[ty][tx] = xx;
    pyy[ty][tx] = yy;
    pxy[ty][tx] = xy;
  }
  __syncthreads();

  // Scores on the 1-pixel ring: score row 0 is image row r0 - 1. Cells off
  // [2, n-3] (and off the image) score 0, as in K1's output.
  for (int i = tid; i < (TH + 2) * (TW + 2); i += nthr) {
    const int ty = i / (TW + 2), tx = i % (TW + 2);
    const int y = r0 - 1 + ty, x = c0 - 1 + tx;
    int s = 0;
    if (y >= 2 && y <= H - 3 && x >= 2 && x <= W - 3) {
      s = brisk_harris::score<TW + 4>(pxx, pyy, pxy, ty + 1, tx + 1);
    }
    sc[ty][tx] = s;
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += nthr) {
    const int ty = i / TW, tx = i % TW;
    const int y = r0 + ty, x = c0 + tx;
    if (y >= H || x >= W) continue;
    const int qy = ty + 1, qx = tx + 1;
    const int s = sc[qy][qx];
    bool m = false;
    if (y >= 2 && y <= H - 3 && x >= 2 && x <= W - 3 && s >= thr) {
      const int n = max(max(max(sc[qy - 1][qx - 1], sc[qy - 1][qx]),
                            max(sc[qy - 1][qx + 1], sc[qy][qx - 1])),
                        max(max(sc[qy][qx + 1], sc[qy + 1][qx - 1]),
                            max(sc[qy + 1][qx], sc[qy + 1][qx + 1])));
      m = n <= s;
    }
    out[frame + (size_t)y * W + x] = s;
    mask[frame + (size_t)y * W + x] = m ? 1 : 0;
  }
}

}  // namespace

extern "C" int brisk_harris_score_mask(const void* img, void* out, void* mask,
                                       int B, int H, int W, int thr,
                                       void* stream) {
  const dim3 block(64, 4);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  harris_mask_tile_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (int32_t*)out, (uint8_t*)mask, H, W, thr);
  return (int)cudaGetLastError();
}

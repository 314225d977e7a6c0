// Reference-exact integer Harris arithmetic of kernel K3, harris_mask.cu
// (harris-scores.cc:53-279), in its 2-D form. K3 stages a tile in shared
// memory; these helpers read it with tile-local indices.
//
// Ranges: |dx|, |dy| <= 8 * 16 * 255 = 32640, so dx*dx <= 1,065,369,600 <
// 2^31 and every product, sum and score stays inside int32 (|s..| <= 16256,
// |score| < 2^30): no signed overflow can occur. Right shifts of negative
// values are arithmetic under nvcc, as in the reference and in torch.
#pragma once

#include <cstdint>

namespace brisk_harris {

// Scharr gradients x8 at pixel (py, px) of a staged tile, then the three
// products (a*b) >> 16.
template <int PW, typename T>
__device__ __forceinline__ void products(T (*pix)[PW], int py, int px,
                                         int& xx, int& yy, int& xy) {
  const int l = pix[py][px - 1], r = pix[py][px + 1];
  const int u = pix[py - 1][px], d = pix[py + 1][px];
  const int ul = pix[py - 1][px - 1], ur = pix[py - 1][px + 1];
  const int ll = pix[py + 1][px - 1], lr = pix[py + 1][px + 1];
  const int dx = (10 * (l - r) + 3 * (ul - ur) + 3 * (ll - lr)) * 8;
  const int dy = (10 * (u - d) + 3 * (ul - ll) + 3 * (ur - lr)) * 8;
  xx = (dx * dx) >> 16;
  yy = (dy * dy) >> 16;
  xy = (dx * dy) >> 16;
}

// 3x3 binomial smoothing (4c + 2*edges + corners) >> 4 at (qy, qx).
template <int W>
__device__ __forceinline__ int smooth(int (*p)[W], int qy, int qx) {
  return (4 * p[qy][qx] +
          2 * (p[qy - 1][qx] + p[qy + 1][qx] + p[qy][qx - 1] + p[qy][qx + 1]) +
          p[qy - 1][qx - 1] + p[qy - 1][qx + 1] + p[qy + 1][qx - 1] +
          p[qy + 1][qx + 1]) >> 4;
}

// score = sxx*syy - sxy^2 - (((sxx+syy) >> 1)^2 >> 2) from the smoothed
// product planes at (qy, qx).
template <int W>
__device__ __forceinline__ int score(int (*pxx)[W], int (*pyy)[W],
                                     int (*pxy)[W], int qy, int qx) {
  const int sxx = smooth<W>(pxx, qy, qx);
  const int syy = smooth<W>(pyy, qy, qx);
  const int sxy = smooth<W>(pxy, qy, qx);
  const int trace_half = (sxx + syy) >> 1;
  return sxx * syy - sxy * sxy - ((trace_half * trace_half) >> 2);
}

}  // namespace brisk_harris

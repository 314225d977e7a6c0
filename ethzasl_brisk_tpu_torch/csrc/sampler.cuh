// K2's sampling arithmetic, shared by kernel K2 (sampler.cu) and the
// describe kernel (describe.cu), which compile one copy each: the tap
// geometry of a pattern point (fast_sampler._tap_geometry) and its value
// x1024 from the integral of its frame (fast_sampler._values_from_taps,
// with the v1 engine's rounding as the template flag V1). See sampler.cu
// for the design and the arithmetic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int trunc_i32(float v) { return (int)truncf(v); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Tap geometry of one point (fast_sampler._tap_geometry).
struct Geom {
  float xf, yf, x_1, x1, y_1, y1;
  int x_left, y_top, x_right, y_bottom, x_i, y_i, cd_y, c_x, d_x;
  bool small, big;
};

__device__ __forceinline__ Geom geometry(float kx, float ky, float px, float py, float s) {
  Geom g;
  g.xf = px + kx;
  g.yf = py + ky;
  g.small = s < 0.5f;
  g.x_1 = g.xf - s;
  g.x1 = g.xf + s;
  g.y_1 = g.yf - s;
  g.y1 = g.yf + s;
  g.x_left = trunc_i32(g.x_1 + 0.5f);
  g.y_top = trunc_i32(g.y_1 + 0.5f);
  g.x_right = trunc_i32(g.x1 + 0.5f);
  g.y_bottom = trunc_i32(g.y1 + 0.5f);
  g.x_i = trunc_i32(g.xf);
  g.y_i = trunc_i32(g.yf);
  g.big = (g.x_right - g.x_left - 1) + (g.y_bottom - g.y_top - 1) > 2;
  g.cd_y = g.big ? g.y_bottom - 1 : g.y_bottom;
  g.c_x = g.big ? g.x_right + 1 : g.x_right;
  g.d_x = g.big ? g.x_left + 1 : g.x_left;
  return g;
}

// The value x1024 of one point from its geometry and the integral of its
// frame (`frame` points at the frame's row 0).
template <bool V1>
__device__ __forceinline__ int point_value(const int32_t* __restrict__ frame, int stride,
                                           const Geom& g, int frame_rows, int cols,
                                           int scaling, int scaling2) {
  auto row = [&](int r) { return clampi(r, 0, frame_rows) * stride; };
  auto col = [&](int c) { return clampi(c, 0, cols); };
  auto tap = [&](int r, int c) { return (uint32_t)__ldg(frame + r + c); };
  if (g.small) {
    // ---- Small-sigma bilinear (brisk-descriptor-extractor.cc:391-408).
    const int c0 = col(g.x_i), c1 = col(g.x_i + 1), c2 = col(g.x_i + 2);
    uint32_t t[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int r = row(g.y_i + i);
      t[i][0] = tap(r, c0);
      t[i][1] = tap(r, c1);
      t[i][2] = tap(r, c2);
    }
    const uint32_t s00 = t[1][1] - t[0][1] - t[1][0] + t[0][0];
    const uint32_t s01 = t[1][2] - t[0][2] - t[1][1] + t[0][1];
    const uint32_t s10 = t[2][1] - t[1][1] - t[2][0] + t[1][0];
    const uint32_t s11 = t[2][2] - t[1][2] - t[2][1] + t[1][1];
    const uint32_t r_x = (uint32_t)trunc_i32((g.xf - (float)g.x_i) * 1024.0f);
    const uint32_t r_y = (uint32_t)trunc_i32((g.yf - (float)g.y_i) * 1024.0f);
    const uint32_t sum = (1024u - r_x) * (1024u - r_y) * s00 + r_x * (1024u - r_y) * s01 +
                         r_x * r_y * s11 + (1024u - r_x) * r_y * s10 + (V1 ? 512u : 0u);
    return floordiv((int)sum, 1024);
  }
  // ---- Box branch (:410-495), corner pixels from integral differences.
  // The grid of _values_from_taps: columns 0..5 = x_left, x_left+1, d_x+1,
  // x_right, x_right+1, c_x+1; rows 0..5 = y_top, y_top+1, cd_y, cd_y+1,
  // y_bottom, y_bottom+1; tIJ is grid cell (I, J). Corner c reads columns
  // c_x, c_x+1 and corner d columns d_x, d_x+1 (the cells of 3/4 and 0/1
  // that `big` picks).
  const int l0 = col(g.x_left), l1 = col(g.x_left + 1);
  const int r0 = col(g.x_right), r1 = col(g.x_right + 1);
  const int d0 = col(g.d_x), d1 = col(g.d_x + 1);
  const int c0 = col(g.c_x), c1 = col(g.c_x + 1);
  const int R0 = row(g.y_top), R1 = row(g.y_top + 1);
  const int R2 = row(g.cd_y), R3 = row(g.cd_y + 1);
  const int R4 = row(g.y_bottom), R5 = row(g.y_bottom + 1);
  const uint32_t t00 = tap(R0, l0), t01 = tap(R0, l1), t03 = tap(R0, r0), t04 = tap(R0, r1);
  const uint32_t t10 = tap(R1, l0), t11 = tap(R1, l1), t13 = tap(R1, r0), t14 = tap(R1, r1);
  const uint32_t d2 = tap(R2, d0), t22 = tap(R2, d1), c2 = tap(R2, c0), t25 = tap(R2, c1);
  const uint32_t d3 = tap(R3, d0), t32 = tap(R3, d1), c3 = tap(R3, c0), t35 = tap(R3, c1);
  const uint32_t t40 = tap(R4, l0), t41 = tap(R4, l1), t43 = tap(R4, r0), t44 = tap(R4, r1);
  const uint32_t t51 = tap(R5, l1), t53 = tap(R5, r0);

  const uint32_t img_a = t11 - t01 - t10 + t00;
  const uint32_t img_b = t14 - t04 - t13 + t03;
  const uint32_t img_c = t35 - t25 - c3 + c2;
  const uint32_t img_d = t32 - t22 - d3 + d2;

  const float r_x_1f = (float)g.x_left - g.x_1 + 0.5f;
  const float r_y_1f = (float)g.y_top - g.y_1 + 0.5f;
  const float r_x1f = g.x1 - (float)g.x_right + 0.5f;
  const float r_y1f = g.y1 - (float)g.y_bottom + 0.5f;
  const float scf = (float)scaling;
  const uint32_t w_a = (uint32_t)trunc_i32(r_x_1f * r_y_1f * scf);
  const uint32_t w_b = (uint32_t)trunc_i32(r_x1f * r_y_1f * scf);
  const uint32_t w_c = (uint32_t)trunc_i32(r_x1f * r_y1f * scf);
  const uint32_t w_d = (uint32_t)trunc_i32(r_x_1f * r_y1f * scf);
  const uint32_t r_x_1_i = (uint32_t)trunc_i32(r_x_1f * scf);
  const uint32_t r_y_1_i = (uint32_t)trunc_i32(r_y_1f * scf);
  const uint32_t r_x1_i = (uint32_t)trunc_i32(r_x1f * scf);
  const uint32_t r_y1_i = (uint32_t)trunc_i32(r_y1f * scf);

  const uint32_t corners = w_a * img_a + w_b * img_b + w_c * img_c + w_d * img_d;
  const uint32_t upper = (t13 - t03 + t01 - t11) * r_y_1_i;
  const uint32_t middle = (t43 - t13 + t11 - t41) * (uint32_t)scaling;
  const uint32_t left = (t41 - t11 + t10 - t40) * r_x_1_i;
  const uint32_t right = (t44 - t14 + t13 - t43) * r_x1_i;
  const uint32_t bottom = (t53 - t43 + t41 - t51) * r_y1_i;
  const int divisor = max(scaling2, 1);
  const uint32_t total = corners + upper + middle + left + right + bottom +
                         (V1 ? (uint32_t)(divisor / 2) : 0u);
  return floordiv((int)total, divisor);
}

}  // namespace

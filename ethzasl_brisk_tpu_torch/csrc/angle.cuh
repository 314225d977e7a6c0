// The JAX package's float32 atan2 (glibc's atan2f, fdlibm's e_atan2f.c and
// s_atanf.c) and BRISK's orientation chain, shared by the angle kernels
// (angle.cu) and the describe kernel (describe.cu), which compile one copy
// each. Every float operation is an explicit round-to-nearest intrinsic;
// the chain's one FMA is the __fmaf_rn. See angle.cu.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float f32(uint32_t bits) { return __uint_as_float(bits); }

__device__ float atanf_fdlibm(float x) {
  const float atanhi[4] = {f32(0x3eed6338u), f32(0x3f490fdau), f32(0x3f7b985eu), f32(0x3fc90fdau)};
  const float atanlo[4] = {f32(0x31ac3769u), f32(0x33222168u), f32(0x33140fb4u), f32(0x33a22168u)};
  const float aT0 = f32(0x3eaaaaabu), aT1 = f32(0xbe4ccccdu), aT2 = f32(0x3e124925u),
              aT3 = f32(0xbde38e38u), aT4 = f32(0x3dba2e6eu), aT5 = f32(0xbd9d8795u),
              aT6 = f32(0x3d886b35u), aT7 = f32(0xbd6ef16bu), aT8 = f32(0x3d4bda59u),
              aT9 = f32(0xbd15a221u), aT10 = f32(0x3c8569d7u);
  const int32_t hx = __float_as_int(x);
  const int32_t ix = hx & 0x7fffffff;
  int id;
  if (ix >= 0x4c000000) {  // |x| >= 2^25
    if (ix > 0x7f800000) return __fadd_rn(x, x);  // NaN
    const float inf_atan = __fadd_rn(atanhi[3], atanlo[3]);
    return hx > 0 ? inf_atan : -inf_atan;
  }
  if (ix < 0x3ee00000) {  // |x| < 7/16
    if (ix < 0x31000000) return x;  // |x| < 2^-29
    id = -1;
  } else {
    x = fabsf(x);
    if (ix < 0x3f980000) {
      if (ix < 0x3f300000) {  // 7/16 <= |x| < 11/16
        id = 0;
        x = __fdiv_rn(__fsub_rn(__fmul_rn(2.0f, x), 1.0f), __fadd_rn(2.0f, x));
      } else {  // 11/16 <= |x| < 19/16
        id = 1;
        x = __fdiv_rn(__fsub_rn(x, 1.0f), __fadd_rn(x, 1.0f));
      }
    } else if (ix < 0x401c0000) {  // 19/16 <= |x| < 39/16
      id = 2;
      x = __fdiv_rn(__fsub_rn(x, 1.5f), __fadd_rn(1.0f, __fmul_rn(1.5f, x)));
    } else {  // 39/16 <= |x| < 2^25
      id = 3;
      x = __fdiv_rn(-1.0f, x);
    }
  }
  const float z = __fmul_rn(x, x);
  const float w = __fmul_rn(z, z);
  float s1 = __fadd_rn(aT8, __fmul_rn(w, aT10));
  s1 = __fadd_rn(aT6, __fmul_rn(w, s1));
  s1 = __fadd_rn(aT4, __fmul_rn(w, s1));
  s1 = __fadd_rn(aT2, __fmul_rn(w, s1));
  s1 = __fmul_rn(z, __fadd_rn(aT0, __fmul_rn(w, s1)));
  float s2 = __fadd_rn(aT7, __fmul_rn(w, aT9));
  s2 = __fadd_rn(aT5, __fmul_rn(w, s2));
  s2 = __fadd_rn(aT3, __fmul_rn(w, s2));
  s2 = __fmul_rn(w, __fadd_rn(aT1, __fmul_rn(w, s2)));
  const float s = __fadd_rn(s1, s2);
  if (id < 0) return __fsub_rn(x, __fmul_rn(x, s));
  const float r = __fsub_rn(atanhi[id], __fsub_rn(__fsub_rn(__fmul_rn(x, s), atanlo[id]), x));
  return hx < 0 ? -r : r;
}

__device__ float atan2f_fdlibm(float y, float x) {
  const float pi_o_4 = f32(0x3f490fdbu), pi_o_2 = f32(0x3fc90fdbu), pi = f32(0x40490fdbu),
              pi_lo = f32(0xb3bbbd2eu);
  const int32_t hx = __float_as_int(x), hy = __float_as_int(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return __fadd_rn(x, y);  // NaN
  if (hx == 0x3f800000) return atanf_fdlibm(y);                     // x == 1
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);                // 2 sign(x) + sign(y)
  if (iy == 0) {
    if (m < 2) return y;  // atan(+-0, +anything) = +-0
    return m == 2 ? pi : -pi;
  }
  if (ix == 0) return hy < 0 ? -pi_o_2 : pi_o_2;
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      const float three = __fmul_rn(3.0f, pi_o_4);
      const float v[4] = {pi_o_4, -pi_o_4, three, -three};
      return v[m];
    }
    const float v[4] = {0.0f, -0.0f, pi, -pi};
    return v[m];
  }
  if (iy == 0x7f800000) return hy < 0 ? -pi_o_2 : pi_o_2;
  const int k = (iy - ix) >> 23;
  float z;
  if (k > 60) {
    z = __fadd_rn(pi_o_2, __fmul_rn(0.5f, pi_lo));
  } else if (hx < 0 && k < -60) {
    z = 0.0f;
  } else {
    z = atanf_fdlibm(fabsf(__fdiv_rn(y, x)));
  }
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return __fsub_rn(pi, __fsub_rn(z, pi_lo));
    default: return __fsub_rn(__fsub_rn(z, pi_lo), pi);
  }
}

// BRISK's orientation step on one keypoint (brisk_orientation's chain, see
// angle.cu): the angle in degrees from the long-pair gradient sums d0, d1.
// Compiled (the JAX package's jitted describe): atan2f * 57.2957764f, XLA's
// folded 180 / float32(pi). Op by op (the 16-bit path): / float32(pi) * 180.
__device__ __forceinline__ float orientation_angle(int32_t d0, int32_t d1, bool op_by_op) {
  const float rad = atan2f_fdlibm(static_cast<float>(d1), static_cast<float>(d0));
  return op_by_op ? __fmul_rn(__fdiv_rn(rad, f32(0x40490fdbu)), 180.0f)
                  : __fmul_rn(rad, f32(0x42652ee0u));  // 180 / float32(pi), folded by XLA
}

// The rotation bin of an angle, wrapped once into [0, n_rot). Compiled:
// N_ROT / 360 folded by XLA (n_rot = 1024), the + 0.5 contracted into it.
// Op by op: each step rounded, a true division.
__device__ __forceinline__ int64_t rotation_bin(float a, int n_rot, bool op_by_op) {
  const float t = op_by_op
      ? __fadd_rn(__fdiv_rn(__fmul_rn(static_cast<float>(n_rot), a), 360.0f), 0.5f)
      : __fmaf_rn(a, f32(0x40360b61u), 0.5f);
  int64_t th = static_cast<int64_t>(truncf(t));
  if (th < 0) th += n_rot;
  if (th >= n_rot) th -= n_rot;
  return th;
}

}  // namespace

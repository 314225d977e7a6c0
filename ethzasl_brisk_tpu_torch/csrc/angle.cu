// The JAX package's float32 atan2 on Hopper, and BRISK's orientation step.
//
// Replaces no TPU kernel: the JAX package takes jnp.arctan2 in XLA, which on
// the CPU calls glibc's atan2f (fdlibm's e_atan2f.c and s_atanf.c). CUDA's
// atan2f, and torch.atan2 on either device, are other chains: an ULP away
// at a rotation-bin edge moves theta and the whole descriptor. So the chain
// is transcribed here step by step. Every float operation is an explicit
// round-to-nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn;
// the one FMA the JAX chain has is an explicit __fmaf_rn), so no other
// contraction and no reciprocal can creep in, whatever the flags; the file
// is built with --fmad=false like the others. The plain torch versions are
// ethzasl_brisk_tpu_torch/core/atan2f.py, core/sincosf.py and
// describe/orientation.py.
//
// Two kernels, one thread an element:
//   * atan2f_elementwise: out[i] = atan2f(y[i], x[i]) (the camera grid's
//     angle sites, geometry/camera_aware.py);
//   * brisk_orientation: from the int32 long-pair gradient sums d0, d1, the
//     given angle and the need mask, the angle in degrees and the rotation
//     bin theta, as the JAX package's jitted describe computes them on the
//     CPU (describe/extractor.py, _describe_core; XLA folds its constants and
//     contracts the + 0.5): atan2f(float(d1), float(d0)) * 57.2957764f, the
//     given angle where none is needed, theta = trunc(fma(angle,
//     2.84444451f, 0.5f)), wrapped into [0, n_rot). The one FMA is the
//     __fmaf_rn; every other step rounds on its own. With op_by_op (the
//     16-bit path, held to the JAX package run op by op) the chain is the
//     source's: / float32(pi) * 180 and trunc(n_rot * angle / 360 + 0.5),
//     true divisions.
//
// Bound: bytes (8 B in and 4 out an element; 13 in and 12 out a keypoint),
// at a few hundred float operations an element. Simple first: the
// branches are few and a warp's lanes mostly take the same one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void atan2f_elementwise_kernel(const float* __restrict__ y, const float* __restrict__ x,
                                          float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = atan2f_fdlibm(y[i], x[i]);
}

__global__ void brisk_orientation_kernel(const int32_t* __restrict__ d0, const int32_t* __restrict__ d1,
                                         const float* __restrict__ given, const uint8_t* __restrict__ need,
                                         float* __restrict__ angle, int64_t* __restrict__ theta, int n,
                                         int n_rot, bool op_by_op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = given[i];
  if (need[i]) {
    const float rad = atan2f_fdlibm(static_cast<float>(d1[i]), static_cast<float>(d0[i]));
    a = op_by_op ? __fmul_rn(__fdiv_rn(rad, f32(0x40490fdbu)), 180.0f)
                 : __fmul_rn(rad, f32(0x42652ee0u));  // 180 / float32(pi), folded by XLA
  }
  // Compiled: N_ROT / 360 folded by XLA (n_rot = 1024), the + 0.5
  // contracted into it. Op by op: each step rounded, a true division.
  const float t = op_by_op
      ? __fadd_rn(__fdiv_rn(__fmul_rn(static_cast<float>(n_rot), a), 360.0f), 0.5f)
      : __fmaf_rn(a, f32(0x40360b61u), 0.5f);
  int64_t th = static_cast<int64_t>(truncf(t));
  if (th < 0) th += n_rot;
  if (th >= n_rot) th -= n_rot;
  angle[i] = a;
  theta[i] = th;
}

// glibc's float32 sinf and cosf (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c,
// sincosf.h, sincosf_data.c): double arithmetic, each step rounded on its
// own, then one rounding to float. The plain torch version is
// ethzasl_brisk_tpu_torch/core/sincosf.py.
__device__ __forceinline__ double f64(unsigned long long bits) { return __longlong_as_double(bits); }

// sinf_poly: the sine polynomial, or with cos_branch the cosine one,
// negated with neg (glibc's second table).
__device__ double sincos_poly(double x, double x2, bool cos_branch, bool neg) {
  if (!cos_branch) {
    const double x3 = __dmul_rn(x, x2);
    const double s1 = __dadd_rn(f64(0x3f81107605230bc4ull), __dmul_rn(x2, f64(0xbf2994eb3774cf24ull)));
    const double x7 = __dmul_rn(x3, x2);
    const double s = __dadd_rn(x, __dmul_rn(x3, f64(0xbfc555545995a603ull)));
    return __dadd_rn(s, __dmul_rn(x7, s1));
  }
  const double sg = neg ? -1.0 : 1.0;
  const double c0 = sg, c1 = sg * f64(0xbfdffffffd0c621cull), c2 = sg * f64(0x3fa55553e1068f19ull),
               c3 = sg * f64(0xbf56c087e89a359dull), c4 = sg * f64(0x3ef99343027bf8c3ull);
  const double x4 = __dmul_rn(x2, x2);
  const double cc2 = __dadd_rn(c3, __dmul_rn(x2, c4));
  const double cc1 = __dadd_rn(c0, __dmul_rn(x2, c1));
  const double x6 = __dmul_rn(x4, x2);
  const double c = __dadd_rn(cc1, __dmul_rn(x4, c2));
  return __dadd_rn(c, __dmul_rn(x6, cc2));
}

__constant__ uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
    0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0,
    0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

// reduce_large: x mod pi/2 for |x| >= 120 by the 192-bit 4/pi table.
__device__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = ((xi & 0xffffff) | 0x800000) << shift;
  uint64_t res0 = xi * arr[0];
  const uint64_t res1 = static_cast<uint64_t>(xi) * arr[4];
  const uint64_t res2 = static_cast<uint64_t>(xi) * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ull << 61)) >> 62;
  res0 -= n << 62;
  *np = static_cast<int>(n);
  return __dmul_rn(__ll2double_rn(static_cast<long long>(res0)), f64(0x3c1921fb54442d18ull));
}

__device__ void sincosf_glibc(float y, float* sin_out, float* cos_out) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = (bits >> 20) & 0x7ff;
  const double x = static_cast<double>(y);
  if (top < 0x3f4) {  // |y| < pi/4
    if (top < 0x398) {  // |y| < 2^-12
      *sin_out = y;
      *cos_out = 1.0f;
      return;
    }
    const double x2 = __dmul_rn(x, x);
    *sin_out = __double2float_rn(sincos_poly(x, x2, false, false));
    *cos_out = __double2float_rn(sincos_poly(x, x2, true, false));
    return;
  }
  if (top >= 0x7f8) {  // inf, NaN
    *sin_out = *cos_out = __int_as_float(0x7fc00000);
    return;
  }
  int n, q;
  double r;
  if (top < 0x42f) {  // |y| < 120
    n = (__double2int_rz(__dmul_rn(x, f64(0x41645f306dc9c883ull))) + 0x800000) >> 24;
    r = __dsub_rn(x, __dmul_rn(static_cast<double>(n), f64(0x3ff921fb54442d18ull)));
    q = n;
  } else {
    r = reduce_large(bits, &n);
    q = n + static_cast<int>(bits >> 31);
  }
  const double s = ((q & 3) == 1 || (q & 3) == 2) ? -1.0 : 1.0;
  const bool neg = (q & 2) != 0;
  const double rs = __dmul_rn(r, s), r2 = __dmul_rn(r, r);
  *sin_out = __double2float_rn(sincos_poly(rs, r2, (n & 1) == 1, neg));
  *cos_out = __double2float_rn(sincos_poly(rs, r2, (n & 1) == 0, neg));
}

__global__ void sincosf_elementwise_kernel(const float* __restrict__ x, float* __restrict__ sin_out,
                                           float* __restrict__ cos_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sincosf_glibc(x[i], &sin_out[i], &cos_out[i]);
}

int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int brisk_atan2f_elementwise(const void* y, const void* x, void* out, int n,
                                        void* stream) {
  atan2f_elementwise_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brisk_sincosf_elementwise(const void* x, void* sin_out, void* cos_out, int n,
                                         void* stream) {
  sincosf_elementwise_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(sin_out), static_cast<float*>(cos_out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int brisk_orientation(const void* d0, const void* d1, const void* given, const void* need,
                                 void* angle, void* theta, int n, int n_rot, int op_by_op,
                                 void* stream) {
  if (n_rot != 1024) return static_cast<int>(cudaErrorInvalidValue);
  brisk_orientation_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(d0), static_cast<const int32_t*>(d1),
      static_cast<const float*>(given), static_cast<const uint8_t*>(need),
      static_cast<float*>(angle), static_cast<int64_t*>(theta), n, n_rot, op_by_op != 0);
  return static_cast<int>(cudaGetLastError());
}

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
// is built with --fmad=false like the others. glibc's atan2f and the
// orientation chain are device functions in angle.cuh, which the describe
// kernel (describe.cu) compiles too. The plain torch versions are
// ethzasl_brisk_tpu_torch/core/atan2f.py, core/sincosf.py and
// describe/orientation.py.
//
// Four kernels, one thread an element:
//   * atan2f_elementwise: out[i] = atan2f(y[i], x[i]) (core/atan2f.py's
//     atan2f on the card);
//   * sincosf_elementwise: glibc's sinf and cosf (core/sincosf.py);
//   * walk_angles: the camera grid's angle sites (geometry/camera_aware.py,
//     walk_angles_plain), the whole chain of a keypoint in one thread: the
//     walk of its size from a base point, along the view angle (degrees to
//     radians, glibc's sincosf) or along a given direction, the bilinear
//     lookup of the end point in the (V, H, W, 2) maps (the int32
//     truncation, the clamps, the four taps, the three lerps of each
//     component), its offset from a reference point, atan2f and the scale
//     to degrees, op for op as the plain chain rounds them;
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
// Bound: bytes (8 B in and 4 out an element; 13 in and 12 out a keypoint;
// walk_angles 28 B in, the four 8-byte taps, 4 out a keypoint),
// at a few hundred float operations an element. Simple first: the
// branches are few and a warp's lanes mostly take the same one.

#include <cstdint>
#include <cuda_runtime.h>

#include "angle.cuh"

namespace {

constexpr int kThreads = 256;

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
  const float a = need[i] ? orientation_angle(d0[i], d1[i], op_by_op) : given[i];
  angle[i] = a;
  theta[i] = rotation_bin(a, n_rot, op_by_op);
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

// float -> int32 as torch's CPU conversion (x86's cvttss2si) gives it:
// truncation, and INT_MIN for NaN and out-of-range values.
__device__ __forceinline__ int32_t trunc_i32(float x) {
  return (x >= -2147483648.0f && x < 2147483648.0f) ? __float2int_rz(x) : INT32_MIN;
}

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(a, __fmul_rn(t, __fsub_rn(b, a)));  // a + t * (b - a)
}

__global__ void walk_angles_kernel(const float2* __restrict__ maps, int mh, int mw,
                                   const int32_t* __restrict__ view,
                                   const float* __restrict__ base_x, int s_bx,
                                   const float* __restrict__ base_y, int s_by,
                                   const float* __restrict__ size, int s_size,
                                   const float* __restrict__ step_a, int s_a,
                                   const float* __restrict__ step_b, int s_b,
                                   const float* __restrict__ ref_x, int s_rx,
                                   const float* __restrict__ ref_y, int s_ry,
                                   float* __restrict__ out, int n, bool from_angle) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float dx, dy;
  if (from_angle) {  // angle * float32(pi / 180), then glibc's sincosf
    const float rad = __fmul_rn(step_a[static_cast<int64_t>(i) * s_a], f32(0x3c8efa35u));
    sincosf_glibc(rad, &dy, &dx);
  } else {
    dx = step_a[static_cast<int64_t>(i) * s_a];
    dy = step_b[static_cast<int64_t>(i) * s_b];
  }
  const float sz = size[static_cast<int64_t>(i) * s_size];
  const float px = __fadd_rn(base_x[static_cast<int64_t>(i) * s_bx], __fmul_rn(sz, dx));
  const float py = __fadd_rn(base_y[static_cast<int64_t>(i) * s_by], __fmul_rn(sz, dy));
  // The lookup: the truncated corner clamped into the map, the fractions
  // from it, the lerps along x then y.
  const int32_t xi = min(max(trunc_i32(px), 0), mw - 2);
  const int32_t yi = min(max(trunc_i32(py), 0), mh - 2);
  const float fx = __fsub_rn(px, static_cast<float>(xi));
  const float fy = __fsub_rn(py, static_cast<float>(yi));
  const float2* m = maps + (static_cast<int64_t>(view[i]) * mh + yi) * mw + xi;
  const float2 p00 = m[0], p10 = m[1], p01 = m[mw], p11 = m[mw + 1];
  const float qx = lerp_rn(lerp_rn(p00.x, p10.x, fx), lerp_rn(p01.x, p11.x, fx), fy);
  const float qy = lerp_rn(lerp_rn(p00.y, p10.y, fx), lerp_rn(p01.y, p11.y, fx), fy);
  const float a = atan2f_fdlibm(__fsub_rn(qy, ref_y[static_cast<int64_t>(i) * s_ry]),
                                __fsub_rn(qx, ref_x[static_cast<int64_t>(i) * s_rx]));
  out[i] = __fmul_rn(a, f32(0x42652ee1u));  // float32(180 / pi)
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

extern "C" int brisk_walk_angles(const void* maps, int mh, int mw, const void* view,
                                 const void* base_x, int s_bx, const void* base_y, int s_by,
                                 const void* size, int s_size, const void* step_a, int s_a,
                                 const void* step_b, int s_b, const void* ref_x, int s_rx,
                                 const void* ref_y, int s_ry, void* out, int n, int from_angle,
                                 void* stream) {
  walk_angles_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(maps), mh, mw, static_cast<const int32_t*>(view),
      static_cast<const float*>(base_x), s_bx, static_cast<const float*>(base_y), s_by,
      static_cast<const float*>(size), s_size, static_cast<const float*>(step_a), s_a,
      static_cast<const float*>(step_b), s_b, static_cast<const float*>(ref_x), s_rx,
      static_cast<const float*>(ref_y), s_ry, static_cast<float*>(out), n, from_angle != 0);
  return static_cast<int>(cudaGetLastError());
}

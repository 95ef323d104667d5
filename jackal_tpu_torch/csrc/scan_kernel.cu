// Kernels P1-P3 and the fused cloud and scan: the obstacle scan and the
// point cloud, for Hopper (sm_90a).
//
// Replace the jitted programs of jackal_tpu/scan/obstacle.py, which have no
// Pallas call: P1 obstacle_scan_from_disparity (:105, its binning
// _bin_and_reduce :66, the reprojection jackal_tpu/geometry/reproject.py:41
// reproject_Q and :55 cam_to_robot), P2 point_cloud_from_disparity (:150)
// and P3 obstacle_scan_from_points (:132, the ground gate _ground_mask_jnp
// :95); cloud_scan is P2 with P3 as its epilogue (the gen-pcl tail). Each
// computes what its plain version in scan/obstacle.py computes on the card,
// bit for bit:
//   - every product, sum and quotient of the reprojection is rounded on
//     its own, left to right (__fmul_rn, __fadd_rn, IEEE __fdiv_rn, or
//     their .ftz forms), as torch's separate elementwise launches round
//     them;
//   - the scan computes what the jitted reference computes on XLA:CPU,
//     which runs with denormals-are-zero and flush-to-zero: ftz() makes a
//     subnormal operand or result a zero of its sign, explicitly (the
//     library is not built with -ftz=true: the flushed operations are
//     PTX's .ftz ones, written one by one); P1 flushes its reprojection
//     too, P2 does not (P3 and cloud_scan flush the points as they read
//     them). The angle is glibc's atan2f, which XLA:CPU calls, under
//     those flushes (atan2_xla); the range is sqrt(fma(x, x, y*y))
//     (XLA:CPU contracts it); the angle extrema take flushed angles;
//   - the bin index is floor(fma(-180/pi, theta, fov/2) * ratio),
//     converted with cvt.rzi (NaN -> 0, saturating: ops/convert.to_int32),
//     as the reference computes it under jit (XLA:CPU folds the division
//     into the ratio and contracts the difference into one rounding);
//   - P3's ground threshold height + tan * (x - dist) is one fma.rn.ftz,
//     as the plain fma_f32 emulates it in float64 (then flushed);
// so the only FFMAs of these kernels are the written __fmaf_rn and
// fma.rn.ftz (the range) and those inside the divisions and square roots
// (chip_smoke.py compares their count with a build at -fmad=false).
//
// P1 and P3: one thread a point, kItems (P1) or kPointItems (P3) points a
// thread, a block a chunk of one set (grid.y is the set), so that a 640 x
// 480 map is 600 blocks. A point that is not accepted enters only the
// extrema, with the plain version's fills: its angle and range are not
// computed. A NaN enters every minimum and maximum it takes part in, as
// torch.min, torch.max and the reference's jnp.min do: a minimum is taken
// as the maximum of a rank, 0 for nothing, NaN the top rank, every other
// float its order reversed (-0 below +0); a maximum as the maximum of its
// rank in order. Each block reduces its points' ranks in shared memory (the bins
// with shared atomics, the four extrema by warp reduction), adds its ranks
// to the set's keys in global memory with atomicMax, and the last block of
// a set (a counter after a fence) decodes the keys into the scan and the
// extrema, then sets the keys and the counter back to 0. The wrapper zeroes
// its scratch once and keeps it, so a call is one launch, and nothing goes
// back to the host. A bin decodes to min(its minimum, INF), an empty one to
// INF, as the plain version's scatter into INF gives.
//
// P2 and cloud_scan: kCloudItems pixels a thread, each written as it is
// computed (its point, its packed colour, its valid flag; points staged in
// shared memory for 16-byte stores, a block's or a warp's, were slower on
// the card: tools/scan_store_variants.cu); cloud_scan then runs P3's ground gate and scan on the point in
// its registers, the floats P2 writes, and reduces as P1 does, once a
// block for its kThreads * kCloudItems pixels.
//
// What bounds them: bytes at the main path's shapes (P1 reads a u8 map and
// the u8 cache; P2 writes 17 bytes a pixel, P3 reads 13 a point,
// cloud_scan writes P2's bytes); the f32 arithmetic of the divisions and
// the angle's polynomial is the larger part of the operations
// (chip_smoke.scan_work counts both).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 2;          // pixels a thread in P1
constexpr int kPointItems = 8;     // points a thread in P3
constexpr int kCloudItems = 4;     // pixels a thread in P2 and cloud_scan
constexpr int kMaxBins = 4096;     // obstacle.py _MAX_BINS
constexpr int kExtrema = 4;        // angle_min, angle_max, range_min, range_max
constexpr float kInf = 1e9f;       // obstacle.py INF
constexpr float kFltMin = 0x1p-126f;
constexpr unsigned kNanRank = 0xFFFFFFFFu;

// glibc 2.36's atanf and atan2f constants (sysdeps/ieee754/flt-32), as its
// decimal literals round to float
__constant__ float kAT[11] = {
    0x1.555556p-2f, -0x1.99999ap-3f, 0x1.24924ap-3f, -0x1.c71c70p-4f,
    0x1.745cdcp-4f, -0x1.3b0f2ap-4f, 0x1.10d66ap-4f, -0x1.dde2d6p-5f,
    0x1.97b4b2p-5f, -0x1.2b4442p-5f, 0x1.0ad3aep-6f};
__constant__ float kAtanHi[4] = {0x1.dac670p-2f, 0x1.921fb4p-1f,
                                 0x1.f730bcp-1f, 0x1.921fb4p+0f};
__constant__ float kAtanLo[4] = {0x1.586ed2p-28f, 0x1.4442d0p-25f,
                                 0x1.281f68p-25f, 0x1.4442d0p-24f};
constexpr float kAtanInf = 0x1.921fb6p+0f;   // atanhi[3] + atanlo[3]
constexpr float kPi = 0x1.921fb6p+1f;        // pi (+ tiny)
constexpr float kPiLo = -0x1.777a5cp-24f;
constexpr float kPiO2 = 0x1.921fb6p+0f;      // pi/2 (+ tiny, + pi_lo / 2)
constexpr float kPiO4 = 0x1.921fb6p-1f;      // pi/4 + tiny
constexpr float k3PiO4 = 0x1.2d97c8p+1f;     // 3 * pi/4 + tiny

// XLA:CPU's flush: a subnormal is a zero of its sign (NaN, inf kept)
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kFltMin ? __uint_as_float(__float_as_uint(v) & 0x80000000u)
                            : v;
}

// one operation as XLA:CPU runs it: rounded to nearest on its own, each
// subnormal operand read as a zero of its sign and a subnormal result made
// one (PTX .ftz, written in each instruction: no -ftz=true, no contraction)
__device__ __forceinline__ float mul_z(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float add_z(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float sub_z(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float div_z(float a, float b) {
  float r;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float fma_z(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}

__device__ __forceinline__ float sqrt_z(float a) {
  float r;
  asm("sqrt.rn.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// a < b on flushed operands
__device__ __forceinline__ bool lt_z(float a, float b) {
  unsigned r;
  asm("{\n\t.reg .pred p;\n\tsetp.lt.ftz.f32 p, %1, %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}" : "=r"(r) : "f"(a), "f"(b));
  return r != 0u;
}

// the reprojection's operations: flushed where F (the scan from a map), as
// IEEE rounds them where not (the cloud)
template <bool F>
__device__ __forceinline__ float mul(float a, float b) {
  return F ? mul_z(a, b) : __fmul_rn(a, b);
}

template <bool F>
__device__ __forceinline__ float add(float a, float b) {
  return F ? add_z(a, b) : __fadd_rn(a, b);
}

template <bool F>
__device__ __forceinline__ float div(float a, float b) {
  return F ? div_z(a, b) : __fdiv_rn(a, b);
}

// glibc's atanf, each operation rounded on its own; a NaN x gives NaN. No
// intermediate of a normal x underflows, and |x| < 2^-29 (a subnormal too)
// is returned as it is, so it needs no flush of its own
__device__ float atanf_xla(float x) {
  const unsigned hx = __float_as_uint(x), ix = hx & 0x7FFFFFFFu;
  if (ix > 0x7F800000u) return __fadd_rn(x, x);
  if (ix >= 0x4C000000u) return (hx >> 31) ? -kAtanInf : kAtanInf;
  if (ix < 0x31000000u) return x;
  int id = -1;
  float t = x;
  if (ix >= 0x3EE00000u) {
    const float a = fabsf(x);
    float num, den;
    if (ix < 0x3F300000u) {
      id = 0;
      num = __fsub_rn(__fadd_rn(a, a), 1.0f);
      den = __fadd_rn(a, 2.0f);
    } else if (ix < 0x3F980000u) {
      id = 1;
      num = __fsub_rn(a, 1.0f);
      den = __fadd_rn(a, 1.0f);
    } else if (ix < 0x401C0000u) {
      id = 2;
      num = __fsub_rn(a, 1.5f);
      den = __fadd_rn(__fmul_rn(a, 1.5f), 1.0f);
    } else {
      id = 3;
      num = -1.0f;
      den = a;
    }
    t = __fdiv_rn(num, den);
  }
  const float z = __fmul_rn(t, t), w = __fmul_rn(z, z);
  float s1 = __fadd_rn(kAT[8], __fmul_rn(w, kAT[10]));
  s1 = __fadd_rn(kAT[6], __fmul_rn(w, s1));
  s1 = __fadd_rn(kAT[4], __fmul_rn(w, s1));
  s1 = __fadd_rn(kAT[2], __fmul_rn(w, s1));
  s1 = __fmul_rn(z, __fadd_rn(kAT[0], __fmul_rn(w, s1)));
  float s2 = __fadd_rn(kAT[7], __fmul_rn(w, kAT[9]));
  s2 = __fadd_rn(kAT[5], __fmul_rn(w, s2));
  s2 = __fadd_rn(kAT[3], __fmul_rn(w, s2));
  s2 = __fmul_rn(w, __fadd_rn(kAT[1], __fmul_rn(w, s2)));
  const float p = __fmul_rn(t, __fadd_rn(s1, s2));
  if (id < 0) return __fsub_rn(t, p);
  const float r =
      __fsub_rn(kAtanHi[id], __fsub_rn(__fsub_rn(p, kAtanLo[id]), t));
  return (hx >> 31) ? -r : r;
}

// glibc's atan2f(y, x) with denormals-are-zero and flush-to-zero, as the
// jitted reference computes it: the special cases decided on the operands'
// bits (a subnormal is no zero there), the quotient on flushed operands
__device__ float atan2_xla(float y, float x) {
  const unsigned hx = __float_as_uint(x), hy = __float_as_uint(y);
  const unsigned ix = hx & 0x7FFFFFFFu, iy = hy & 0x7FFFFFFFu;
  if (ix > 0x7F800000u || iy > 0x7F800000u) return __fadd_rn(x, y);
  if (hx == 0x3F800000u) return atanf_xla(y);
  const unsigned m = (hy >> 31) | ((hx >> 30) & 2u);  // 2 sign(x) + sign(y)
  if (iy == 0u) return m < 2u ? y : (m == 2u ? kPi : -kPi);
  if (ix == 0u) return (hy >> 31) ? -kPiO2 : kPiO2;
  if (ix == 0x7F800000u) {
    if (iy == 0x7F800000u)
      return m == 0u ? kPiO4 : m == 1u ? -kPiO4 : m == 2u ? k3PiO4 : -k3PiO4;
    return m == 0u ? 0.0f : m == 1u ? -0.0f : m == 2u ? kPi : -kPi;
  }
  if (iy == 0x7F800000u) return (hy >> 31) ? -kPiO2 : kPiO2;
  const int k = ((int)iy - (int)ix) >> 23;
  float z;
  if (k > 60)
    z = kPiO2;
  else if ((hx >> 31) && k < -60)
    z = 0.0f;
  else
    z = atanf_xla(fabsf(div_z(y, x)));
  if (m == 0u) return z;
  if (m == 1u) return -z;
  if (m == 2u) return __fsub_rn(kPi, __fsub_rn(z, kPiLo));
  return __fsub_rn(__fsub_rn(z, kPiLo), kPi);
}

// a float's bits in an order that follows its value (NaN excluded)
__device__ __forceinline__ unsigned order_of(float f) {
  unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// ranks whose maximum is the minimum (rank_min) or the maximum (rank_max)
// of the floats, NaN above all; never 0
__device__ __forceinline__ unsigned rank_min(float f) {
  return isnan(f) ? kNanRank : 0xFFFFFFFEu - order_of(f);
}

__device__ __forceinline__ unsigned rank_max(float f) {
  return isnan(f) ? kNanRank : order_of(f) + 1u;
}

__device__ __forceinline__ float decode_min(unsigned r, float empty) {
  if (r == 0u) return empty;
  if (r == kNanRank) return __uint_as_float(0x7FC00000u);
  return from_order(0xFFFFFFFEu - r);
}

__device__ __forceinline__ float decode_max(unsigned r, float empty) {
  if (r == 0u) return empty;
  if (r == kNanRank) return __uint_as_float(0x7FC00000u);
  return from_order(r - 1u);
}

// M[0] * a + M[1] * b + M[2] * c + e, each product and sum rounded on its
// own, left to right (and flushed where F)
template <bool F>
__device__ __forceinline__ float row(const float* M, float a, float b,
                                     float c, float e) {
  return add<F>(add<F>(add<F>(mul<F>(M[0], a), mul<F>(M[1], b)),
                       mul<F>(M[2], c)), e);
}

// the robot-frame point of pixel (u, v) at disparity d: dehomogenized
// Q @ [u, v, d, 1], then XR @ p + XT (reproject.py reproject_Q,
// cam_to_robot); F flushes every operand and result as the reference's
// scan does
template <bool F>
__device__ __forceinline__ void robot_point(const float* q, const float* R,
                                            const float* T, float u, float v,
                                            float d, float& xr, float& yr,
                                            float& zr) {
  const float w = row<F>(q + 12, u, v, d, q[15]);
  const float X = div<F>(row<F>(q, u, v, d, q[3]), w);
  const float Y = div<F>(row<F>(q + 4, u, v, d, q[7]), w);
  const float Z = div<F>(row<F>(q + 8, u, v, d, q[11]), w);
  xr = row<F>(R, X, Y, Z, T[0]);
  yr = row<F>(R + 3, X, Y, Z, T[1]);
  zr = row<F>(R + 6, X, Y, Z, T[2]);
}

// Q, XR and XT into shared memory
__device__ __forceinline__ void load_calib(const float* Q, const float* XR,
                                           const float* XT, float* q, float* R,
                                           float* T) {
  if (threadIdx.x < 16) q[threadIdx.x] = Q[threadIdx.x];
  if (threadIdx.x < 9) R[threadIdx.x] = XR[threadIdx.x];
  if (threadIdx.x < 3) T[threadIdx.x] = XT[threadIdx.x];
}

struct BinParams {
  int bins;
  float deg;     // f32(180 / REF_PI)
  float half;    // f32(fov / 2)
  float ratio;   // f32(bins * f32(1 / fov))
};

struct GroundParams {
  float tan_a, height, dist;   // flushed by the wrapper
};

// P3's ground gate on flushed operands: z under height where x < dist, else
// under height + tan * (x - dist) rounded once
__device__ __forceinline__ bool is_ground(float xr, float zr,
                                          const GroundParams& g) {
  const float rising = fma_z(g.tan_a, sub_z(xr, g.dist), g.height);
  return lt_z(zr, lt_z(xr, g.dist) ? g.height : rising);
}

// one point's share of its set's scan: accept is the plain version's
// accept (the valid range or the mask and the ground gate)
__device__ __forceinline__ void scan_point(float xr, float yr, bool accept,
                                           const BinParams& p,
                                           unsigned* sh, unsigned ext[4]) {
  // a point that is not accepted enters only the extrema, with the fills
  float theta = 0.0f, r = 0.0f;
  int k = -1;
  if (accept) {
    theta = atan2_xla(yr, xr);
    r = sqrt_z(fma_z(xr, xr, mul_z(yr, yr)));
    k = __float2int_rz(
        floorf(__fmul_rn(__fmaf_rn(-p.deg, theta, p.half), p.ratio)));
    if (k >= 0 && k < p.bins) {
      const unsigned rk = rank_min(r);
      if (rk > sh[k]) atomicMax(&sh[k], rk);
    }
  }
  // every point enters the extrema: an accepted one with its value (the
  // angle flushed, as XLA's reduction reads it), the others with the plain
  // version's fill
  const float th = ftz(theta);
  ext[0] = max(ext[0], rank_min(accept ? th : 400.0f));
  ext[1] = max(ext[1], rank_max(accept ? th : -400.0f));
  ext[2] = max(ext[2], rank_min(accept ? r : kInf));
  ext[3] = max(ext[3], rank_max(accept ? r : -500.0f));
}

// the block's ranks into its set's keys; the set's last block decodes them
// and sets the keys and its counter back to 0 for the next call
__device__ void finish_set(unsigned* sh, unsigned ext[4], const BinParams& p,
                           unsigned* keys, unsigned* counter, float* out,
                           int B, int set) {
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kExtrema; ++i) {
    unsigned m = __reduce_max_sync(0xFFFFFFFFu, ext[i]);
    if (lane == 0 && m > sh[p.bins + i]) atomicMax(&sh[p.bins + i], m);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.bins + kExtrema; i += blockDim.x)
    if (sh[i]) atomicMax(&keys[i], sh[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < p.bins + kExtrema; i += blockDim.x) {
    unsigned r = __ldcg(&keys[i]);
    __stcg(&keys[i], 0u);
    if (i < p.bins) {
      float v = decode_min(r, kInf);
      out[(size_t)set * p.bins + i] = (v > kInf) ? kInf : v;
    } else {
      int e = i - p.bins;
      // a set with no accepted point: the plain version's fills
      float empty = e == 0 ? 400.0f : e == 1 ? -400.0f : e == 2 ? kInf
                                                                : -500.0f;
      float v = (e & 1) ? decode_max(r, empty) : decode_min(r, empty);
      out[(size_t)B * p.bins + (size_t)e * B + set] = v;
    }
  }
  if (threadIdx.x == 0) __stcg(counter, 0u);
}

__device__ __forceinline__ void clear_bins(unsigned* sh, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
}

// P1: the scan of a u8 map [B, H, W] with the valid-range cache [H, W, 2]
__global__ void __launch_bounds__(kThreads)
scan_from_disparity_kernel(const uint8_t* __restrict__ dmap,
                           const uint8_t* __restrict__ vd,
                           const float* __restrict__ Q,
                           const float* __restrict__ XR,
                           const float* __restrict__ XT,
                           unsigned* __restrict__ scratch,
                           float* __restrict__ out, int B, int H, int W,
                           int ox, int oy, BinParams p) {
  extern __shared__ unsigned sh[];
  __shared__ float q[16], R[9], T[3];
  load_calib(Q, XR, XT, q, R, T);
  clear_bins(sh, p.bins + kExtrema);
  const int set = blockIdx.y;
  const int N = H * W;
  const uint8_t* d_set = dmap + (size_t)set * N;
  unsigned ext[kExtrema] = {0u, 0u, 0u, 0u};
  const int base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
  int y = base / W, x = base - y * W;
#pragma unroll
  for (int it = 0; it < kItems; ++it, x += kThreads) {
    while (x >= W) {
      x -= W;
      ++y;
    }
    const int i = base + it * kThreads;
    float xr = 0.0f, yr = 0.0f, zr;
    bool accept = false;
    if (i < N) {
      const int d = d_set[i];
      const uchar2 lim = reinterpret_cast<const uchar2*>(vd)[i];
      accept = d >= lim.x && d <= lim.y;
      robot_point<true>(q, R, T, (float)(x + ox), (float)(y + oy), (float)d,
                        xr, yr, zr);
    }
    scan_point(xr, yr, accept, p, sh, ext);
  }
  const size_t keys = (size_t)set * (p.bins + kExtrema);
  finish_set(sh, ext, p, scratch + keys,
             scratch + (size_t)B * (p.bins + kExtrema) + set, out, B, set);
}

// P3: the scan of robot-frame points [B, N, 3] with the mask [B, N], the
// ground rejected at scan time
__global__ void __launch_bounds__(kThreads)
scan_from_points_kernel(const float* __restrict__ pts,
                        const uint8_t* __restrict__ valid,
                        unsigned* __restrict__ scratch,
                        float* __restrict__ out, int B, int N, BinParams p,
                        GroundParams g) {
  extern __shared__ unsigned sh[];
  clear_bins(sh, p.bins + kExtrema);
  const int set = blockIdx.y;
  const float* p_set = pts + (size_t)set * N * 3;
  const uint8_t* v_set = valid + (size_t)set * N;
  unsigned ext[kExtrema] = {0u, 0u, 0u, 0u};
  const int base = blockIdx.x * (kThreads * kPointItems) + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kPointItems; ++it) {
    const int i = base + it * kThreads;
    float xr = 0.0f, yr = 0.0f;
    bool accept = false;
    if (i < N) {
      xr = p_set[3 * (size_t)i];
      yr = p_set[3 * (size_t)i + 1];
      const float zr = p_set[3 * (size_t)i + 2];
      accept = v_set[i] != 0 && !is_ground(xr, zr, g);
    }
    scan_point(xr, yr, accept, p, sh, ext);
  }
  const size_t keys = (size_t)set * (p.bins + kExtrema);
  finish_set(sh, ext, p, scratch + keys,
             scratch + (size_t)B * (p.bins + kExtrema) + set, out, B, set);
}

// P2 (kScan false) and cloud_scan (kScan true): every pixel's robot-frame
// point, packed colour bits and valid flag; colour frames through their
// element strides (b, y, x, channel), or none. With kScan the points' scan
// with the ground gate (P3) as the epilogue
template <bool kScan>
__device__ __forceinline__ void cloud_body(
    const uint8_t* __restrict__ dmap, const uint8_t* __restrict__ col,
    const float* __restrict__ Q, const float* __restrict__ XR,
    const float* __restrict__ XT, float* __restrict__ pts,
    int32_t* __restrict__ rgb, uint8_t* __restrict__ valid, long long sb,
    long long sy, long long sx, long long sc, int H, int W, int ox, int oy,
    int min_disp, unsigned* __restrict__ scratch, float* __restrict__ out,
    int B, const BinParams& p, const GroundParams& g, unsigned* sh) {
  __shared__ float q[16], R[9], T[3];
  load_calib(Q, XR, XT, q, R, T);
  if (kScan) clear_bins(sh, p.bins + kExtrema);
  else __syncthreads();
  const int N = H * W;
  const int set = blockIdx.y;
  const int base = blockIdx.x * (kThreads * kCloudItems) + threadIdx.x;
  int y = base / W, x = base - y * W;
  unsigned ext[kExtrema] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int it = 0; it < kCloudItems; ++it, x += kThreads) {
    while (x >= W) {
      x -= W;
      ++y;
    }
    const int i = base + it * kThreads;
    float xr = 0.0f, yr = 0.0f, zr = 0.0f;
    bool accept = false;
    if (i < N) {
      const size_t at = (size_t)set * N + i;
      const int d = dmap[at];
      robot_point<false>(q, R, T, (float)(x + ox), (float)(y + oy), (float)d,
                         xr, yr, zr);
      int32_t c = 0;
      if (col) {
        const uint8_t* px = col + set * sb + y * sy + x * sx;
        c = ((int32_t)px[2 * sc] << 16) | ((int32_t)px[sc] << 8) |
            (int32_t)px[0];
      }
      pts[3 * at] = xr;
      pts[3 * at + 1] = yr;
      pts[3 * at + 2] = zr;
      rgb[at] = c;
      valid[at] = d >= min_disp;
      accept = kScan && d >= min_disp && !is_ground(xr, zr, g);
    }
    if (kScan) scan_point(xr, yr, accept, p, sh, ext);
  }
  if (kScan) {
    const size_t keys = (size_t)set * (p.bins + kExtrema);
    finish_set(sh, ext, p, scratch + keys,
               scratch + (size_t)B * (p.bins + kExtrema) + set, out, B, set);
  }
}

__global__ void __launch_bounds__(kThreads)
point_cloud_kernel(const uint8_t* __restrict__ dmap,
                   const uint8_t* __restrict__ col,
                   const float* __restrict__ Q, const float* __restrict__ XR,
                   const float* __restrict__ XT, float* __restrict__ pts,
                   int32_t* __restrict__ rgb, uint8_t* __restrict__ valid,
                   long long sb, long long sy, long long sx, long long sc,
                   int H, int W, int ox, int oy, int min_disp) {
  cloud_body<false>(dmap, col, Q, XR, XT, pts, rgb, valid, sb, sy, sx, sc, H,
                    W, ox, oy, min_disp, nullptr, nullptr, 0, BinParams{},
                    GroundParams{}, nullptr);
}

__global__ void __launch_bounds__(kThreads)
cloud_scan_kernel(const uint8_t* __restrict__ dmap,
                  const uint8_t* __restrict__ col,
                  const float* __restrict__ Q, const float* __restrict__ XR,
                  const float* __restrict__ XT, float* __restrict__ pts,
                  int32_t* __restrict__ rgb, uint8_t* __restrict__ valid,
                  unsigned* __restrict__ scratch, float* __restrict__ out,
                  long long sb, long long sy, long long sx, long long sc,
                  int B, int H, int W, int ox, int oy, int min_disp,
                  BinParams p, GroundParams g) {
  extern __shared__ unsigned sh[];
  cloud_body<true>(dmap, col, Q, XR, XT, pts, rgb, valid, sb, sy, sx, sc, H,
                   W, ox, oy, min_disp, scratch, out, B, p, g, sh);
}

// blocks of kThreads threads taking items points a thread, a row of them a
// set
inline dim3 grid_of(int B, int N, int items) {
  return dim3((N + kThreads * items - 1) / (kThreads * items), B);
}

inline size_t bins_smem(int bins) {
  return (size_t)(bins + kExtrema) * sizeof(unsigned);
}

}  // namespace

extern "C" {

// P1. scratch: int32 [B * (bins + 4) + B], zero before the call and after
// it; out: float32 [B * bins + 4 * B] (the scan, then angle_min, angle_max,
// range_min, range_max of every set)
int scan_from_disparity(const uint8_t* dmap, const uint8_t* vd,
                        const float* Q, const float* XR, const float* XT,
                        unsigned* scratch, float* out, int B, int H, int W,
                        int ox, int oy, int bins, float deg, float half,
                        float ratio, cudaStream_t stream) {
  if (bins < 1 || bins > kMaxBins) return (int)cudaErrorInvalidValue;
  BinParams p{bins, deg, half, ratio};
  scan_from_disparity_kernel<<<grid_of(B, H * W, kItems), kThreads,
                               bins_smem(bins), stream>>>(
      dmap, vd, Q, XR, XT, scratch, out, B, H, W, ox, oy, p);
  return (int)cudaGetLastError();
}

// P3. scratch and out as P1's; tan_a, height, dist flushed
int scan_from_points(const float* pts, const uint8_t* valid,
                     unsigned* scratch, float* out, int B, int N, int bins,
                     float deg, float half, float ratio, float tan_a,
                     float height, float dist, cudaStream_t stream) {
  if (bins < 1 || bins > kMaxBins) return (int)cudaErrorInvalidValue;
  BinParams p{bins, deg, half, ratio};
  scan_from_points_kernel<<<grid_of(B, N, kPointItems), kThreads,
                            bins_smem(bins),
                            stream>>>(pts, valid, scratch, out, B, N, p,
                                      GroundParams{tan_a, height, dist});
  return (int)cudaGetLastError();
}

// P2. col may be null (zero colours); its strides in elements
int point_cloud(const uint8_t* dmap, const uint8_t* col, const float* Q,
                const float* XR, const float* XT, float* pts, int32_t* rgb,
                uint8_t* valid, long long sb, long long sy, long long sx,
                long long sc, int B, int H, int W, int ox, int oy,
                int min_disp, cudaStream_t stream) {
  point_cloud_kernel<<<grid_of(B, H * W, kCloudItems), kThreads, 0, stream>>>(
      dmap, col, Q, XR, XT, pts, rgb, valid, sb, sy, sx, sc, H, W, ox, oy,
      min_disp);
  return (int)cudaGetLastError();
}

// cloud_scan: P2's outputs and P3's scan of them in one launch; scratch and
// out as P1's
int cloud_scan(const uint8_t* dmap, const uint8_t* col, const float* Q,
               const float* XR, const float* XT, float* pts, int32_t* rgb,
               uint8_t* valid, unsigned* scratch, float* out, long long sb,
               long long sy, long long sx, long long sc, int B, int H, int W,
               int ox, int oy, int min_disp, int bins, float deg, float half,
               float ratio, float tan_a, float height, float dist,
               cudaStream_t stream) {
  if (bins < 1 || bins > kMaxBins) return (int)cudaErrorInvalidValue;
  BinParams p{bins, deg, half, ratio};
  cloud_scan_kernel<<<grid_of(B, H * W, kCloudItems), kThreads,
                      bins_smem(bins),
                      stream>>>(dmap, col, Q, XR, XT, pts, rgb, valid, scratch,
                                out, sb, sy, sx, sc, B, H, W, ox, oy, min_disp,
                                p, GroundParams{tan_a, height, dist});
  return (int)cudaGetLastError();
}

}  // extern "C"

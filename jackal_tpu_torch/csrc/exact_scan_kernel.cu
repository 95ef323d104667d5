// The exact float64 obstacle scan in one pass (kernel V).
//
// Replaces no Pallas kernel: the reference package runs the exact scan as
// one jitted program of softfloat float64, jackal_tpu/scan/exact_scan.py:132
// _build_kernel (its arithmetic through jackal_tpu/ops/softfloat.py, jitted
// at :319, behind the entry at :298). The plain PyTorch version of the same
// function is _device_scan in jackal_tpu_torch/scan/exact_scan.py (float64,
// one eager op a step), which obstacle_scan_from_disparity_exact runs on the
// CPU; on a card map it launches this kernel through _device_scan_cuda.
//
// What it computes, operation by operation as _device_scan. dmap is a uint8
// [H, W] map, valid its uint8 [H, W, 2] range; a pixel is accepted where
// lo <= d <= hi. For an accepted pixel (u = col + ox, v = row + oy, all
// float64, every operation correctly rounded by __dmul_rn, __dadd_rn,
// __dsub_rn, __ddiv_rn, __dsqrt_rn: no multiply is fused into an add):
//   r_i = ((Q[i][0] u + Q[i][1] v) + Q[i][2] d) + Q[i][3], X, Y, Z = r_0 /
//   r_3, r_1 / r_3, r_2 / r_3; Xr, Yr = ((XR[i][0] X + XR[i][1] Y) +
//   XR[i][2] Z) + XT[i]; range r = sqrt(Yr Yr + Xr Xr).
// The bin: (Xs, Ys) is (Xr, Yr) scaled by one power of two on the bits
// (_scale_pair); the f32 candidate khat = floor(90 (45 - atan2f(Ys, Xs) *
// f32(180 / 3.1415)) / 90) by __fmul_rn, __fsub_rn, __fdiv_rn (int32 as
// x86's conversion: INT_MIN for NaN); for X > 0 and khat in [-1, 90] the
// exact sign tests of Ys cos M - Xs sin M against the rounding midpoints
// M_j (Dekker's split and error-free products, in double-double, the four
// _boundary_tables held in __constant__ memory) correct it by -1, 0 or +1;
// the origin (X = Y = 0) takes bin 45. Reductions, over the total order of
// the float64 bits (_ord): the least range a bin, the least and greatest
// accepted range, the accepted count, and the angle extrema: the least
// (band, ratio ord) and the greatest, each with its first flat index
// (band: the quadrant class of _device_scan, ratio Ys / Xs, 0 where X = 0).
// The card's atan2f stands in for the CPU's: the midpoint tests decide the
// bin whenever the candidate lies within one bin of it
// (tests/test_torch_exact_scan_edges.py moves the CPU's angle by up to 4096
// ulps and sees no bin change).
//
// out is int64 [kOut]: the 90 bins' least range ords (INT64_MAX where
// empty), the least and greatest range ord, the flat index of the least-
// and greatest-angle pixel (-1 if none), the accepted count, the two
// pixels' d (-1 if none), and the pixels that ran the midpoint tests.
// obstacle_scan_from_disparity_exact reads it with one copy to the host.
//
// What bounds it on an H100: its bytes (3 a pixel in, the 784 bytes out:
// 0.00028 ms at 640x480) or its float64 operations as written, 45 an
// accepted pixel and 94 more where the midpoint tests run, at 33.5 TFLOP/s.
// The design: a thread 4 pixels (kPix), the bins' minima by 64-bit
// shared-memory atomics, the rest by warp shuffles; each block writes a
// record of its partials (no scratch kept, nothing to reset), and a second
// launch of one block reduces the records into out, a warp a field (with a
// thread a field, looping over the records one load after another, V took
// 0.106 ms on an H100 at 640x480).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 90;
constexpr int kNJ = kBins + 2;  // boundary table rows
constexpr int kPix = 4;         // pixels a thread
constexpr int kThreads = 256;
constexpr int kRec = 100;       // a block's record, int64
constexpr int kOut = 98;
constexpr int kMaxDevices = 64;

// rows c_hi, c_lo, s_hi, s_lo of cos and sin at the midpoints M_j
__constant__ double kTab[4][kNJ];

struct ScanArgs {
  double q[4][4];   // Q
  double xr[2][3];  // XR's first two rows
  double xt[2];     // XT's first two entries
  float c180;       // f32(180 / 3.1415)
  int H, W, ox, oy;
};

__device__ __forceinline__ long long bits(double x) {
  return __double_as_longlong(x);
}

// the monotone total order of float64 values as int64 (_ord)
__device__ __forceinline__ long long ord64(double x) {
  const long long b = bits(x);
  return b >= 0 ? b : (~b) ^ LLONG_MIN;
}

__device__ __forceinline__ void split(double a, double& hi, double& lo) {
  const double c = __dmul_rn(a, 134217729.0);  // 2^27 + 1
  hi = __dsub_rn(c, __dsub_rn(c, a));
  lo = __dsub_rn(a, hi);
}

__device__ __forceinline__ void two_prod(double a, double b, double& p,
                                         double& e) {
  p = __dmul_rn(a, b);
  double a1, a2, b1, b2;
  split(a, a1, a2);
  split(b, b1, b2);
  e = __dadd_rn(__dadd_rn(__dadd_rn(__dsub_rn(__dmul_rn(a1, b1), p),
                                    __dmul_rn(a1, b2)),
                          __dmul_rn(a2, b1)),
                __dmul_rn(a2, b2));
}

// True iff the angle of (Xb, Yb) exceeds M_j: the sign of Yb cos M - Xb
// sin M with error-free products (_gt_mid).
__device__ bool gt_mid(double Yb, double Xb, int j) {
  double p1, e1, p2, e2;
  two_prod(Yb, kTab[0][j], p1, e1);
  two_prod(Xb, kTab[2][j], p2, e2);
  const double s0 = __dsub_rn(p1, p2);
  const double bb = __dsub_rn(s0, p1);
  const double err0 =
      __dadd_rn(__dsub_rn(p1, __dsub_rn(s0, bb)), __dsub_rn(-p2, bb));
  const double tail =
      __dadd_rn(__dsub_rn(e1, e2),
                __dsub_rn(__dmul_rn(Yb, kTab[1][j]), __dmul_rn(Xb, kTab[3][j])));
  return bits(__dadd_rn(s0, __dadd_rn(err0, tail))) > 0;
}

// An angle extremum candidate: (band, ratio ord), then the first flat index.
struct Ext {
  long long band, o, flat;
};

// a before b for the least angle; for the greatest, see better_max
__device__ __forceinline__ bool better_min(const Ext& a, const Ext& b) {
  return a.band != b.band ? a.band < b.band
         : a.o != b.o     ? a.o < b.o
                          : a.flat < b.flat;
}
__device__ __forceinline__ bool better_max(const Ext& a, const Ext& b) {
  return a.band != b.band ? a.band > b.band
         : a.o != b.o     ? a.o > b.o
                          : a.flat < b.flat;
}

template <bool kMax>
__device__ __forceinline__ void merge(Ext& a, const Ext& b) {
  if (kMax ? better_max(b, a) : better_min(b, a)) a = b;
}

template <bool kMax>
__device__ __forceinline__ Ext warp_ext(Ext a) {
  for (int o = 16; o > 0; o /= 2) {
    Ext b;
    b.band = __shfl_xor_sync(0xffffffffu, a.band, o);
    b.o = __shfl_xor_sync(0xffffffffu, a.o, o);
    b.flat = __shfl_xor_sync(0xffffffffu, a.flat, o);
    merge<kMax>(a, b);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
    exact_scan_records_kernel(const uint8_t* __restrict__ dmap,
                              const uint8_t* __restrict__ valid,
                              long long* __restrict__ rec, const ScanArgs a) {
  __shared__ long long sbin[kBins];
  __shared__ long long swarp[kThreads / 32][4];
  __shared__ Ext semin[kThreads / 32], semax[kThreads / 32];
  const int tid = threadIdx.x;
  for (int i = tid; i < kBins; i += kThreads) sbin[i] = LLONG_MAX;
  __syncthreads();

  long long rmin = LLONG_MAX, rmax = LLONG_MIN, cnt = 0, nmid = 0;
  Ext emin{9, 0, LLONG_MAX}, emax{-9, 0, LLONG_MAX};
  const long long n = static_cast<long long>(a.H) * a.W;
  for (int i = 0; i < kPix; ++i) {
    const long long p =
        (static_cast<long long>(blockIdx.x) * kPix + i) * kThreads + tid;
    if (p >= n) break;
    const int d = dmap[p];
    if (d < valid[2 * p] || d > valid[2 * p + 1]) continue;
    ++cnt;
    const int col = static_cast<int>(p % a.W), row = static_cast<int>(p / a.W);
    const double ub = __dadd_rn(static_cast<double>(col), static_cast<double>(a.ox));
    const double vb = __dadd_rn(static_cast<double>(row), static_cast<double>(a.oy));
    const double db = static_cast<double>(d);
    double rr[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      rr[k] = __dadd_rn(
          __dadd_rn(__dadd_rn(__dmul_rn(a.q[k][0], ub), __dmul_rn(a.q[k][1], vb)),
                    __dmul_rn(a.q[k][2], db)),
          a.q[k][3]);
    const double X = __ddiv_rn(rr[0], rr[3]), Y = __ddiv_rn(rr[1], rr[3]),
                 Z = __ddiv_rn(rr[2], rr[3]);
    double xy[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      xy[k] = __dadd_rn(
          __dadd_rn(__dadd_rn(__dmul_rn(a.xr[k][0], X), __dmul_rn(a.xr[k][1], Y)),
                    __dmul_rn(a.xr[k][2], Z)),
          a.xt[k]);
    const double Xr = xy[0], Yr = xy[1];
    const long long rkey =
        ord64(__dsqrt_rn(__dadd_rn(__dmul_rn(Yr, Yr), __dmul_rn(Xr, Xr))));
    rmin = min(rmin, rkey);
    rmax = max(rmax, rkey);

    // _scale_pair: one power of two on the bits
    const long long bx = bits(Xr), by = bits(Yr);
    const bool zx = (bx & LLONG_MAX) == 0, zy = (by & LLONG_MAX) == 0;
    const long long ex = (bx >> 52) & 0x7FF, ey = (by >> 52) & 0x7FF;
    const long long shift = (1023 - max(zx ? 0 : ex, zy ? 0 : ey)) << 52;
    const double Xs = __longlong_as_double(zx ? bx : bx + shift);
    const double Ys = __longlong_as_double(zy ? by : by + shift);

    // the bin: the f32 candidate, the midpoint tests
    const bool x_pos = bx >= 0 && !zx;
    int k = -1;
    if (zx && zy) {
      k = kBins / 2;  // atan2(0, 0) = 0: bin 45, r = 0 (the reference bins it)
    } else if (x_pos) {
      const float th = atan2f(__double2float_rn(Ys), __double2float_rn(Xs));
      const float t = floorf(__fdiv_rn(
          __fmul_rn(90.0f, __fsub_rn(45.0f, __fmul_rn(th, a.c180))), 90.0f));
      const int khat = t >= -2147483648.0f && t < 2147483648.0f
                           ? static_cast<int>(t)
                           : INT_MIN;
      if (khat >= -1 && khat <= kBins) {
        ++nmid;
        const bool am = khat >= 0 && gt_mid(Ys, Xs, khat);
        const bool bm = khat + 1 > kBins || gt_mid(Ys, Xs, khat + 1);
        k = am ? khat - 1 : !bm ? khat + 1 : khat;
      }
    }
    if (k >= 0 && k < kBins) atomicMin(&sbin[k], rkey);

    // the angle extrema: (band, ratio ord), the first flat index
    const bool y_neg = by < 0;
    const long long band = x_pos || (zx && zy) ? 2
                           : zx && y_neg       ? 1
                           : zx                ? 3
                           : y_neg             ? 0
                                               : 4;
    const Ext e{band, ord64(zx ? 0.0 : __ddiv_rn(Ys, Xs)), p};
    merge<false>(emin, e);
    merge<true>(emax, e);
  }

  // the block's record
  for (int o = 16; o > 0; o /= 2) {
    rmin = min(rmin, __shfl_xor_sync(0xffffffffu, rmin, o));
    rmax = max(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    nmid += __shfl_xor_sync(0xffffffffu, nmid, o);
  }
  emin = warp_ext<false>(emin);
  emax = warp_ext<true>(emax);
  const int warp = tid / 32;
  if (tid % 32 == 0) {
    swarp[warp][0] = rmin;
    swarp[warp][1] = rmax;
    swarp[warp][2] = cnt;
    swarp[warp][3] = nmid;
    semin[warp] = emin;
    semax[warp] = emax;
  }
  __syncthreads();
  long long* r = rec + static_cast<long long>(blockIdx.x) * kRec;
  for (int i = tid; i < kBins; i += kThreads) r[i] = sbin[i];
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      swarp[0][0] = min(swarp[0][0], swarp[w][0]);
      swarp[0][1] = max(swarp[0][1], swarp[w][1]);
      swarp[0][2] += swarp[w][2];
      swarp[0][3] += swarp[w][3];
      merge<false>(semin[0], semin[w]);
      merge<true>(semax[0], semax[w]);
    }
    r[90] = swarp[0][0];
    r[91] = swarp[0][1];
    r[92] = swarp[0][2];
    r[93] = swarp[0][3];
    r[94] = semin[0].band;
    r[95] = semin[0].o;
    r[96] = semin[0].flat;
    r[97] = semax[0].band;
    r[98] = semax[0].o;
    r[99] = semax[0].flat;
  }
}

// One block: the blocks' records into out (kOut int64, as listed above). A
// warp a field, its lanes striding the records, then a warp reduction.
__global__ void __launch_bounds__(1024)
    exact_scan_reduce_kernel(const long long* __restrict__ rec, int nrec,
                             const uint8_t* __restrict__ dmap,
                             long long* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto field = [&](int b, int i) { return rec[static_cast<long long>(b) * kRec + i]; };
  // fields 0-93: the bins and the least range (min), the greatest range
  // (max), the accepted and the midpoint-tested counts (sums); 94, 95: the
  // least and the greatest angle
  for (int f = warp; f < 96; f += 32) {
    if (f < 94) {
      const bool lo = f <= 90, hi = f == 91;
      long long m = lo ? LLONG_MAX : hi ? LLONG_MIN : 0;
      for (int b = lane; b < nrec; b += 32) {
        const long long x = field(b, f);
        m = lo ? min(m, x) : hi ? max(m, x) : m + x;
      }
      for (int o = 16; o > 0; o /= 2) {
        const long long y = __shfl_xor_sync(0xffffffffu, m, o);
        m = lo ? min(m, y) : hi ? max(m, y) : m + y;
      }
      // out: the bins, rmin, rmax at 0-91; the accepted count at 94, the
      // midpoint-tested at 97
      if (lane == 0) out[f < 92 ? f : f == 92 ? 94 : 97] = m;
    } else {
      const bool mx = f == 95;
      const int i = mx ? 97 : 94;
      Ext e{mx ? -9 : 9, 0, LLONG_MAX};
      for (int b = lane; b < nrec; b += 32) {
        const Ext g{field(b, i), field(b, i + 1), field(b, i + 2)};
        if (mx) merge<true>(e, g);
        else merge<false>(e, g);
      }
      e = mx ? warp_ext<true>(e) : warp_ext<false>(e);
      if (lane == 0) {
        const bool any = e.flat != LLONG_MAX;
        out[mx ? 93 : 92] = any ? e.flat : -1;
        out[mx ? 96 : 95] = any ? dmap[e.flat] : -1;
      }
    }
  }
}

bool tables_on[kMaxDevices];

}  // namespace

// The records' buffer exact_scan needs at this shape, in int64.
extern "C" long long exact_scan_records(int H, int W) {
  const long long blocks =
      (static_cast<long long>(H) * W + kThreads * kPix - 1) / (kThreads * kPix);
  return blocks * kRec;
}

// dmap uint8 [H, W], valid uint8 [H, W, 2]; rec: exact_scan_records(H, W)
// int64; out int64 [kOut]. coef: Q (16, row-major), XR's first two rows
// (6), XT's first two entries (2); tabs: the four boundary tables (4 x 92,
// c_hi, c_lo, s_hi, s_lo), copied to the card's constant memory at a
// device's first call. Two launches.
extern "C" int exact_scan(const uint8_t* dmap, const uint8_t* valid,
                          long long* rec, long long* out, int H, int W, int ox,
                          int oy, const double* coef, float c180,
                          const double* tabs, void* stream) {
  if (H < 1 || W < 1 || coef == nullptr || tabs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = exact_scan_records(H, W) / kRec;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!tables_on[dev]) {  // the same bytes at every call: set them once
    e = cudaMemcpyToSymbol(kTab, tabs, sizeof(kTab));
    if (e != cudaSuccess) return static_cast<int>(e);
    tables_on[dev] = true;
  }
  ScanArgs a;
  for (int i = 0; i < 16; ++i) a.q[i / 4][i % 4] = coef[i];
  for (int i = 0; i < 6; ++i) a.xr[i / 3][i % 3] = coef[16 + i];
  a.xt[0] = coef[22];
  a.xt[1] = coef[23];
  a.c180 = c180;
  a.H = H;
  a.W = W;
  a.ox = ox;
  a.oy = oy;
  const auto s = static_cast<cudaStream_t>(stream);
  exact_scan_records_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      dmap, valid, rec, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  exact_scan_reduce_kernel<<<1, 1024, 0, s>>>(rec, static_cast<int>(blocks),
                                              dmap, out);
  return static_cast<int>(cudaGetLastError());
}

// Kernels P1-P3: the obstacle scan and the point cloud, for Hopper
// (sm_90a).
//
// Replace the jitted programs of jackal_tpu/scan/obstacle.py, which have no
// Pallas call: P1 obstacle_scan_from_disparity (:105, its binning
// _bin_and_reduce :66, the reprojection jackal_tpu/geometry/reproject.py:41
// reproject_Q and :55 cam_to_robot), P2 point_cloud_from_disparity (:150)
// and P3 obstacle_scan_from_points (:132, the ground gate _ground_mask_jnp
// :95). Each computes what its plain version in scan/obstacle.py computes
// on the card, bit for bit:
//   - every product, sum and quotient of the reprojection is rounded on
//     its own, left to right (__fmul_rn, __fadd_rn, IEEE __fdiv_rn), as
//     torch's separate elementwise launches round them; the range is
//     __fsqrt_rn of the rounded x*x + y*y; atan2f is the library's, as
//     torch.atan2 calls it;
//   - the bin index is floor(fma(-180/pi, theta, fov/2) * ratio),
//     converted with cvt.rzi (NaN -> 0, saturating: ops/convert.to_int32),
//     as the reference computes it under jit (XLA:CPU folds the division
//     into the ratio and contracts the difference into one rounding);
//   - P3's ground threshold height + tan * (x - dist) is one __fmaf_rn, as
//     the plain fma_f32 emulates it in float64;
// so the only FFMAs of these kernels are the __fmaf_rn above and those
// inside atan2f, __fdiv_rn and __fsqrt_rn (chip_smoke.py compares their
// count with a build at -fmad=false).
//
// P1 and P3: one thread a point, kItems points a thread, a block a chunk of
// one set (grid.y is the set). A NaN enters every minimum and maximum it
// takes part in, as torch.min, torch.max and the reference's jnp.min do: a
// minimum is taken as the maximum of a rank, 0 for nothing, NaN the top
// rank, every other float its order reversed; a maximum as the maximum of
// its rank in order. Each block reduces its points' ranks in shared memory
// (the bins with shared atomics, the four extrema by warp reduction), adds
// its ranks to the set's keys in global memory with atomicMax, and the last
// block of a set (a counter after a fence) decodes the keys into the scan
// and the extrema. The keys and counters are zeroed by the wrapper's one
// fill, so a call is one fill and one launch, and nothing goes back to the
// host. A bin decodes to min(its minimum, INF), an empty one to INF, as
// the plain version's scatter into INF gives.
//
// P2: one thread a pixel, writing its point, its packed colour and its
// valid flag; no reduction, no fill.
//
// What bounds them: bytes at the main path's shapes (P1 reads a u8 map and
// the u8 cache; P2 writes 17 bytes a pixel, P3 reads 13 a point); the
// f32 arithmetic of atan2f and the three divisions is the larger part of
// the operations (chip_smoke.scan_work counts both).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;          // points a thread in P1 and P3
constexpr int kMaxBins = 4096;     // obstacle.py _MAX_BINS
constexpr int kExtrema = 4;        // angle_min, angle_max, range_min, range_max
constexpr float kInf = 1e9f;       // obstacle.py INF
constexpr unsigned kNanRank = 0xFFFFFFFFu;

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

// a + b + c + d, each sum rounded on its own, left to right
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

// the robot-frame point of pixel (u, v) at disparity d: dehomogenized
// Q @ [u, v, d, 1], then XR @ p + XT (reproject.py reproject_Q,
// cam_to_robot)
__device__ __forceinline__ void robot_point(const float* q, const float* R,
                                            const float* T, float u, float v,
                                            float d, float& xr, float& yr,
                                            float& zr) {
  float w = sum4(__fmul_rn(q[12], u), __fmul_rn(q[13], v),
                 __fmul_rn(q[14], d), q[15]);
  float X = __fdiv_rn(sum4(__fmul_rn(q[0], u), __fmul_rn(q[1], v),
                           __fmul_rn(q[2], d), q[3]), w);
  float Y = __fdiv_rn(sum4(__fmul_rn(q[4], u), __fmul_rn(q[5], v),
                           __fmul_rn(q[6], d), q[7]), w);
  float Z = __fdiv_rn(sum4(__fmul_rn(q[8], u), __fmul_rn(q[9], v),
                           __fmul_rn(q[10], d), q[11]), w);
  xr = sum4(__fmul_rn(R[0], X), __fmul_rn(R[1], Y), __fmul_rn(R[2], Z), T[0]);
  yr = sum4(__fmul_rn(R[3], X), __fmul_rn(R[4], Y), __fmul_rn(R[5], Z), T[1]);
  zr = sum4(__fmul_rn(R[6], X), __fmul_rn(R[7], Y), __fmul_rn(R[8], Z), T[2]);
}

struct BinParams {
  int bins;
  float deg;     // f32(180 / REF_PI)
  float half;    // f32(fov / 2)
  float ratio;   // f32(bins * f32(1 / fov))
};

// one point's share of its set's scan: accept is the plain version's
// accept (the valid range or the mask and the ground gate)
__device__ __forceinline__ void scan_point(float xr, float yr, bool accept,
                                           const BinParams& p,
                                           unsigned* sh, unsigned ext[4]) {
  float theta = atan2f(yr, xr);
  float r = __fsqrt_rn(__fadd_rn(__fmul_rn(xr, xr), __fmul_rn(yr, yr)));
  int k = __float2int_rz(
      floorf(__fmul_rn(__fmaf_rn(-p.deg, theta, p.half), p.ratio)));
  if (accept && k >= 0 && k < p.bins) {
    unsigned rk = rank_min(r);
    if (rk > sh[k]) atomicMax(&sh[k], rk);
  }
  // every point enters the extrema: an accepted one with its value, the
  // others with the plain version's fill
  ext[0] = max(ext[0], rank_min(accept ? theta : 400.0f));
  ext[1] = max(ext[1], rank_max(accept ? theta : -400.0f));
  ext[2] = max(ext[2], rank_min(accept ? r : kInf));
  ext[3] = max(ext[3], rank_max(accept ? r : -500.0f));
}

// the block's ranks into its set's keys; the set's last block decodes them
__device__ void finish_set(unsigned* sh, unsigned ext[4], const BinParams& p,
                           unsigned* keys, unsigned* counter, float* out,
                           int B, int set) {
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kExtrema; ++i) {
    unsigned m = __reduce_max_sync(0xFFFFFFFFu, ext[i]);
    if (lane == 0) atomicMax(&sh[p.bins + i], m);
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
  if (threadIdx.x < 16) q[threadIdx.x] = Q[threadIdx.x];
  if (threadIdx.x < 9) R[threadIdx.x] = XR[threadIdx.x];
  if (threadIdx.x < 3) T[threadIdx.x] = XT[threadIdx.x];
  clear_bins(sh, p.bins + kExtrema);
  const int set = blockIdx.y;
  const int N = H * W;
  const uint8_t* d_set = dmap + (size_t)set * N;
  unsigned ext[kExtrema] = {0u, 0u, 0u, 0u};
  const int base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
#pragma unroll 2
  for (int it = 0; it < kItems; ++it) {
    int i = base + it * kThreads;
    if (i >= N) break;
    int y = i / W, x = i - y * W;
    int d = d_set[i];
    bool accept = d >= vd[2 * i] && d <= vd[2 * i + 1];
    float xr, yr, zr;
    robot_point(q, R, T, __fadd_rn((float)x, (float)ox),
                __fadd_rn((float)y, (float)oy), (float)d, xr, yr, zr);
    scan_point(xr, yr, accept, p, sh, ext);
  }
  size_t keys = (size_t)set * (p.bins + kExtrema);
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
                        float tan_a, float height, float dist) {
  extern __shared__ unsigned sh[];
  clear_bins(sh, p.bins + kExtrema);
  const int set = blockIdx.y;
  const float* p_set = pts + (size_t)set * N * 3;
  const uint8_t* v_set = valid + (size_t)set * N;
  unsigned ext[kExtrema] = {0u, 0u, 0u, 0u};
  const int base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
#pragma unroll 2
  for (int it = 0; it < kItems; ++it) {
    int i = base + it * kThreads;
    if (i >= N) break;
    float xr = p_set[3 * (size_t)i], yr = p_set[3 * (size_t)i + 1];
    float zr = p_set[3 * (size_t)i + 2];
    float thresh = (xr < dist)
        ? height : __fmaf_rn(tan_a, __fsub_rn(xr, dist), height);
    bool accept = v_set[i] != 0 && !(zr < thresh);
    scan_point(xr, yr, accept, p, sh, ext);
  }
  size_t keys = (size_t)set * (p.bins + kExtrema);
  finish_set(sh, ext, p, scratch + keys,
             scratch + (size_t)B * (p.bins + kExtrema) + set, out, B, set);
}

// P2: every pixel's robot-frame point, packed colour bits and valid flag;
// colour frames through their element strides (b, y, x, channel), or none
__global__ void __launch_bounds__(kThreads)
point_cloud_kernel(const uint8_t* __restrict__ dmap,
                   const uint8_t* __restrict__ col,
                   const float* __restrict__ Q, const float* __restrict__ XR,
                   const float* __restrict__ XT, float* __restrict__ pts,
                   int32_t* __restrict__ rgb, uint8_t* __restrict__ valid,
                   long long sb, long long sy, long long sx, long long sc,
                   int H, int W, int ox, int oy, int min_disp) {
  __shared__ float q[16], R[9], T[3];
  if (threadIdx.x < 16) q[threadIdx.x] = Q[threadIdx.x];
  if (threadIdx.x < 9) R[threadIdx.x] = XR[threadIdx.x];
  if (threadIdx.x < 3) T[threadIdx.x] = XT[threadIdx.x];
  __syncthreads();
  const int N = H * W;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const int set = blockIdx.y;
  const size_t at = (size_t)set * N + i;
  const int y = i / W, x = i - y * W;
  const int d = dmap[at];
  float xr, yr, zr;
  robot_point(q, R, T, __fadd_rn((float)x, (float)ox),
              __fadd_rn((float)y, (float)oy), (float)d, xr, yr, zr);
  pts[3 * at] = xr;
  pts[3 * at + 1] = yr;
  pts[3 * at + 2] = zr;
  int32_t c = 0;
  if (col) {
    const uint8_t* px = col + set * sb + y * sy + x * sx;
    c = ((int32_t)px[2 * sc] << 16) | ((int32_t)px[sc] << 8) | (int32_t)px[0];
  }
  rgb[at] = c;
  valid[at] = d >= min_disp;
}

inline dim3 scan_grid(int B, int N) {
  return dim3((N + kThreads * kItems - 1) / (kThreads * kItems), B);
}

inline size_t bins_smem(int bins) {
  return (size_t)(bins + kExtrema) * sizeof(unsigned);
}

}  // namespace

extern "C" {

// P1. scratch: zeroed int32 [B * (bins + 4) + B]; out: float32
// [B * bins + 4 * B] (the scan, then angle_min, angle_max, range_min,
// range_max of every set)
int scan_from_disparity(const uint8_t* dmap, const uint8_t* vd,
                        const float* Q, const float* XR, const float* XT,
                        unsigned* scratch, float* out, int B, int H, int W,
                        int ox, int oy, int bins, float deg, float half,
                        float ratio, cudaStream_t stream) {
  if (bins < 1 || bins > kMaxBins) return (int)cudaErrorInvalidValue;
  BinParams p{bins, deg, half, ratio};
  scan_from_disparity_kernel<<<scan_grid(B, H * W), kThreads,
                               bins_smem(bins), stream>>>(
      dmap, vd, Q, XR, XT, scratch, out, B, H, W, ox, oy, p);
  return (int)cudaGetLastError();
}

// P3. scratch and out as P1's
int scan_from_points(const float* pts, const uint8_t* valid,
                     unsigned* scratch, float* out, int B, int N, int bins,
                     float deg, float half, float ratio, float tan_a,
                     float height, float dist, cudaStream_t stream) {
  if (bins < 1 || bins > kMaxBins) return (int)cudaErrorInvalidValue;
  BinParams p{bins, deg, half, ratio};
  scan_from_points_kernel<<<scan_grid(B, N), kThreads, bins_smem(bins),
                            stream>>>(pts, valid, scratch, out, B, N, p,
                                      tan_a, height, dist);
  return (int)cudaGetLastError();
}

// P2. col may be null (zero colours); its strides in elements
int point_cloud(const uint8_t* dmap, const uint8_t* col, const float* Q,
                const float* XR, const float* XT, float* pts, int32_t* rgb,
                uint8_t* valid, long long sb, long long sy, long long sx,
                long long sc, int B, int H, int W, int ox, int oy,
                int min_disp, cudaStream_t stream) {
  dim3 grid((H * W + kThreads - 1) / kThreads, B);
  point_cloud_kernel<<<grid, kThreads, 0, stream>>>(
      dmap, col, Q, XR, XT, pts, rgb, valid, sb, sy, sx, sc, H, W, ox, oy,
      min_disp);
  return (int)cudaGetLastError();
}

}  // extern "C"

// ELAS postprocess chain on [B, H, W] float32 disparity maps: the L/R
// consistency check (H), gap interpolation (I), the adaptive mean (J) and
// the median (K).
//
// Replaces the jitted jnp functions of jackal_tpu/matching/elas/post.py
// (no Pallas kernel: each ran as jnp under one jit): left_right_consistency
// _check (l.34), gap_interpolation (l.443), adaptive_mean_sub (l.563),
// adaptive_mean (l.587) and median_filter (l.686). The plain PyTorch
// versions of the same functions are the *_plain functions of
// matching/elas/post.py; each kernel computes what its plain version
// computes, bit for bit:
//
//  H  lr_check_kernel: per pixel and view, uw = u -/+ d (d/2 under
//     subsampling), kept where d >= 0, 0 <= uw < W and the other view at
//     u -/+ clamp(|trunc(uw) - u|, 0, smax) agrees within lr_threshold
//     (-1e9 outside the row), else -10. Both views in one launch.
//  I  gap_pass_kernel: one thread a line (a row, then a column of the row
//     pass's result) walks the line as elas.cpp:1122-1166 does: a run of
//     1..gap_width invalid pixels between two valid ones becomes
//     (d1 + d2) / 2 where |d1 - d2| < 3, else min(d1, d2); with
//     add_corners the line's ends are then extrapolated as the plain
//     version does (the first valid value over the gap_width pixels
//     before it, the last over those after it; a line with none takes
//     its last and first pixel). One code path for ROBOTICS's 3-pixel
//     gaps and MIDDLEBURY's 5000.
//  J  mean_h_kernel / mean_v_kernel: the reference's SSE bilateral filter
//     (elas.cpp:1287-1492), 8 taps (4 under subsampling): weight
//     max(0, 4 - mask(v - x)) with the reference's broken abs-mask (the
//     bits 0x4F000000 of the float 2^31), the lanes paired and summed in
//     the order that rotates with the position (post._lane_mean), the
//     D_copy / D_tmp buffers and their borders.
//  K  median_h_kernel / median_v_kernel: the separable 7-tap median, only
//     where D >= 0 and inside the 3-pixel border, D_temp zero outside it.
//     The median is the 4th of the 7 taps in the order of their radix
//     keys (-0.0 below +0.0, a NaN tap makes it NaN), the order in which
//     torch.median on the card selects, so the bits equal the plain
//     version's on the card.
//
// Exactness: every multiply and add is __fmul_rn / __fadd_rn / __fsub_rn,
// so nvcc contracts none into an FFMA, and the weighted mean's division is
// rounded as IEEE '/' in the plain version rounds it, by integer
// operations (div_even: the weight sums are even integers up to 32).
//
// What bounds them on an H100: bytes. Each pass reads its [B, H, W] map
// (and the other view, or D, where it needs them) once and writes one map:
// 1.23 MB each way for one 640x480 frame, well under a microsecond at
// 3.35 TB/s. They are simple kernels, one thread a pixel (H, J, K) or a
// line (I), and run launch- and latency-bound at these sizes: the row pass
// of I has one thread walking each row, 480 threads for a frame, each with
// kChunk loads in flight.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLineThreads = 64;

__device__ __forceinline__ int64_t gid() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// ---- H: the L/R consistency check ---------------------------------------

__device__ __forceinline__ float lr_one(const float* a_row, const float* b_row,
                                        int u, int W, int sign, int smax,
                                        float thr, int sub) {
  const float da = a_row[u];
  const float wd = sub ? __fmul_rn(da, 0.5f) : da;
  const float uw = __fadd_rn(__int2float_rn(u), sign < 0 ? -wd : wd);
  if (!(da >= 0.f && uw >= 0.f && uw < __int2float_rn(W))) return -10.f;
  // in range here, so the truncation is exact (and saturates elsewhere,
  // as ops/convert.to_int32)
  const int s = min(max(sign * (__float2int_rz(uw) - u), 0), smax);
  const int idx = u + sign * s;
  const float other = (idx >= 0 && idx < W) ? b_row[idx] : -1e9f;
  return fabsf(__fsub_rn(other, da)) <= thr ? da : -10.f;
}

__global__ void lr_check_kernel(const float* __restrict__ D1,
                                const float* __restrict__ D2,
                                float* __restrict__ O1, float* __restrict__ O2,
                                int64_t n, int W, int smax, float thr,
                                int sub) {
  for (int64_t i = gid(); i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int u = static_cast<int>(i % W);
    const int64_t row = i - u;
    O1[i] = lr_one(D1 + row, D2 + row, u, W, -1, smax, thr, sub);
    O2[i] = lr_one(D2 + row, D1 + row, u, W, +1, smax, thr, sub);
  }
}

// ---- I: gap interpolation, one line a thread ------------------------------

// One line: element k at s[k * es], written to d[k * es]. The loads of
// kChunk elements are issued together ahead of the walk, so a thread has
// that many in flight (a column's elements are a row apart). The walk
// keeps the last valid value (a gap's left end) and the line's first and
// last valid pixels: fills lie between valid pixels, so they move none of
// the three.
constexpr int kChunk = 32;

__device__ void gap_line(const float* __restrict__ s, float* __restrict__ d,
                         int len, int64_t es, int gap, int corners) {
  int count = 0, first = len, last = -1;
  float prev = 0.f, dfirst = 0.f;
  for (int u0 = 0; u0 < len; u0 += kChunk) {
    float buf[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      buf[j] = u0 + j < len ? s[(u0 + j) * es] : 0.f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int u = u0 + j;
      if (u >= len) break;
      const float x = buf[j];
      d[u * es] = x;
      if (!(x >= 0.f)) {
        ++count;
        continue;
      }
      const int u1 = u - count;
      if (count >= 1 && count <= gap && u1 > 0) {
        const float fill = fabsf(__fsub_rn(prev, x)) < 3.f
                               ? __fmul_rn(__fadd_rn(prev, x), 0.5f)
                               : (x < prev ? x : prev);
        for (int k = u1; k < u; ++k) d[k * es] = fill;
      }
      count = 0;
      prev = x;
      if (first == len) {
        first = u;
        dfirst = x;
      }
      last = u;
    }
  }
  if (!corners) return;
  // a line without a valid pixel takes its last and first pixel, as the
  // plain version's clamped gathers do
  if (last < 0) {
    dfirst = s[(len - 1) * es];
    prev = s[0];
  }
  for (int u = max(first - gap, 0); u < first; ++u) d[u * es] = dfirst;
  const int end = min(last + gap, len - 1);
  for (int u = last + 1; u <= end; ++u) d[u * es] = prev;
}

// Line t of `lines` a frame, for each of `frames` frames: element k at
// (t / lines) * fs + (t % lines) * ls + k * es.
__global__ void gap_pass_kernel(const float* __restrict__ src,
                                float* __restrict__ dst, int frames,
                                int lines, int len, int64_t es, int64_t ls,
                                int64_t fs, int gap, int corners) {
  const int64_t n = static_cast<int64_t>(frames) * lines;
  for (int64_t t = gid(); t < n; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t base = (t / lines) * fs + (t % lines) * ls;
    gap_line(src + base, dst + base, len, es, gap, corners);
  }
}

// ---- J: the adaptive mean ---------------------------------------------------

__device__ __forceinline__ float weight(float v, float x) {
  // the reference's 'absolute value' of v - x: its bits & those of 2^31
  // (post._ref_absmask)
  const float m = __uint_as_float(__float_as_uint(__fsub_rn(v, x)) & 0x4F000000u);
  return fmaxf(__fsub_rn(4.f, m), 0.f);
}

__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

// fs / n rounded to nearest even, as IEEE division rounds it, for an even
// n in [2, 32], with integer operations only: the f32 and f64 division
// routines both contain FFMAs, and this library holds none. The weights
// max(0, 4 - mask(v - x)) are 0, 2 or 4 for every float v and x (the
// mask's exponent field is 0, an even value below 127, whose 2^-97 or less
// 4 - m rounds away, or 128 + an even value, giving 2 or at least 8), so
// the weight sums are even integers up to 32 (16 with 4 taps). Only
// d >= 0 is stored, so a negative or NaN fs needs no quotient: it is
// returned as it is (negative, or NaN: not stored either way); +-0 and
// +inf divide to themselves. For a finite fs > 0 = F * 2^(e-150) and
// n = o * 2^k (o odd): N = (F << 8) / o and its remainder give the
// quotient (N + rem / o) * 2^s exactly; it is rounded to 24 bits, or to
// the subnormal grid 2^-149, at bit sh >= 1 of N, the remainder standing
// for the bits below N.
__device__ __forceinline__ float div_even(float fs, int n) {
  if (!(fs > 0.f) || fs == __int_as_float(0x7f800000)) return fs;
  const uint32_t b = __float_as_uint(fs);
  const int k = __ffs(n) - 1;
  const uint32_t o = static_cast<uint32_t>(n) >> k;
  const int e = static_cast<int>((b >> 23) & 0xffu);
  const uint32_t F = e ? ((b & 0x7fffffu) | 0x800000u) : (b & 0x7fffffu);
  const int s = (e ? e : 1) - 158 - k;
  const uint32_t N = (F << 8) / o;
  const uint32_t rem = (F << 8) - N * o;
  const int t = max(s + (32 - __clz(N)) - 24, -149);   // the result's lsb
  const int sh = t - s;                                 // 1..13
  uint32_t m = N >> sh;
  const uint32_t half = 1u << (sh - 1);
  const uint32_t low = N & ((half << 1) - 1u);
  if (low > half || (low == half && (rem != 0u || (m & 1u)))) ++m;
  int tt = t;
  if (m == (1u << 24)) {
    m >>= 1;
    ++tt;
  }
  if (m < (1u << 23)) return __uint_as_float(m);        // subnormal
  return __uint_as_float((static_cast<uint32_t>(tt + 150) << 23) |
                         (m & 0x7fffffu));
}

// The weighted mean at position pos of its line from the taps v[0..kTaps)
// (offsets -kTaps/2 .. kTaps/2 - 1); ok as post._lane_mean's store_ok.
template <int kTaps>
__device__ __forceinline__ float lane_mean(const float (&v)[kTaps], float x,
                                           int pos, bool& ok) {
  float pw[4], pf[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (kTaps == 8) {
      // the SSE ring pairs the taps 4 apart in one lane
      const float wa = weight(v[t], x), wb = weight(v[t + 4], x);
      pw[t] = __fadd_rn(wa, wb);
      pf[t] = __fadd_rn(__fmul_rn(wa, v[t]), __fmul_rn(wb, v[t + 4]));
    } else {
      const float w = weight(v[t], x);
      pw[t] = w;
      pf[t] = __fmul_rn(w, v[t]);
    }
  }
  // the lanes are added from lane (shift - pos) % 4 on
  constexpr int kShift = kTaps == 8 ? 0 : 2;
  float ws, fs;
  switch ((kShift - pos) & 3) {
    case 0:
      ws = sum4(pw[0], pw[1], pw[2], pw[3]);
      fs = sum4(pf[0], pf[1], pf[2], pf[3]);
      break;
    case 1:
      ws = sum4(pw[1], pw[2], pw[3], pw[0]);
      fs = sum4(pf[1], pf[2], pf[3], pf[0]);
      break;
    case 2:
      ws = sum4(pw[2], pw[3], pw[0], pw[1]);
      fs = sum4(pf[2], pf[3], pf[0], pf[1]);
      break;
    default:
      ws = sum4(pw[3], pw[0], pw[1], pw[2]);
      fs = sum4(pf[3], pf[0], pf[1], pf[2]);
      break;
  }
  // ws is an even integer in [0, 32] (see div_even), 1 where it is 0
  const float d = ws > 0.f ? div_even(fs, __float2int_rz(ws)) : fs;
  ok = ws > 0.f && d >= 0.f;
  return d;
}

__device__ __forceinline__ float copy_val(float x) {
  return x < 0.f ? -10.f : x;           // D_copy
}

// Horizontal pass over D_copy into D_tmp. Rows [3, H-4] and columns
// [4, W-4] (8 taps) or [2, W-2] (4 taps) take the mean where it stores;
// D_tmp is -10 at invalid pixels and 0 elsewhere.
template <int kTaps>
__global__ void mean_h_kernel(const float* __restrict__ D,
                              float* __restrict__ T, int64_t n, int H, int W) {
  constexpr int kHalf = kTaps / 2;
  const int c0 = kTaps == 8 ? 4 : 2, c1 = kTaps == 8 ? W - 4 : W - 2;
  for (int64_t i = gid(); i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % W);
    const int r = static_cast<int>((i / W) % H);
    const float* row = D + (i - c);
    const float x = copy_val(D[i]);
    float v[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int cc = c + j - kHalf;
      v[j] = (cc >= 0 && cc < W) ? copy_val(row[cc]) : 0.f;
    }
    bool ok;
    const float m = lane_mean<kTaps>(v, x, c, ok);
    const bool in = r >= 3 && r <= H - 4 && c >= c0 && c <= c1;
    T[i] = (in && ok) ? m : (D[i] < 0.f ? -10.f : 0.f);
  }
}

// Vertical pass over D_tmp: rows [4, H-4] (8 taps) or [2, H-2] (4 taps)
// and columns [3, W-4] take the mean where it stores, the rest keeps D.
template <int kTaps>
__global__ void mean_v_kernel(const float* __restrict__ D,
                              const float* __restrict__ T,
                              float* __restrict__ O, int64_t n, int H, int W) {
  constexpr int kHalf = kTaps / 2;
  const int r0 = kTaps == 8 ? 4 : 2, r1 = kTaps == 8 ? H - 4 : H - 2;
  for (int64_t i = gid(); i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % W);
    const int r = static_cast<int>((i / W) % H);
    const float* col = T + (i - static_cast<int64_t>(r) * W);
    float v[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int rr = r + j - kHalf;
      v[j] = (rr >= 0 && rr < H) ? col[static_cast<int64_t>(rr) * W] : 0.f;
    }
    bool ok;
    const float m = lane_mean<kTaps>(v, T[i], r, ok);
    const bool in = r >= r0 && r <= r1 && c >= 3 && c <= W - 4;
    O[i] = (in && ok) ? m : D[i];
  }
}

// ---- K: the median -----------------------------------------------------------

// torch.median's order on the card: the float's radix key, every NaN
// above +inf
__device__ __forceinline__ uint32_t fkey(float v) {
  const uint32_t x = __float_as_uint(v);
  if (v != v) return 0xffffffffu;
  return x ^ ((x & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float unkey(uint32_t k) {
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ void cswap(uint32_t& a, uint32_t& b) {
  const uint32_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// the 4th smallest of 7 keys (a 16-comparator sorting network); NaN if
// any is NaN, as torch.median
__device__ __forceinline__ float median7(uint32_t (&k)[7]) {
  cswap(k[0], k[6]); cswap(k[2], k[3]); cswap(k[4], k[5]);
  cswap(k[0], k[2]); cswap(k[1], k[4]); cswap(k[3], k[6]);
  cswap(k[0], k[1]); cswap(k[2], k[5]); cswap(k[3], k[4]);
  cswap(k[1], k[2]); cswap(k[4], k[6]);
  cswap(k[2], k[3]); cswap(k[4], k[5]);
  cswap(k[1], k[2]); cswap(k[3], k[4]); cswap(k[5], k[6]);
  return unkey(k[6] == 0xffffffffu ? k[6] : k[3]);
}

constexpr int kWs = 3;   // half window (elas.cpp:1500)

__device__ __forceinline__ bool interior(int r, int c, int H, int W) {
  return r >= kWs && r < H - kWs && c >= kWs && c < W - kWs;
}

// D_temp: the row median where D >= 0, D elsewhere, inside the border; 0
// on it (calloc)
__global__ void median_h_kernel(const float* __restrict__ D,
                                float* __restrict__ T, int64_t n, int H,
                                int W) {
  for (int64_t i = gid(); i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % W);
    const int r = static_cast<int>((i / W) % H);
    const float x = D[i];
    float out = 0.f;
    if (interior(r, c, H, W)) {
      out = x;
      if (x >= 0.f) {
        uint32_t k[7];
#pragma unroll
        for (int j = 0; j < 7; ++j) k[j] = fkey(D[i + j - kWs]);
        out = median7(k);
      }
    }
    T[i] = out;
  }
}

__global__ void median_v_kernel(const float* __restrict__ D,
                                const float* __restrict__ T,
                                float* __restrict__ O, int64_t n, int H,
                                int W) {
  for (int64_t i = gid(); i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % W);
    const int r = static_cast<int>((i / W) % H);
    const float x = D[i];
    float out = x;
    if (x >= 0.f && interior(r, c, H, W)) {
      uint32_t k[7];
#pragma unroll
      for (int j = 0; j < 7; ++j)
        k[j] = fkey(T[i + static_cast<int64_t>(j - kWs) * W]);
      out = median7(k);
    }
    O[i] = out;
  }
}

// div_even over a vector, for the tests that hold it against IEEE '/'
__global__ void div_even_kernel(const float* __restrict__ fs,
                                float* __restrict__ out, int64_t n, int d) {
  for (int64_t i = gid(); i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = div_even(fs[i], d);
}

int grid_for(int64_t n, int threads) {
  const int64_t b = (n + threads - 1) / threads;
  return static_cast<int>(b < 65536 ? b : 65536);
}

}  // namespace

extern "C" int elas_lr_check(const float* D1, const float* D2, float* O1,
                             float* O2, int B, int H, int W, int smax,
                             float thr, int sub, void* stream) {
  const int64_t n = static_cast<int64_t>(B) * H * W;
  lr_check_kernel<<<grid_for(n, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(D1, D2, O1, O2, n, W,
                                                         smax, thr, sub);
  return static_cast<int>(cudaGetLastError());
}

// row pass D -> T, then column pass T -> O
extern "C" int elas_gap_interp(const float* D, float* T, float* O, int B,
                               int H, int W, int gap, int corners,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t fs = static_cast<int64_t>(H) * W;
  gap_pass_kernel<<<grid_for(static_cast<int64_t>(B) * H, kLineThreads),
                    kLineThreads, 0, st>>>(D, T, B, H, W, 1, W, fs, gap,
                                           corners);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gap_pass_kernel<<<grid_for(static_cast<int64_t>(B) * W, kLineThreads),
                    kLineThreads, 0, st>>>(T, O, B, W, H, W, 1, fs, gap,
                                           corners);
  return static_cast<int>(cudaGetLastError());
}

// horizontal pass D -> T (D_tmp), vertical pass T -> O; taps 8 or 4
extern "C" int elas_adaptive_mean(const float* D, float* T, float* O, int B,
                                  int H, int W, int taps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(B) * H * W;
  const int g = grid_for(n, kThreads);
  if (taps == 8) {
    mean_h_kernel<8><<<g, kThreads, 0, st>>>(D, T, n, H, W);
  } else {
    mean_h_kernel<4><<<g, kThreads, 0, st>>>(D, T, n, H, W);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (taps == 8) {
    mean_v_kernel<8><<<g, kThreads, 0, st>>>(D, T, O, n, H, W);
  } else {
    mean_v_kernel<4><<<g, kThreads, 0, st>>>(D, T, O, n, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

// horizontal pass D -> T (D_temp), vertical pass T -> O
extern "C" int elas_median(const float* D, float* T, float* O, int B, int H,
                           int W, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(B) * H * W;
  const int g = grid_for(n, kThreads);
  median_h_kernel<<<g, kThreads, 0, st>>>(D, T, n, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  median_v_kernel<<<g, kThreads, 0, st>>>(D, T, O, n, H, W);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = div_even(fs[i], d) for an even d in [2, 32]: J's division alone
extern "C" int elas_div_even(const float* fs, float* out, int64_t n, int d,
                             void* stream) {
  div_even_kernel<<<grid_for(n, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(fs, out, n, d);
  return static_cast<int>(cudaGetLastError());
}

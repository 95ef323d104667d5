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
//     (-1e9 outside the row), else -10 (lr_one, elas_lr.cuh). Both views
//     in one launch. Where one block of kernel B owns whole rows (W <=
//     1024, no subsampling: every preset) B runs the check as its
//     epilogue instead, and this kernel does not launch.
//  I  gap interpolation, a row pass and then a column pass over the row
//     pass's result (elas.cpp:1122-1166): a run of 1..gap_width invalid
//     pixels between two valid ones becomes (d1 + d2) / 2 where |d1 - d2|
//     < 3, else min(d1, d2); with add_corners each pass then extrapolates
//     the line's ends as the plain version does (the first valid value
//     over the gap_width pixels before it, the last over those after it;
//     a line with none takes its last and first pixel). Two designs:
//     gap_tile_kernel, one launch, for gap_width <= 8 without corners
//     (ROBOTICS: 3, subsampled: 2), and gap_scan_kernel, a row launch and
//     a column launch, for the rest (MIDDLEBURY: 5000 with corners).
//  J  mean_tile_kernel, one launch: the reference's SSE bilateral filter
//     (elas.cpp:1287-1492), 8 taps (4 under subsampling): weight
//     max(0, 4 - mask(v - x)) with the reference's broken abs-mask (the
//     bits 0x4F000000 of the float 2^31), the lanes paired and summed in
//     the order that rotates with the position (post._lane_mean), the
//     D_copy / D_tmp buffers and their borders.
//  K  median_tile_kernel, one launch: the separable 7-tap median, only
//     where D >= 0 and inside the 3-pixel border, D_temp zero outside it.
//     The median is the 4th of the 7 taps in the order of their radix
//     keys (-0.0 below +0.0, a NaN tap makes it NaN), the order in which
//     torch.median on the card selects, and a NaN comes back as
//     torch.median returns it (median_taps), so the bits equal the plain
//     version's on the card.
//
// Exactness: every multiply and add is __fmul_rn / __fadd_rn / __fsub_rn,
// so nvcc contracts none into an FFMA, and the weighted mean's division is
// rounded as IEEE '/' in the plain version rounds it, by integer
// operations (div_even: the weight sums are even integers up to 32).
//
// What bounds them on an H100: bytes. Each kernel reads its [B, H, W] map
// (and the other view, or D, where it needs them) once and writes one map:
// 1.23 MB each way for one 640x480 frame, well under a microsecond at
// 3.35 TB/s. At these sizes they run bound by latency and launches: H is
// a thread a pixel, and a tile kernel's launch alone takes ~0.0045 ms at
// 640x480, H's own time, so H gains only by fusion (into kernel B, which
// holds both rows on chip already). I's first design walked each line with
// one thread (480 threads a frame, 193x its bound); J's and K's ran their
// two passes as two launches through a scratch map. I, J and K now keep
// the pass between them in shared memory: a block owns a 32 x 32 output
// tile and its halo (300 blocks a 640x480 frame, over two rounds of the
// 132 SMs), with coalesced loads and one coalesced store; I's scan design
// for long gaps has no thread walk a line: a block a line, the nearest
// valid pixels from ballots.
//
// The u8 map. The node publishes clip(round(D1), 0, 255) as u8 (ops/
// convert.dmap_u8, round half to even). The last of I, J, K that runs
// writes it as its epilogue (Sink below): beside each float of the first
// view's frames it stores (uint8) min(max(rintf(v), 0), 255), rintf in the
// default rounding mode rounding half to even as torch.round does. The
// same Sink lets the last kernel write each view's frames where the caller
// wants them (the batched path's output rows), so no copy follows it.
// elas_u8 is that store alone, one launch, for a map that reaches no tail
// (the per-frame bail-out's -10 map).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "elas_lr.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t gid() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ uint8_t u8_of(float v) {
  return static_cast<uint8_t>(
      static_cast<int>(fminf(fmaxf(rintf(v), 0.0f), 255.0f)));
}

// Where a kernel's last pass stores frame b of its [B, H, W] output:
// frames b < n0 (the first view) at O, the others at O2, and, where U is
// set, the u8 map of the first view's frames beside them.
struct Sink {
  float* O;
  float* O2;
  uint8_t* U;
  int n0;
  __device__ __forceinline__ float* frame(int b, int64_t hw) const {
    return b < n0 ? O + b * hw : O2 + (b - n0) * hw;
  }
  __device__ __forceinline__ uint8_t* u8_frame(int b, int64_t hw) const {
    return U != nullptr && b < n0 ? U + b * hw : nullptr;
  }
  __device__ __forceinline__ void put(int b, int64_t hw, int64_t i,
                                      float v) const {
    frame(b, hw)[i] = v;
    if (uint8_t* u = u8_frame(b, hw)) u[i] = u8_of(v);
  }
};

// ---- H: the L/R consistency check ---------------------------------------

// lr_one (elas_lr.cuh) for both views, a thread a pixel. Kernel B runs the
// same check as its epilogue where one block owns whole rows (dense.py
// dense_match_pair_lr); this kernel takes the rest: subsampled maps and
// rows past kernel B's 1024-column strip.
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

// ---- I: gap interpolation ----------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;

// A run of invalid pixels between the valid d1 (before it) and d2 (after
// it) becomes (d1 + d2) / 2 where |d1 - d2| < 3, else min(d1, d2)
__device__ __forceinline__ float gap_fill(float d1, float d2) {
  return fabsf(__fsub_rn(d1, d2)) < 3.f ? __fmul_rn(__fadd_rn(d1, d2), 0.5f)
                                        : (d2 < d1 ? d2 : d1);
}

// One pixel of a line pass from the line's validity bits m (bit t: the
// pixel at t, which holds x): the nearest valid pixel within K before and
// after it, filled where the run between them is at most gap long. vals
// holds the line, v[t].
__device__ __forceinline__ float fill_bounded(unsigned long long m, int t,
                                              int K, int gap, float x,
                                              const float* v, int stride) {
  if (x >= 0.f) return x;
  const unsigned long long reach = (1ull << K) - 1ull;
  const unsigned long long lo = (m >> (t - K)) & reach;  // t-K .. t-1
  const unsigned long long hi = (m >> (t + 1)) & reach;  // t+1 .. t+K
  if (!lo || !hi) return x;
  const int kl = K - (63 - __clzll(lo));                 // distance before
  const int kr = __ffsll(hi);                            // and after
  return kl + kr - 1 <= gap ? gap_fill(v[(t - kl) * stride],
                                       v[(t + kr) * stride])
                            : x;
}

// The bounded design, for gap <= kGapTileMax without corners: a block owns
// a kTile x kTile output tile of one frame and stages it with K = gap + 1
// rows and columns of halo (invalid outside the frame) in shared memory.
// It fills the rows of the tile and of its halo rows in shared memory (a
// warp a row, a lane a column, the row's validity as two ballots), then,
// after a barrier, the columns of that result (a warp a column, a lane an
// output row, the column's validity as two ballots), and writes the tile
// once, coalesced, from shared memory. The row fill of a halo row is the
// same as its own tile's, so tiles agree where they meet.
constexpr int kTile = 32;
constexpr int kGapTileMax = 8;
constexpr int kHaloMax = kGapTileMax + 1;
constexpr int kSpan = kTile + 2 * kHaloMax;   // staged rows and columns
constexpr int kTileThreads = 256;

__global__ void __launch_bounds__(kTileThreads)
    gap_tile_kernel(const float* __restrict__ D, Sink out, int H, int W,
                    int tiles_x, int tiles_y, int gap) {
  __shared__ float S[kSpan][kSpan + 1];   // D, invalid (-1) outside
  __shared__ float Rf[kSpan][kTile + 1];  // the row fill, the tile's columns
  __shared__ float Of[kTile][kTile + 1];  // the column fill
  const int K = max(gap, 0) + 1, n = kTile + 2 * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x % tiles_x, rest = blockIdx.x / tiles_x;
  const int by = rest % tiles_y, b = rest / tiles_y;
  const int x0 = bx * kTile - K, y0 = by * kTile - K;   // S[0][0]
  const float* Df = D + static_cast<int64_t>(b) * H * W;
  for (int i = tid; i < n * n; i += kTileThreads) {
    const int r = i / n, c = i - r * n;
    const int y = y0 + r, x = x0 + c;
    S[r][c] = (y >= 0 && y < H && x >= 0 && x < W)
                  ? Df[static_cast<int64_t>(y) * W + x]
                  : -1.f;
  }
  __syncthreads();
  for (int r = warp; r < n; r += kTileThreads / 32) {
    const bool v1 = lane + 32 < n && S[r][lane + 32] >= 0.f;
    const unsigned long long m =
        __ballot_sync(kFull, S[r][lane] >= 0.f) |
        (static_cast<unsigned long long>(__ballot_sync(kFull, v1)) << 32);
    Rf[r][lane] = fill_bounded(m, lane + K, K, gap, S[r][lane + K], S[r], 1);
  }
  __syncthreads();
  for (int c = warp; c < kTile; c += kTileThreads / 32) {
    const bool v1 = lane + 32 < n && Rf[lane + 32][c] >= 0.f;
    const unsigned long long m =
        __ballot_sync(kFull, Rf[lane][c] >= 0.f) |
        (static_cast<unsigned long long>(__ballot_sync(kFull, v1)) << 32);
    Of[lane][c] = fill_bounded(m, lane + K, K, gap, Rf[lane + K][c], &Rf[0][c],
                               kTile + 1);
  }
  __syncthreads();
  const int64_t hw = static_cast<int64_t>(H) * W;
  for (int i = tid; i < kTile * kTile; i += kTileThreads) {
    const int r = i / kTile, c = i % kTile;
    const int y = y0 + K + r, x = x0 + K + c;
    if (y < H && x < W) out.put(b, hw, static_cast<int64_t>(y) * W + x,
                                Of[r][c]);
  }
}

// The scan design, for every other gap width and for add_corners: a block
// owns one line (a row, or a column of the row pass's result), a thread a
// pixel of a chunk of blockDim.x (up to 1024) pixels. Each pixel's nearest
// valid pixels before and after it come from the warps' validity ballots
// (__clz, __ffs) and, across the warps of the chunk, from a ballot of the
// non-empty warps; a line of several chunks carries them across its
// chunks: a sweep from the line's end writes each pixel's nearest valid
// pixel after it into dst (the same thread reads it back), then a sweep
// from its start finishes the pixels. The line's first and last valid
// pixels, for the corners, come from the same ballots.
struct Near {
  int before, after;   // in the chunk: -1 / INT_MAX where there is none
  int first, last;     // the chunk's first and last valid, -1 if none
};

// After each warp has put its ballot m into wmask[warp] and a barrier.
__device__ __forceinline__ Near near_in_chunk(const unsigned* wmask,
                                              unsigned m, int lane, int warp,
                                              int nwarps) {
  Near r;
  const unsigned nz =
      __ballot_sync(kFull, lane < nwarps && wmask[lane] != 0u);
  const unsigned below = m & ((1u << lane) - 1u);
  const unsigned wb = nz & ((1u << warp) - 1u);
  r.before = below ? warp * 32 + 31 - __clz(below)
             : wb  ? (31 - __clz(wb)) * 32 + 31 - __clz(wmask[31 - __clz(wb)])
                   : -1;
  const unsigned above = m & ~((2u << lane) - 1u);
  const unsigned wa = nz & ~((2u << warp) - 1u);
  r.after = above ? warp * 32 + __ffs(above) - 1
            : wa  ? (__ffs(wa) - 1) * 32 + __ffs(wmask[__ffs(wa) - 1]) - 1
                  : INT_MAX;
  if (nz) {
    const int wf = __ffs(nz) - 1, wl = 31 - __clz(nz);
    r.first = wf * 32 + __ffs(wmask[wf]) - 1;
    r.last = wl * 32 + 31 - __clz(wmask[wl]);
  } else {
    r.first = r.last = -1;
  }
  return r;
}

// Pixel k of a line (value x, nearest valid pixels before and after it:
// -1, len where none; the line's first and last valid: len, -1 where none).
__device__ __forceinline__ float scan_pixel(const float* src, int64_t es,
                                            int len, int k, float x,
                                            int before, int after, int first,
                                            int last, int gap, int corners) {
  float out = x;
  if (!(x >= 0.f) && before >= 0 && after < len &&
      static_cast<int64_t>(after) - before - 1 <= gap)
    out = gap_fill(src[before * es], src[after * es]);
  if (corners) {
    // a line without a valid pixel takes its last and first pixel, as the
    // plain version's clamped gathers do
    if (k < first && k >= static_cast<int64_t>(first) - gap)
      out = src[min(first, len - 1) * es];
    if (k > last && k <= static_cast<int64_t>(last) + gap)
      out = src[max(last, 0) * es];
  }
  return out;
}

// Line t of `lines` a frame: element k at (t / lines) * fs + (t % lines) *
// ls + k * es of src, and at (t % lines) * ls + k * es of its frame of out.
__global__ void __launch_bounds__(1024)
    gap_scan_kernel(const float* __restrict__ src, Sink out, int lines,
                    int len, int64_t es, int64_t ls, int64_t fs, int gap,
                    int corners) {
  __shared__ unsigned wmask[32];   // the warps' validity ballots
  const int f = blockIdx.x / lines;
  const int64_t at = (blockIdx.x % lines) * ls;
  src += f * fs + at;
  float* dst = out.frame(f, fs) + at;
  uint8_t* du = out.u8_frame(f, fs);
  if (du != nullptr) du += at;
  const int C = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = C >> 5;
  const int nch = (len + C - 1) / C;
  if (nch == 1) {
    const float x = tid < len ? src[tid * es] : -1.f;
    const unsigned m = __ballot_sync(kFull, tid < len && x >= 0.f);
    if (lane == 0) wmask[warp] = m;
    __syncthreads();
    const Near n = near_in_chunk(wmask, m, lane, warp, nwarps);
    if (tid < len) {
      const float v = scan_pixel(src, es, len, tid, x, n.before,
                                 min(n.after, len), n.first < 0 ? len : n.first,
                                 n.last, gap, corners);
      dst[tid * es] = v;
      if (du != nullptr) du[tid * es] = u8_of(v);
    }
    return;
  }
  // from the end: each pixel's nearest valid pixel after it, into dst
  int next = len, last = -1;
  for (int c = nch - 1; c >= 0; --c) {
    const int k = c * C + tid;
    const float x = k < len ? src[k * es] : -1.f;
    const unsigned m = __ballot_sync(kFull, k < len && x >= 0.f);
    if (lane == 0) wmask[warp] = m;
    __syncthreads();
    const Near n = near_in_chunk(wmask, m, lane, warp, nwarps);
    if (k < len)
      dst[k * es] = __int_as_float(n.after == INT_MAX ? next : c * C + n.after);
    if (n.first >= 0) {
      next = c * C + n.first;
      if (last < 0) last = c * C + n.last;
    }
    __syncthreads();
  }
  const int first = next;
  // from the start: the nearest valid pixel before, and the pixel
  int prev = -1;
  for (int c = 0; c < nch; ++c) {
    const int k = c * C + tid;
    const float x = k < len ? src[k * es] : -1.f;
    const unsigned m = __ballot_sync(kFull, k < len && x >= 0.f);
    if (lane == 0) wmask[warp] = m;
    __syncthreads();
    const Near n = near_in_chunk(wmask, m, lane, warp, nwarps);
    if (k < len) {
      const int after = __float_as_int(dst[k * es]);
      const float v = scan_pixel(src, es, len, k, x,
                                 n.before >= 0 ? c * C + n.before : prev,
                                 after, first, last, gap, corners);
      dst[k * es] = v;
      if (du != nullptr) du[k * es] = u8_of(v);
    }
    if (n.last >= 0) prev = c * C + n.last;
    __syncthreads();
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

// One launch of the adaptive mean: a block owns a kTile x kTile output
// tile of one frame and stages D over it with the taps' halo (kTaps / 2
// rows and columns before it, kTaps / 2 - 1 after; 0 outside the frame).
// It computes D_tmp, the horizontal pass over D_copy, for the tile's
// columns on its rows and its halo rows (0 outside the frame, as the
// vertical pass pads it) in shared memory: rows [3, H-4] and columns
// [4, W-4] (8 taps) or [2, W-2] (4 taps) take the mean where it stores,
// the rest is -10 at invalid pixels and 0 elsewhere. After a barrier the
// vertical pass over D_tmp: rows [4, H-4] (8 taps) or [2, H-2] (4 taps)
// and columns [3, W-4] take the mean where it stores, the rest keeps D;
// it writes the tile once.
template <int kTaps>
__global__ void __launch_bounds__(kTileThreads)
    mean_tile_kernel(const float* __restrict__ D, Sink out, int H, int W,
                     int tiles_x, int tiles_y) {
  constexpr int kHalf = kTaps / 2;
  constexpr int N = kTile + kTaps - 1;    // staged rows and columns
  __shared__ float S[N][N + 1];           // D, 0 outside the frame
  __shared__ float T[N][kTile + 1];       // D_tmp, the tile's columns
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x % tiles_x, rest = blockIdx.x / tiles_x;
  const int by = rest % tiles_y, b = rest / tiles_y;
  const int x0 = bx * kTile - kHalf, y0 = by * kTile - kHalf;   // S[0][0]
  const float* Df = D + static_cast<int64_t>(b) * H * W;
  for (int i = tid; i < N * N; i += kTileThreads) {
    const int r = i / N, c = i - r * N;
    const int y = y0 + r, x = x0 + c;
    S[r][c] = (y >= 0 && y < H && x >= 0 && x < W)
                  ? Df[static_cast<int64_t>(y) * W + x]
                  : 0.f;
  }
  __syncthreads();
  const int hc0 = kTaps == 8 ? 4 : 2, hc1 = kTaps == 8 ? W - 4 : W - 2;
  for (int r = warp; r < N; r += kTileThreads / 32) {
    const int y = y0 + r, x = x0 + kHalf + lane;
    float t = 0.f;
    if (y >= 0 && y < H) {
      float v[kTaps];
#pragma unroll
      for (int j = 0; j < kTaps; ++j) v[j] = copy_val(S[r][lane + j]);
      const float d = S[r][lane + kHalf];
      bool ok;
      const float m = lane_mean<kTaps>(v, copy_val(d), x, ok);
      const bool in = y >= 3 && y <= H - 4 && x >= hc0 && x <= hc1;
      t = (in && ok) ? m : (d < 0.f ? -10.f : 0.f);
    }
    T[r][lane] = t;
  }
  __syncthreads();
  const int vr0 = kTaps == 8 ? 4 : 2, vr1 = kTaps == 8 ? H - 4 : H - 2;
  const int64_t hw = static_cast<int64_t>(H) * W;
  for (int r = warp; r < kTile; r += kTileThreads / 32) {
    const int y = y0 + kHalf + r, x = x0 + kHalf + lane;
    if (y >= H || x >= W) continue;
    float v[kTaps];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) v[j] = T[r + j][lane];
    bool ok;
    const float m = lane_mean<kTaps>(v, T[r + kHalf][lane], y, ok);
    const bool in = y >= vr0 && y <= vr1 && x >= 3 && x <= W - 4;
    out.put(b, hw, static_cast<int64_t>(y) * W + x,
            (in && ok) ? m : S[r + kHalf][lane + kHalf]);
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

// d >= 0 from d's key: -0.0 (0x7fffffff) up to +inf, no NaN (0xffffffff)
__device__ __forceinline__ bool key_valid(uint32_t k) {
  return k >= 0x7fffffffu && k != 0xffffffffu;
}

// The median of 7 taps, their keys k and their values v[0], v[stride], ...,
// as torch.median on the card returns it: its radix select hands back the
// element itself where one tap alone holds the selected key, else the
// key's value. The bits differ only for NaN: one NaN tap comes back as it
// is, several as median7's NaN (0x7fffffff).
__device__ __forceinline__ float median_taps(uint32_t (&k)[7], const float* v,
                                             int stride) {
  const float m = median7(k);   // sorts k
  if (k[6] != 0xffffffffu || k[5] == 0xffffffffu) return m;
  float nan = m;
  for (int j = 0; j < 7; ++j)
    if (v[j * stride] != v[j * stride]) nan = v[j * stride];
  return nan;
}

// One launch of the median: a block owns a kTile x kTile output tile of
// one frame and stages D over it, each value with its key (fkey, once an
// element), with kWs rows and columns of halo (0 outside the frame, where
// no interior pixel's taps reach). It computes D_temp and its keys for the
// tile's columns on its rows and its halo rows in shared memory (a warp a
// row, a lane a column): the row median where D >= 0, D elsewhere, inside
// the 3-pixel border; 0 on it and outside the frame (calloc). After a
// barrier the column median over D_temp where D >= 0 inside the border, D
// elsewhere; it writes the tile once.
__global__ void __launch_bounds__(kTileThreads)
    median_tile_kernel(const float* __restrict__ D, Sink out, int H, int W,
                       int tiles_x, int tiles_y) {
  constexpr int N = kTile + 2 * kWs;      // staged rows and columns
  __shared__ float S[N][N + 1];           // D, 0 outside the frame
  __shared__ uint32_t SK[N][N + 1];       // their keys
  __shared__ float T[N][kTile + 1];       // D_temp, the tile's columns
  __shared__ uint32_t TK[N][kTile + 1];   // their keys
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = blockIdx.x % tiles_x, rest = blockIdx.x / tiles_x;
  const int by = rest % tiles_y, b = rest / tiles_y;
  const int x0 = bx * kTile - kWs, y0 = by * kTile - kWs;   // S[0][0]
  const float* Df = D + static_cast<int64_t>(b) * H * W;
  for (int i = tid; i < N * N; i += kTileThreads) {
    const int r = i / N, c = i - r * N;
    const int y = y0 + r, x = x0 + c;
    const float v = (y >= 0 && y < H && x >= 0 && x < W)
                        ? Df[static_cast<int64_t>(y) * W + x]
                        : 0.f;
    S[r][c] = v;
    SK[r][c] = fkey(v);
  }
  __syncthreads();
  for (int r = warp; r < N; r += kTileThreads / 32) {
    const int y = y0 + r, x = x0 + kWs + lane;
    float t = 0.f;
    if (interior(y, x, H, W)) {
      t = S[r][lane + kWs];
      if (key_valid(SK[r][lane + kWs])) {
        uint32_t k[7];
#pragma unroll
        for (int j = 0; j < 7; ++j) k[j] = SK[r][lane + j];
        t = median_taps(k, &S[r][lane], 1);
      }
    }
    T[r][lane] = t;
    TK[r][lane] = fkey(t);
  }
  __syncthreads();
  const int64_t hw = static_cast<int64_t>(H) * W;
  for (int r = warp; r < kTile; r += kTileThreads / 32) {
    const int y = y0 + kWs + r, x = x0 + kWs + lane;
    if (y >= H || x >= W) continue;
    float v = S[r + kWs][lane + kWs];
    if (key_valid(SK[r + kWs][lane + kWs]) && interior(y, x, H, W)) {
      uint32_t k[7];
#pragma unroll
      for (int j = 0; j < 7; ++j) k[j] = TK[r + j][lane];
      v = median_taps(k, &T[r][lane], kTile + 1);
    }
    out.put(b, hw, static_cast<int64_t>(y) * W + x, v);
  }
}

// div_even over a vector, for the tests that hold it against IEEE '/'
__global__ void div_even_kernel(const float* __restrict__ fs,
                                float* __restrict__ out, int64_t n, int d) {
  for (int64_t i = gid(); i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = div_even(fs[i], d);
}

// the u8 map alone: U = dmap_u8(D)
__global__ void u8_kernel(const float* __restrict__ D, uint8_t* __restrict__ U,
                          int64_t n) {
  for (int64_t i = gid(); i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    U[i] = u8_of(D[i]);
}

int grid_for(int64_t n, int threads) {
  const int64_t b = (n + threads - 1) / threads;
  return static_cast<int>(b < 65536 ? b : 65536);
}

int tiles(int n) { return (n + kTile - 1) / kTile; }

// The Sink of an entry point's O, O2 (null: the frames after O's n0), U
// (null: no u8 map) and n0 (1 <= n0 <= B); false where n0 is out of range.
bool make_sink(float* O, float* O2, uint8_t* U, int n0, int B, int H, int W,
               Sink* s) {
  if (n0 < 1 || n0 > B) return false;
  *s = Sink{O, O2 != nullptr ? O2 : O + static_cast<int64_t>(n0) * H * W, U,
            n0};
  return true;
}

}  // namespace

// Each entry point launches on ``stream`` and puts the number of kernel
// launches it made in *launched.

extern "C" int elas_lr_check(const float* D1, const float* D2, float* O1,
                             float* O2, int B, int H, int W, int smax,
                             float thr, int sub, int* launched,
                             void* stream) {
  const int64_t n = static_cast<int64_t>(B) * H * W;
  lr_check_kernel<<<grid_for(n, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(D1, D2, O1, O2, n, W,
                                                         smax, thr, sub);
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}

// The map entry points (I, J, K) store their output through the Sink of
// O, O2, U and n0 (make_sink): frames b < n0 at O (and their u8 map at U
// where U is set), the rest at O2.

// gap <= kGapTileMax without corners: one launch of the tile kernel, D ->
// out (T may be null); else the scan kernel's row pass D -> T and column
// pass T -> out.
extern "C" int elas_gap_interp(const float* D, float* T, float* O, float* O2,
                               uint8_t* U, int n0, int B, int H, int W,
                               int gap, int corners, int* launched,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  Sink out;
  if (!make_sink(O, O2, U, n0, B, H, W, &out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (gap <= kGapTileMax && !corners) {
    const int64_t blocks = static_cast<int64_t>(B) * tiles(H) * tiles(W);
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    gap_tile_kernel<<<static_cast<unsigned>(blocks), kTileThreads, 0, st>>>(
        D, out, H, W, tiles(W), tiles(H), gap);
    *launched = 1;
    return static_cast<int>(cudaGetLastError());
  }
  if (T == nullptr || static_cast<int64_t>(B) * H > INT_MAX ||
      static_cast<int64_t>(B) * W > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t fs = static_cast<int64_t>(H) * W;
  auto threads = [](int len) { return min(1024, (len + 31) / 32 * 32); };
  const Sink rows{T, T + static_cast<int64_t>(n0) * fs, nullptr, n0};
  gap_scan_kernel<<<B * H, threads(W), 0, st>>>(D, rows, H, W, 1, W, fs, gap,
                                                 corners);
  cudaError_t err = cudaGetLastError();
  *launched = 1;
  if (err != cudaSuccess) return static_cast<int>(err);
  gap_scan_kernel<<<B * W, threads(H), 0, st>>>(T, out, W, H, W, 1, fs, gap,
                                                 corners);
  *launched = 2;
  return static_cast<int>(cudaGetLastError());
}

// D -> out in one launch; taps 8 or 4.
extern "C" int elas_adaptive_mean(const float* D, float* O, float* O2,
                                  uint8_t* U, int n0, int B, int H, int W,
                                  int taps, int* launched, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  Sink out;
  if (!make_sink(O, O2, U, n0, B, H, W, &out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>(B) * tiles(H) * tiles(W);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (taps == 8) {
    mean_tile_kernel<8><<<static_cast<unsigned>(blocks), kTileThreads, 0,
                          st>>>(D, out, H, W, tiles(W), tiles(H));
  } else {
    mean_tile_kernel<4><<<static_cast<unsigned>(blocks), kTileThreads, 0,
                          st>>>(D, out, H, W, tiles(W), tiles(H));
  }
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}

// D -> out in one launch
extern "C" int elas_median(const float* D, float* O, float* O2, uint8_t* U,
                           int n0, int B, int H, int W, int* launched,
                           void* stream) {
  *launched = 0;
  Sink out;
  if (!make_sink(O, O2, U, n0, B, H, W, &out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>(B) * tiles(H) * tiles(W);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  median_tile_kernel<<<static_cast<unsigned>(blocks), kTileThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      D, out, H, W, tiles(W), tiles(H));
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}

// U = dmap_u8(D) over n floats, one launch
extern "C" int elas_u8(const float* D, uint8_t* U, int64_t n, int* launched,
                       void* stream) {
  u8_kernel<<<grid_for(n, kThreads), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(D, U, n);
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}

// out[i] = div_even(fs[i], d) for an even d in [2, 32]: J's division alone
extern "C" int elas_div_even(const float* fs, float* out, int64_t n, int d,
                             void* stream) {
  div_even_kernel<<<grid_for(n, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(fs, out, n, d);
  return static_cast<int>(cudaGetLastError());
}

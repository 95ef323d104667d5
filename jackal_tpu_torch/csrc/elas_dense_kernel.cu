// ELAS dense MAP matching of both views: a keyed minimum over candidates.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/elas_dense_kernel.py
// (_elas_dense_kernel, pallas_call at l.245, wrapper elas_dense_pallas
// l.146). The plain PyTorch version of the same function is
// dense_match_plain in matching/elas/dense.py, once a view.
//
// What it computes, per pixel (b, v, u) of a view, with q/t the
// query/target descriptors [B, H, W, 16] (left view: q = left, t = right,
// sign = -1; right view: swapped, sign = +1) and row v' = clamp(v, 2, H-3):
//   pixel_ok = covered && 2 <= u < W-2 && sum|q(v',u) - 128| >= match_texture
//   candidates d: bit d of the pixel's grid cell (v/gs, u/gs), or the plane
//     window max(dp-r, 0) <= d <= min(dp+r, D-1), with 2 <= u + sign*d < W-2
//   key = (SAD16(q(v',u), t(v',u+sign*d)) + [window] valid*P[|d-dp|] + 16)
//         * 512 + (window ? 256 + d : d)
//   out = !pixel_ok ? -10 : no candidate ? -1 : (min key % 512) % 256
// The rank makes every key unique, so the minimum does not depend on the
// order the candidates are visited. The key's rank field holds d < 256: the
// reference's own function is defined for D <= 256 only.
//
// What bounds it on an H100. ELAS evaluates few candidates a pixel: ~9
// at a matched pixel of the golden 640x480 frames (the 2r+1 = 5-wide
// window and ~4 grid candidates outside it), 16 byte SADs each, ~5e7
// byte SADs a frame, against ~15 MB of input and output for both views:
// bound by bytes. On the card it is bound by instruction issue: the
// staged rows are always ready in time, and clock64 counters put a warp's
// row at ~7,100 cycles for ~400 instructions (estimated from the SASS).
// The first design (one thread a pixel of one view, each lane walking its
// own candidate bits) gathered 32 scattered 16-byte target descriptors
// from device memory at every step, read its cell's candidate words one
// dependent load at a time, and read the descriptor pair once a view.
// This design:
// - one block owns one row v of one frame over a strip of columns (the
//   whole row up to 1024 columns), a thread a column, for BOTH views: it
//   stages the two descriptor rows the strip reads (its columns, D-1 on
//   the side each view looks and kPad zero columns at each end) in shared
//   memory with coalesced 16-byte cp.async, so each descriptor row reaches
//   the SM once for both views; the strip's grid cells' candidate words of
//   both views land beside them;
// - blocks are persistent, as many as fit (3 an SM at 640 columns), and
//   double-buffered: a block stages its next row, and loads that row's
//   pixel maps (packed into one register a view), while it computes this
//   one;
// - the plane window is walked at a fixed 2r+1 steps (d = dp - r + j, the
//   radius a template parameter, 2 to 7): d_plane is clamped once so that
//   every target lies in the padded span, so a step is one shared load at
//   a constant offset, four accumulating VABSDIFF4 and the key. Past
//   radius 7 one more instantiation (R = 0) takes the radius at run time:
//   it walks the window's live d alone (at most D, each a target in the
//   span without padding), keeps d_plane in a register of its own (a
//   window can be as wide as the radius) and reads P[0 .. min(r + 1, D))
//   from a table the wrapper puts on the card, staged in shared memory once
//   a block (P past the table is 0, as in the plain version);
// - grid candidates outside the window are walked per lane, bit by bit,
//   over the cell's non-empty words only (a mask a cell, made by one
//   thread a cell per staged row). A warp-uniform walk (the warp's union
//   of candidate words, every lane at the same d, coalesced reads) was
//   measured too: its union is ~1.5x a lane's own set, and it ran 7-10 %
//   slower than the per-lane walk, whose reads from shared memory are
//   conflict-free within a cell;
// - a warp whose lanes key nothing skips the walks.
//
// The L/R check (kernel H, elas_post_kernel.cu) as an epilogue: where a
// block owns whole rows of both views (one strip, W <= 1024) and the maps
// are not subsampled (every preset), the instantiation with kLR puts each
// tuple's decoded rows of both views in shared memory (2 x strip floats,
// 5 KB at 640 columns) and checks each pixel against the other view's row
// there with H's own lr_one (elas_lr.cuh), so the maps are written once,
// already checked: H's launch and its 4.9 MB round trip through device
// memory at 640x480 are gone. The reference runs dense matching and its
// whole postprocess as one dispatch too (pipeline._dense_post_impl).
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "elas_lr.cuh"

constexpr int kMaxRadius = 7;   // the largest unrolled radius

// P[|d - d_plane|] for |d - d_plane| <= plane radius <= kMaxRadius, passed
// by value
struct PriorTable {
  int p[kMaxRadius + 1];
};

// one view's prior maps and output
struct ViewMaps {
  const void* d_plane;      // int32 or int16 [B, H, W]
  const uint8_t* valid;     // bool [B, H, W]
  const uint8_t* covered;   // bool [B, H, W]
  const uint32_t* grid;     // [B, gh, gw, nw] candidate words
  float* out;               // [B, H, W]
};

namespace {

constexpr int kBig = 1 << 30;
constexpr int kWindow = 2;
constexpr int kKeyBias = 16;
constexpr int kStripMax = 1024;   // columns (threads) a block owns at most
constexpr int kMaxD = 256;        // the key's rank field
// zero columns beyond each end of a staged span, so that a window's
// target at any d in [-2R-1, D+2R] lies in it and needs no clamp
constexpr int kPad = 16;

// sum over the 16 bytes of |a - b|, as one accumulating chain
__device__ __forceinline__ int sad16(const uint4& a, const uint4& b) {
  uint32_t s;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(s) : "r"(a.x), "r"(b.x), "r"(0u));
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(s) : "r"(a.y), "r"(b.y), "r"(s));
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(s) : "r"(a.z), "r"(b.z), "r"(s));
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(s) : "r"(a.w), "r"(b.w), "r"(s));
  return static_cast<int>(s);
}

// bits lo..hi (0 <= lo <= hi <= 31) set
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  const uint32_t upto_hi = hi >= 31 ? 0xFFFFFFFFu : ((1u << (hi + 1)) - 1u);
  return upto_hi & ~((1u << lo) - 1u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// A pixel's prior maps in one view, packed in one register and loaded a
// row ahead of their use: d_plane clamped to [-R-1, D+R] (a window that
// lay outside [0, D-1] still does) in the low 16 bits, covered in bit 16,
// valid in bit 17.
__device__ __forceinline__ uint32_t load_maps(const ViewMaps& V, size_t pix,
                                              int dp16, int R, int D) {
  const int dp = dp16 ? static_cast<int>(
                            reinterpret_cast<const int16_t*>(V.d_plane)[pix])
                      : reinterpret_cast<const int32_t*>(V.d_plane)[pix];
  return (static_cast<uint32_t>(min(max(dp, -R - 1), D + R)) & 0xFFFFu) |
         (V.covered[pix] ? 1u << 16 : 0u) | (V.valid[pix] ? 1u << 17 : 0u);
}

__device__ __forceinline__ int maps_dp(uint32_t m) {
  return static_cast<int>(static_cast<int16_t>(m & 0xFFFFu));
}

// The keyed minimum of one pixel of one view: the plane window (radius R),
// then the cell's grid candidates outside it, bit by bit. qq is the query
// descriptor, tb[kSign * d] the target at d (any d in [-2R-1, D+2R] lies in
// the staged span), words the pixel's cell's candidate words and wmask the
// cell's non-empty words; lim = dmax + 1, or 0 for a pixel that keys
// nothing.
template <int R, int kSign>
__device__ __forceinline__ int best_key(const uint4 qq, const uint4* tb,
                                        uint32_t m, const uint32_t* words,
                                        uint32_t wmask, int lim,
                                        const PriorTable& P) {
  int best = kBig;
  // a warp with no pixel to key skips the walks (a uniform branch)
  if (!__any_sync(0xFFFFFFFFu, lim > 0)) return best;
  const int dp = maps_dp(m);
  const int prior = (m >> 17) & 1u;
  const int k0 = (kKeyBias * 512 + 256) + dp - R;   // key of sad 0 at j = 0
  const uint4* t0 = tb + kSign * (dp - R);
  // the live steps j (0 <= d = dp - R + j < lim), a bit each
  const int jlo = max(0, R - dp), jhi = min(2 * R, lim - 1 - dp + R);
  const uint32_t live = jlo <= jhi ? bit_range(jlo, jhi) : 0u;
#pragma unroll
  for (int j = 0; j <= 2 * R; ++j) {
    const int kj = prior * (P.p[j > R ? j - R : R - j] * 512) + (k0 + j);
    const int key = sad16(qq, t0[kSign * j]) * 512 + kj;
    if ((live >> j) & 1u) best = min(best, key);
  }
  // the cell's non-empty words below lim, each walked bit by bit
  uint32_t M = wmask & ((1u << ((lim + 31) >> 5)) - 1u);
  while (M) {
    const int w = __ffs(M) - 1;
    M &= M - 1;
    const int d0 = 32 * w;
    uint32_t g = 0u;
    if (d0 < lim) {
      g = words[w];
      if (lim < d0 + 32) g &= bit_range(0, lim - 1 - d0);
      const int lo = max(dp - R, d0), hi = min(dp + R, d0 + 31);
      if (lo <= hi) g &= ~bit_range(lo - d0, hi - d0);
    }
    while (g) {
      const int k = __ffs(g) - 1;
      g &= g - 1;
      const int d = d0 + k;
      best = min(best, sad16(qq, tb[kSign * d]) * 512 + (kKeyBias * 512 + d));
    }
  }
  return best;
}

// The same past radius 7 (R = 0 in the kernel): the window's live d in
// [max(dp - r, 0), min(dp + r, lim - 1)] walked one by one, P[|d - dp|]
// from sP where |d - dp| < ntab (the table's length, min(r + 1, D)) and 0
// past it. dp is the pixel's d_plane as it is; the bounds are taken in 64
// bits, so no radius wraps them.
template <int kSign>
__device__ __forceinline__ int best_key_any(const uint4 qq, const uint4* tb,
                                            uint32_t m, int dp,
                                            const uint32_t* words,
                                            uint32_t wmask, int lim, int r,
                                            const int* sP, int ntab) {
  int best = kBig;
  if (!__any_sync(0xFFFFFFFFu, lim > 0)) return best;
  const int prior = (m >> 17) & 1u;
  const long long lo = max(static_cast<long long>(dp) - r, 0LL);
  const long long hi = static_cast<long long>(dp) + r;
  const int dlo = static_cast<int>(min(lo, static_cast<long long>(kMaxD)));
  const int dhi = static_cast<int>(min(hi, static_cast<long long>(lim - 1)));
  for (int d = dlo; d <= dhi; ++d) {
    const long long k = d > dp ? static_cast<long long>(d) - dp
                               : static_cast<long long>(dp) - d;
    const int pk = k < ntab ? sP[k] : 0;
    best = min(best, sad16(qq, tb[kSign * d]) * 512 +
                         (prior * (pk * 512) + (kKeyBias * 512 + 256 + d)));
  }
  // the window within [0, D - 1], which the grid walk leaves out
  const int wlo = dlo, whi = static_cast<int>(min(hi, static_cast<long long>(kMaxD)));
  uint32_t M = wmask & ((1u << ((lim + 31) >> 5)) - 1u);
  while (M) {
    const int w = __ffs(M) - 1;
    M &= M - 1;
    const int d0 = 32 * w;
    uint32_t g = 0u;
    if (d0 < lim) {
      g = words[w];
      if (lim < d0 + 32) g &= bit_range(0, lim - 1 - d0);
      const int a = max(wlo, d0), b = min(whi, d0 + 31);
      if (a <= b) g &= ~bit_range(a - d0, b - d0);
    }
    while (g) {
      const int k = __ffs(g) - 1;
      g &= g - 1;
      const int d = d0 + k;
      best = min(best, sad16(qq, tb[kSign * d]) * 512 + (kKeyBias * 512 + d));
    }
  }
  return best;
}

// (best % 512) % 256 of a key, which is positive
__device__ __forceinline__ float decode(int best, bool ok) {
  return !ok ? -10.0f : best < kBig ? static_cast<float>(best & 255) : -1.0f;
}

// The strip's cells: the grid cells of row v that columns [c0, c0 + strip)
// fall in, at most this many.
__host__ __device__ __forceinline__ int strip_cells(int strip_p, int gs) {
  return strip_p / gs + 2;
}

__host__ __device__ __forceinline__ int span_of(int strip_p, int D) {
  return strip_p + D - 1 + 2 * kPad;
}

// One buffer of a row's staging, in uint4: span right descriptors, span
// left descriptors, then both views' cells' words.
__host__ __device__ __forceinline__ int buffer_u4(int strip_p, int D, int gs,
                                                  int nw) {
  return 2 * span_of(strip_p, D) + (2 * strip_cells(strip_p, gs) * nw + 3) / 4;
}

struct Shape {
  int views, dp16, B, H, W, D, gh, gw, nw, gs, match_texture, strip,
      nstrips;
  int radius, ntab;   // the plane radius and the length of P (R = 0 only)
  // n / gs as __umulhi(n, ceil(2^32 / gs)): exact for n, gs < 2^16 (the
  // error n * (mul * gs - 2^32) stays < 2^32); 0 stands for gs = 1, whose
  // multiplier 2^32 does not fit
  unsigned gs_mul;
};

__host__ __forceinline__ unsigned div_mul(int d) {
  return d == 1 ? 0u : static_cast<unsigned>(((1ull << 32) + d - 1) / d);
}

__device__ __forceinline__ int div_by(int n, unsigned mul) {
  return mul ? static_cast<int>(__umulhi(static_cast<unsigned>(n), mul)) : n;
}

// A row tuple t: frame b, row v, strip s starting at column c0; its cells
// cell0 .. cell0 + ncell - 1 of grid row v / gs; row = b * H + v.
struct Tuple {
  int b, v, row, c0, cell0, ncell;
};

__device__ __forceinline__ Tuple tuple_of(int t, const Shape& S) {
  Tuple T;
  int s = 0;
  T.row = t;
  if (S.nstrips > 1) {
    T.row = t / S.nstrips;
    s = t - T.row * S.nstrips;
  }
  T.b = T.row / S.H;
  T.v = T.row - T.b * S.H;
  T.c0 = s * S.strip;
  T.cell0 = div_by(T.c0, S.gs_mul);
  T.ncell = div_by(min(T.c0 + S.strip, S.W) - 1, S.gs_mul) - T.cell0 + 1;
  return T;
}

// Issue the cp.async copies of row tuple t (frame b, row v, strip s) into
// buf: the right descriptors of columns c0 - (D-1) - kPad .. (the left
// view's targets and the right view's queries), the left descriptors of
// columns c0 - kPad .. (the right view's targets and the left view's
// queries), each span_of() long, then the strip's cells' candidate words
// of the left and of the right view. Descriptor columns outside the image
// are zero and never keyed.
__device__ __forceinline__ void stage_row(
    uint4* buf, const Tuple& T, int span, const uint8_t* __restrict__ desc1,
    const uint8_t* __restrict__ desc2, const ViewMaps& left,
    const ViewMaps& right, const Shape& S) {
  const int strip_p = blockDim.x;
  const int c0 = T.c0;
  const int vr = min(max(T.v, 2), S.H - 3);
  const size_t row = (static_cast<size_t>(T.b) * S.H + vr) * S.W;
  const uint4* gR = reinterpret_cast<const uint4*>(desc2) + row;
  const uint4* gL = reinterpret_cast<const uint4*>(desc1) + row;
  const int r0 = c0 - (S.D - 1) - kPad;
  for (int i = threadIdx.x; i < span; i += strip_p) {
    const int col = r0 + i;
    if (static_cast<unsigned>(col) < static_cast<unsigned>(S.W))
      cp_async16(buf + i, gR + col);
    else
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < span; i += strip_p) {
    const int col = c0 - kPad + i;
    if (static_cast<unsigned>(col) < static_cast<unsigned>(S.W))
      cp_async16(buf + span + i, gL + col);
    else
      buf[span + i] = make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t* sG = reinterpret_cast<uint32_t*>(buf + 2 * span);
  const size_t cells =
      (static_cast<size_t>(T.b) * S.gh + div_by(T.v, S.gs_mul)) * S.gw +
      T.cell0;
  const int nwords = T.ncell * S.nw;
  for (int i = threadIdx.x; i < 2 * nwords; i += strip_p) {
    const bool is_r = i >= nwords;
    const uint32_t* grid = is_r ? right.grid : left.grid;
    if (S.views & (is_r ? 2 : 1))
      cp_async4(sG + i, grid + cells * S.nw + (is_r ? i - nwords : i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// views: 1 left, 2 right, 3 both. R: the plane radius, or 0 for S.radius
// (past kMaxRadius) with P in Pdev. kLR: the L/R check as the epilogue
// (views 3 and one strip only; sweep bound lr_smax, threshold lr_thr). A
// persistent block walks the row tuples
// (frame, row, strip) t = blockIdx.x, + gridDim.x, ...: it stages tuple
// t + gridDim.x into one buffer and loads its pixel maps into registers
// while it computes tuple t from the other buffer. A thread owns column
// u = c0 + x of the row in every view asked for; blockDim.x = strip_p, the
// strip's width rounded up to 32.
template <int R, bool kLR>
__global__ void __launch_bounds__(kStripMax, 2) elas_dense_kernel(
    const uint8_t* __restrict__ desc1, const uint8_t* __restrict__ desc2,
    ViewMaps left, ViewMaps right, Shape S, PriorTable P,
    const int* __restrict__ Pdev, int lr_smax, float lr_thr) {
  extern __shared__ uint4 smem[];
  const int strip_p = blockDim.x;
  const int span = span_of(strip_p, S.D);
  const int bufsz = buffer_u4(strip_p, S.D, S.gs, S.nw);
  // after the two buffers: each cell's non-empty words, both views; then,
  // for R = 0, the prior table (read after the loop's first barrier); then,
  // for kLR, the decoded row of the left view and of the right view
  uint32_t* sMask = reinterpret_cast<uint32_t*>(smem + 2 * bufsz);
  int* sP = reinterpret_cast<int*>(sMask + 2 * strip_cells(strip_p, S.gs));
  float* sRow = reinterpret_cast<float*>(sP + (R == 0 ? S.ntab : 0));
  if constexpr (R == 0)
    for (int i = threadIdx.x; i < S.ntab; i += strip_p) sP[i] = Pdev[i];
  const int total = S.B * S.H * S.nstrips;
  const int x = threadIdx.x;
  const uint4 k80 = make_uint4(0x80808080u, 0x80808080u, 0x80808080u,
                               0x80808080u);

  int t = blockIdx.x;
  if (t >= total) return;
  // a view's d_plane as it is, for R = 0 (its maps word keeps the flags)
  auto load_dp = [&](const ViewMaps& V, size_t pix) {
    return S.dp16 ? static_cast<int>(
                        reinterpret_cast<const int16_t*>(V.d_plane)[pix])
                  : reinterpret_cast<const int32_t*>(V.d_plane)[pix];
  };
  auto load = [&](const Tuple& T, uint32_t& a, uint32_t& b, int& pa,
                  int& pb) {
    const int u = T.c0 + x;
    a = b = 0u;
    pa = pb = 0;
    if (x < S.strip && u < S.W) {
      const size_t pix = static_cast<size_t>(T.row) * S.W + u;
      if (S.views & 1) a = load_maps(left, pix, S.dp16, R, S.D);
      if (S.views & 2) b = load_maps(right, pix, S.dp16, R, S.D);
      if constexpr (R == 0) {
        if (S.views & 1) pa = load_dp(left, pix);
        if (S.views & 2) pb = load_dp(right, pix);
      }
    }
  };
  int cur = 0;
  Tuple T = tuple_of(t, S);
  stage_row(smem, T, span, desc1, desc2, left, right, S);
  uint32_t ml, mr;
  int pl, pr;
  load(T, ml, mr, pl, pr);
  for (; t < total; t += gridDim.x) {
    const int tn = t + gridDim.x;
    uint32_t nl = 0u, nr = 0u;
    int npl = 0, npr = 0;
    Tuple Tn = T;
    if (tn < total) {
      Tn = tuple_of(tn, S);
      stage_row(smem + (cur ^ 1) * bufsz, Tn, span, desc1, desc2, left,
                right, S);
      load(Tn, nl, nr, npl, npr);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    const uint4* sR = smem + cur * bufsz;
    const uint4* sL = sR + span;
    const uint32_t* sG = reinterpret_cast<const uint32_t*>(sR + 2 * span);
    const int c0 = T.c0;
    const int cell0 = T.cell0;
    const int ncell = T.ncell;
    const int nwords = ncell * S.nw;
    // each cell's non-empty words, a bit a word, a thread a cell
    for (int i = x; i < 2 * ncell; i += strip_p) {
      uint32_t mk = 0u;
      for (int w = 0; w < S.nw; ++w)
        mk |= sG[i * S.nw + w] != 0u ? 1u << w : 0u;
      sMask[i] = mk;
    }
    __syncthreads();

    const int u = c0 + x;
    const bool in_img = x < S.strip && u < S.W;
    const size_t pix = static_cast<size_t>(T.row) * S.W + u;
    const bool u_ok = in_img && u >= kWindow && u < S.W - kWindow;
    const int cell = in_img ? div_by(u, S.gs_mul) - cell0 : 0;
    if (S.views & 1) {   // left: q = left at u, t = right at u - d
      const uint4 qq = sL[x + kPad];
      const bool ok = u_ok && ((ml >> 16) & 1u) &&
                      sad16(qq, k80) >= S.match_texture;
      const int lim = ok ? min(S.D, u - kWindow + 1) : 0;
      int best;
      if constexpr (R > 0)
        best = best_key<R, -1>(qq, sR + x + S.D - 1 + kPad, ml,
                               sG + cell * S.nw, sMask[cell], lim, P);
      else
        best = best_key_any<-1>(qq, sR + x + S.D - 1 + kPad, ml, pl,
                                sG + cell * S.nw, sMask[cell], lim,
                                S.radius, sP, S.ntab);
      if constexpr (kLR)
        sRow[x] = decode(best, ok);
      else if (in_img)
        left.out[pix] = decode(best, ok);
    }
    if (S.views & 2) {   // right: q = right at u, t = left at u + d
      const uint4 qq = sR[x + S.D - 1 + kPad];
      const bool ok = u_ok && ((mr >> 16) & 1u) &&
                      sad16(qq, k80) >= S.match_texture;
      const int lim = ok ? min(S.D, S.W - kWindow - u) : 0;
      int best;
      if constexpr (R > 0)
        best = best_key<R, 1>(qq, sL + x + kPad, mr,
                              sG + nwords + cell * S.nw,
                              sMask[ncell + cell], lim, P);
      else
        best = best_key_any<1>(qq, sL + x + kPad, mr, pr,
                               sG + nwords + cell * S.nw,
                               sMask[ncell + cell], lim, S.radius, sP,
                               S.ntab);
      if constexpr (kLR)
        sRow[strip_p + x] = decode(best, ok);
      else if (in_img)
        right.out[pix] = decode(best, ok);
    }
    __syncthreads();   // the buffer is restaged two tuples on
    if constexpr (kLR) {
      // the L/R check of both views from the rows in sRow (c0 = 0, so
      // u = x). The next tuple writes sRow after the loop's next two
      // barriers, which every thread reaches only after its reads here.
      if (in_img) {
        left.out[pix] = lr_one(sRow, sRow + strip_p, u, S.W, -1, lr_smax,
                               lr_thr, 0);
        right.out[pix] = lr_one(sRow + strip_p, sRow, u, S.W, +1, lr_smax,
                                lr_thr, 0);
      }
    }
    cur ^= 1;
    T = Tn;
    ml = nl;
    mr = nr;
    pl = npl;
    pr = npr;
  }
}

// The launch configuration of elas_dense_kernel<R, kLR> for S: threads a
// block, dynamic shared memory and the blocks that fit an SM.
template <int R, bool kLR>
cudaError_t configure(const Shape& S, int& threads, int& smem, int& per_sm) {
  threads = (S.strip + 31) & ~31;
  smem = 2 * buffer_u4(threads, S.D, S.gs, S.nw) * static_cast<int>(sizeof(uint4)) +
         2 * strip_cells(threads, S.gs) * static_cast<int>(sizeof(uint32_t)) +
         (R == 0 ? S.ntab * static_cast<int>(sizeof(int)) : 0) +
         (kLR ? 2 * threads * static_cast<int>(sizeof(float)) : 0);
  // as many persistent blocks as fit: 3 an SM at 640 columns needs the
  // largest shared memory carveout
  per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      elas_dense_kernel<R, kLR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(elas_dense_kernel<R, kLR>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, elas_dense_kernel<R, kLR>, threads, smem);
  return e;
}

template <int R, bool kLR>
int launch(const uint8_t* desc1, const uint8_t* desc2, ViewMaps left,
           ViewMaps right, const Shape& S, PriorTable P, const int* Pdev,
           int lr_smax, float lr_thr, cudaStream_t stream) {
  int threads = 0, smem = 0, per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = configure<R, kLR>(S, threads, smem, per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long total = 1LL * S.B * S.H * S.nstrips;
  const int blocks = static_cast<int>(
      total < 1LL * per_sm * sms ? total : 1LL * per_sm * sms);
  elas_dense_kernel<R, kLR><<<blocks, threads, smem, stream>>>(
      desc1, desc2, left, right, S, P, Pdev, lr_smax, lr_thr);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, R>) for the instantiation of a plane
// radius: 2 to 7 unrolled, 0 (the radius at run time) past 7. The plane
// radius is at least 2 (elas.cpp:806).
template <typename F>
int with_radius(int radius, F&& f) {
  switch (radius) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

// The shape of a call: the strips a row splits into are the fewest of at
// most kStripMax columns, of equal widths in multiples of 32 (the last may
// be narrower).
Shape shape_of(int views, int dp16, int B, int H, int W, int D, int gh,
               int gw, int nw, int gs, int radius, int match_texture) {
  const int ntab = radius < D - 1 ? radius + 1 : D;
  const int nstrips = (W + kStripMax - 1) / kStripMax;
  const int strip = ((W + nstrips - 1) / nstrips + 31) & ~31;
  return Shape{views, dp16, B, H, W, D, gh, gw, nw, gs, match_texture,
               strip, (W + strip - 1) / strip, radius, ntab, div_mul(gs)};
}

}  // namespace

// P: P[0 .. radius] by value for radius <= kMaxRadius; past it Pdev, an
// int32 table of min(radius + 1, D) entries on the card. lr: 1 to run the
// L/R check (sweep bound lr_smax >= 0, threshold lr_thr) as the epilogue,
// for both views (views 3) of rows of at most kStripMax columns, 0 not.
extern "C" int elas_dense(const uint8_t* desc1, const uint8_t* desc2,
                          ViewMaps left, ViewMaps right, int views, int dp16,
                          int B, int H, int W, int D, int gh, int gw, int nw,
                          int gs, int radius, int match_texture, int lr,
                          int lr_smax, float lr_thr, PriorTable P,
                          const int* Pdev, void* stream) {
  if (views < 1 || views > 3 || B < 1 || H < 5 || W < 5 || H > 65535 ||
      W > 65535 || D < 1 || D > kMaxD || radius < 2 || gs < 1 ||
      gs > 65535 || nw != (D + 31) / 32 ||
      (radius > kMaxRadius && Pdev == nullptr) ||
      1LL * B * H * W >= (1LL << 31) ||
      (lr && (views != 3 || W > kStripMax || lr_smax < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape S = shape_of(views, dp16, B, H, W, D, gh, gw, nw, gs, radius,
                           match_texture);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_radius(radius, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return lr ? launch<R, true>(desc1, desc2, left, right, S, P, Pdev,
                                lr_smax, lr_thr, s)
              : launch<R, false>(desc1, desc2, left, right, S, P, Pdev,
                                 lr_smax, lr_thr, s);
  });
}

// The blocks of the kernel that fit an SM (*per_sm) at a row width W,
// D, cell size gs and plane radius, with the L/R epilogue (lr 1) or
// without it: the occupancy the launcher sizes its persistent grid by.
extern "C" int elas_dense_per_sm(int W, int D, int gs, int radius, int lr,
                                 int* per_sm) {
  if (W < 5 || W > 65535 || D < 1 || D > kMaxD || radius < 2 || gs < 1 ||
      (lr && W > kStripMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape S = shape_of(3, 0, 1, 5, W, D, 1, 1, (D + 31) / 32, gs, radius,
                           0);
  int threads = 0, smem = 0;
  return with_radius(radius, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return static_cast<int>(
        lr ? configure<R, true>(S, threads, smem, *per_sm)
           : configure<R, false>(S, threads, smem, *per_sm));
  });
}

// Block matching (SAD over a box window, both views' WTA, L/R check) in one
// pass that keeps the cost volume out of device memory.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/bm_kernel.py
// (_bm_band_kernel l.107, pallas_call in bm_match_pallas l.225). The plain
// PyTorch version of the same function is bm_match_fused_plain in
// jackal_tpu_torch/ops/bm_kernel.py (matching/bm.bm_views and the L/R
// check); the wrapper is ops/bm_kernel.bm_match_fused. It computes what
// matching/bm.bm_match computes before its texture gate, bit for bit, at
// every D and every odd window up to 2901: the invalid cost is 1 << 24 (the
// Pallas kernel lowers it at D > 64 to keep its int32 keys, and so differs
// from bm_match there). Where the strip takes the shape, its entry
// bm_match_gated (wrapper ops/bm_kernel.bm_match_gated, plain version
// bm_match_gated_plain) also applies the texture gate and writes the
// node's u8 map: the work of kernel S (csrc/bm_gate_kernel.cu, the
// reference's jackal_tpu/matching/bm.py:113 bm_texture_gate and the u8 map
// of jackal_tpu/pipeline/frame_pipeline.py:170), which runs in the same
// jitted program as the Pallas BM there.
//
// What it computes. L, R are uint8 [B, H, W]. For each d < D the cost is
// the (2r+1)^2 box sum of AD(v, x) = |L(v, x) - R(v, x - d)|, where rows
// and columns outside the frame give 0 and R(v, x - d) reads 0 for x < d;
// cost_L(u, d) is 1 << 24 where u < d, and the right view's cost_R(u, d) =
// cost_L(u + d, d), 1 << 24 where u + d >= W. Each view: best_d is the
// first d at the least cost; "second" the least cost outside best_d +- 1;
// unique = f32(best) < f32(uniqueness) * f32(second), the product rounded
// to f32; the parabola offs = f32(cm - cp) / (2 * f32(cm + cp - 2 best))
// (IEEE division) where 0 < best_d < D - 1 and the denominator is > 0,
// with cm, cp the costs at best_d -+ 1 (1 << 24 where those disparities
// are invalid); disparity best_d + offs, -1 where not unique. Then the L/R
// check of the left view: uw = clip(trunc(f32(u) - dL), 0, W - 1), s =
// clip(u - uw, 0, D), keep dL where dL >= 0, dR(u - s) >= 0 and
// |dR(u - s) - dL| <= lr_threshold. dl, dr are float32 [B, H, W]. The
// texture gate (bm_match_gated): the texture of a pixel is the (2r+1)^2 box
// sum, zero outside the frame, of g(y, x) = |L(y, x+1) - L(y, x-1)| on the
// edge-replicated frame; dl is -1 where it is below thr (texture_threshold
// * window, int32), and the u8 map is clamp(rint(dl), 0, 255), rint half to
// even. The gate and the L/R check only write -1 and the check does not
// read dl's neighbours, so gating before the check equals the reference's
// order (gate, then check).
//
// What bounds it on an H100. Per (pixel, disparity) no design can do less
// than the cost's two running box sums (the absolute difference fused with
// the vertical add, the vertical subtract, the horizontal add and
// subtract: 4 operations, on 16-bit lanes at best two a 32-bit
// instruction, the absolute difference four: 1.75 instructions) and, in
// each view, two minima (the best (cost, d) and the least cost outside
// best_d +- 1: 2 instructions): 5.75 instructions, 1.13e8 for a 640x480
// frame at D = 64, 0.0068 ms at the card's 64 instructions a clock an SM
// (chip_smoke.bm_work); its bytes (two u8 images in, two f32 maps out, 10
// a pixel) take 0.0009 ms. So the integer operations bound it. The gated
// entry adds the texture's box, 4 operations a pixel counted as
// instructions (as the cost's, once a pixel and not a d), and the u8 map's
// byte a pixel.
//
// The design: a block owns a strip of kSW output columns of one frame (64,
// or 32 where a batch is too small to fill the card with 64) and a chunk
// of RH rows, and walks down them. Per row it needs cost_L(u, d) (the left
// view) and cost_L(u + d, d) (the right view) for its kSW columns u: two
// segments a disparity of kSW + 2r columns each, seg 0 at x = u - r ..
// u + r and seg 1 shifted by d, so that both views have the same shape.
//  - Vertical box: per (segment, d, column) the running vertical sum V of
//    the AD in shared memory, updated a row at a time from a ring of the
//    last 2r + 3 rows of L and R (each row is read from device memory once
//    a block, a step ahead). Four columns at a time: the absolute
//    differences by one __vabsdiffu4, V as 16-bit pairs (a sum is at most
//    255 * 255) by __vsub2 (the row that leaves) and __vadd2 (the new
//    one). The walk starts 2r rows above the chunk, with zero rows before
//    the first.
//  - Horizontal box: the same thread (one a segment and d) runs along its
//    segment's columns right after each V update, one add and one
//    subtract a column, and writes the row's cost C[segment][u][d].
//  - Texture: segment 1 at d = 0 would repeat segment 0 at d = 0
//    (cost_R(u, 0) = cost_L(u, 0)), so that thread runs the same loop over
//    g instead, four columns by one __vabsdiffu4 of the ring's L at x + 1
//    and x - 1 (the ring's L starts a column left of the window for x - 1
//    and holds L(0) at x = -1 and L(W - 1) at x = W, the frame's edges
//    replicated, where the costs' mask drops them), and writes the texture
//    into C's pad column; after the walk, segment 0's first warp copies
//    its d = 0 costs into segment 1's row for the right view's WTA. A
//    vertical texture sum is at most 255 * (2r + 1), in 16 bits at
//    r <= 127. Both entries run it: the ungated one passes thr = INT_MIN,
//    which gates nothing. The lane adds no thread and leaves the walk's
//    loop and the WTA as they were: on an H100, designs that corrected the
//    edge columns' sums before each walk, or had the WTA read d = 0 from
//    segment 0, made G slower (PERF.md, Findings).
//  - WTA: after a barrier every d of the row is at hand, so each pixel
//    finishes within its row: Q threads a (pixel, view) take every Q-th
//    valid d (and the first four invalid ones: the others cannot be among
//    the least), keep the four least packed keys (cost << 8) | d, merge
//    them by shuffles, read cm, cp from C and finish as before. No WTA
//    state outlives a row; two barriers a row, none a disparity.
// A second kernel, lr_check_kernel, applies the L/R check: it reads
// dR(u - s), up to D columns left of the strip, and writes the u8 map
// where the caller asks for it. Costs computed a row: 2
// (kSW + 2r) per d against the W that a full-width row would need (the
// right view's shifted segment is the price of the strip).
//
// Where the strip does not serve, the launcher takes a second, simple path
// that uses no shared memory: at D > 256 (the strip's shared memory grows
// with D, and d no longer fits a key's 8 bits), at a window past 255 (r >
// 127: a vertical sum passes its 16-bit lane, a cost the key's 24 bits) and
// wherever the strip's shared memory passes a block's 227 KB (a window past
// 225 at D = 64, 155 at D = 128, 73 at D = 256). Three kernels a frame
// through a scratch of two int32 [H, W, D] volumes (d innermost) that the
// wrapper allocates: bm_vsum_kernel, a thread a (column, d) walking down
// the rows with the running vertical box sum of the AD; bm_hsum_kernel, a
// thread a (row, d) walking along the row with the running horizontal sum,
// the full box cost; bm_wta_wide_kernel, a warp a (pixel, view) with the
// lanes striding d, the best (cost, d) as one 64-bit key (cost << 32 | d:
// the first d wins ties) and the least cost outside best_d +- 1 by warp
// minima. Then lr_check_kernel as above. Its keys carry the int32 cost
// itself, so past r = 127, where a real cost can pass 1 << 24, the path
// compares it with the invalid cost as bm_match does: an invalid d beats
// it, cm and cp are min(cost, 1 << 24) and the parabola's denominator
// wraps in int32 as bm_match's does. It takes r <= 1450, the largest r at
// which bm_match's own int32 box sums, at most (2r + 1)^2 * 255, do not
// wrap. Shapes the strip takes launch the strip kernel as before. That
// path has no texture gate: bm_match_gated refuses its shapes, and the
// wrapper routes them, by shape and before any launch, to bm_match then
// kernel S.
//
// Built with -DBM_KERNEL_DIAG, the library also exports bm_match_diag, a
// per-part timing of this kernel (the port of tools/diag_bm_kernel.py
// diag_kernel, pallas_call l.105): the same kernel with a compile-time mode
// that gates its parts (see bm_match_diag); the texture runs wherever the
// box runs (every mode but "nobox"), ungated. The production library
// compiles only the full mode.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 24;                    // bm_match's invalid cost
constexpr uint32_t kKeyCostMax = (1u << 24) - 1; // kBig's cost in a key
constexpr int kWide = 64, kNarrow = 32;         // output columns a block
constexpr int kSmemMax = 232448;                 // a block's shared memory
constexpr int kStripRMax = 127;   // the strip's vertical sums fit 16 bits
constexpr int kBoxRMax = 1450;    // (2r + 1)^2 * 255 < 2^31
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kFullMode = 0, kOneWta = 1, kBoxOnly = 2, kNoBox = 3 };

struct Plan {
  int dpad, threads, q;  // padded D, threads, WTA threads a (pixel, view)
  int vp, cp, nw;        // pitches: V (uint16), C (int32), a ring row
  int smem;
};

__host__ __device__ inline Plan plan(int D, int r, int kSW) {
  Plan p;
  p.dpad = (D + 31) / 32 * 32;
  // a box thread a (segment, d); at least a WTA thread a (pixel, view)
  p.threads = 2 * p.dpad > 2 * kSW ? 2 * p.dpad : 2 * kSW;
  p.q = 1;  // a power of 2, for the shuffles that merge their keys
  while (2 * p.q * 2 * kSW <= p.threads) p.q *= 2;
  // V rows hold the box columns rounded up to groups of 4, at an odd
  // word pitch (no bank conflicts between the d of a warp)
  p.vp = (kSW + 2 * r + 3) / 4 * 4 + 2;
  p.cp = p.dpad + 1;
  // a ring row: L then R, each with 8 bytes of slack for the word loads
  p.nw = (kSW + D - 1 + 2 * r + 8 + 3) / 4 * 4;
  p.smem = 4 * 2 * kSW * p.cp + 2 * 2 * p.dpad * p.vp +
           (2 * r + 3) * 2 * p.nw;
  return p;
}

__device__ __forceinline__ int key_cost(uint32_t key) {
  const int c = static_cast<int>(key >> 8);
  return c == static_cast<int>(kKeyCostMax) ? kBig : c;
}

// The key of a valid cost (below 2^24 - 1 at r <= 127) and of an invalid
// one.
__device__ __forceinline__ uint32_t valid_key(int cost, int d) {
  return static_cast<uint32_t>(cost) * 256u + static_cast<uint32_t>(d);
}
__device__ __forceinline__ uint32_t invalid_key(int d) {
  return (kKeyCostMax << 8) | static_cast<uint32_t>(d);
}

// Four bytes of a shared-memory row from byte i on: two aligned words and
// a funnel shift (i need not be a multiple of 4)
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int i) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (i >> 2);
  return __funnelshift_r(w[0], w[1], 8 * (i & 3));
}

// The four least keys, ascending.
struct Top4 {
  uint32_t k0, k1, k2, k3;

  __device__ __forceinline__ void insert(uint32_t k) {
    uint32_t lo = min(k, k0);
    k = max(k, k0);
    k0 = lo;
    lo = min(k, k1);
    k = max(k, k1);
    k1 = lo;
    lo = min(k, k2);
    k = max(k, k2);
    k2 = lo;
    k3 = min(k, k3);
  }
};

// Disparity of one pixel of one view from its best d and cost, its least
// cost outside best_d +- 1 and its costs at best_d -+ 1 (kBig where
// invalid).
__device__ __forceinline__ float disparity(int bd, int bc, int second,
                                           int cm, int cp, int D,
                                           float uniq) {
  const bool unique =
      static_cast<float>(bc) < __fmul_rn(uniq, static_cast<float>(second));
  // in int32 with wrap-around, as bm_match: 2 * bc passes 2^31 past r = 1023
  const int den = static_cast<int>(static_cast<unsigned>(cm) +
                                   static_cast<unsigned>(cp) -
                                   2u * static_cast<unsigned>(bc));
  const float offs =
      (bd > 0 && bd < D - 1 && den > 0)
          ? __fdiv_rn(static_cast<float>(cm - cp),
                      __fmul_rn(2.0f, static_cast<float>(den)))
          : 0.0f;
  return unique ? __fadd_rn(static_cast<float>(bd), offs) : -1.0f;
}

// The same from a pixel's four least keys.
__device__ __forceinline__ float finish(const Top4& t, int cm, int cp, int D,
                                        float uniq) {
  const int bd = static_cast<int>(t.k0 & 255u);
  // at most two of k1..k3 lie at best_d +- 1, so the first that does not
  // is the least cost outside them
  const int second =
      abs(static_cast<int>(t.k1 & 255u) - bd) > 1   ? key_cost(t.k1)
      : abs(static_cast<int>(t.k2 & 255u) - bd) > 1 ? key_cost(t.k2)
                                                    : key_cost(t.k3);
  return disparity(bd, key_cost(t.k0), second, cm, cp, D, uniq);
}

template <int kSW, int MODE>
__global__ void __launch_bounds__(512)
    bm_strip_kernel(const uint8_t* __restrict__ L, const uint8_t* __restrict__ R,
                    float* __restrict__ dl_out, float* __restrict__ dr_out,
                    int H, int W, int D, int r, int RH, float uniq,
                    int thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan p = plan(D, r, kSW);
  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * kSW, v0 = blockIdx.y * RH;
  const size_t frame = static_cast<size_t>(blockIdx.z) * H * W;
  // 2r + 2 rows in the box's walk and the next row, loaded during a step
  const int win = 2 * r + 1, nring = 2 * r + 3;
  int* C = reinterpret_cast<int*>(smem);                       // [2][kSW][cp]
  uint16_t* V = reinterpret_cast<uint16_t*>(C + 2 * kSW * p.cp);  // [2][dpad][vp]
  uint8_t* ring = reinterpret_cast<uint8_t*>(V + 2 * p.dpad * p.vp);
  // ring[slot][0] holds L at x = u0 - r - 1 + k, ring[slot][1] R at
  // x = u0 - r - (D - 1) + k, k < nw (0 outside the frame, but L at x = -1
  // and W the frame's edge columns, for the texture's g)
  const int loL = u0 - r - 1, loR = u0 - r - (D - 1);
  auto fetch = [&](int y, int k) -> uint8_t {
    const int side = k >= p.nw;
    int x = (side ? loR : loL) + k - side * p.nw;
    if (!side) x = x == -1 ? 0 : x == W ? W - 1 : x;
    if (y < 0 || y >= H || x < 0 || x >= W) return 0;
    return (side ? R : L)[frame + static_cast<size_t>(y) * W + x];
  };

  // this thread's (segment, d) in the box phase; segment 1's d = 0 sums
  // the texture (its costs are segment 0's at d = 0)
  const int seg = tid / p.dpad, d = tid % p.dpad;
  const bool texer = seg == 1 && d == 0 && MODE != kNoBox;
  const bool boxer =
      seg < 2 && d < D && (MODE != kOneWta || seg == 0 || texer);
  uint16_t* Vs = V + (seg * p.dpad + d) * p.vp;
  uint32_t* Vw = reinterpret_cast<uint32_t*>(Vs);  // pairs of columns
  // the texture of output column i goes to C[1][i][dpad], the pad column
  int* Cs = C + seg * kSW * p.cp + (texer ? p.dpad : d);
  const int ncol = kSW + 2 * r;
  // per column j: seg 0 reads L[1 + j], R[j - d + D - 1] and
  // x = u0 - r + j; seg 1 reads L[1 + d + j], R[j + D - 1] and
  // x = u0 + d - r + j; the texture L[j + 2] and L[j] (x + 1 and x - 1) at
  // x = u0 - r + j
  const int lofs = texer ? 2 : 1 + (seg == 0 ? 0 : d);
  const int rofs = texer ? 0 : p.nw + (seg == 0 ? D - 1 - d : D - 1);
  const int xofs = u0 - r + (seg == 0 ? 0 : d);

  const int rows = min(RH, H - v0);
  const int warm = MODE == kNoBox ? 0 : 2 * r;
  const int ylead = MODE == kNoBox ? 0 : r;  // the new row: v + ylead
  for (int i = tid; i < 2 * p.dpad * p.vp; i += blockDim.x) V[i] = 0;
  for (int i = tid; i < nring * 2 * p.nw; i += blockDim.x)
    ring[i] = i < 2 * p.nw ? fetch(v0 - warm + ylead, i) : 0;

  // the WTA phase: Q threads a (pixel, view)
  const int pr = tid / p.q, q = tid % p.q;
  const bool wta = pr < 2 * kSW;
  const int wseg = pr / kSW, wi = pr % kSW, wu = u0 + wi;

  constexpr int kPre = 4;  // bytes of the next row a thread holds
  for (int step = -warm; step < rows; ++step) {
    const int ynext = v0 + step + ylead + 1;
    const uint8_t* nrow = ring + ((step + warm) % nring) * 2 * p.nw;
    uint8_t* next = ring + ((step + warm + 1) % nring) * 2 * p.nw;
    // this step's row is in; the last step's reads of C are done. The
    // next row's slot was last read a step ago.
    __syncthreads();
    uint8_t pre[kPre];
#pragma unroll
    for (int n = 0; n < kPre; ++n) {
      const int k = tid + n * blockDim.x;
      pre[n] = k < 2 * p.nw ? fetch(ynext, k) : 0;
    }
    const bool emit = step >= 0;
    if (boxer && MODE == kNoBox) {
      // the centre row's AD as the cost, no box
      for (int i = 0; i < kSW; ++i) {
        const int j = i + r;
        const int x = xofs + j;
        Cs[i * p.cp] = static_cast<unsigned>(x) < static_cast<unsigned>(W)
                           ? abs(static_cast<int>(nrow[lofs + j]) -
                                 static_cast<int>(nrow[rofs + j]))
                           : 0;
      }
    } else if (boxer) {
      // the row that leaves the box: 2r + 1 rows above the new one
      const uint8_t* orow =
          ring + ((step + warm + nring - win) % nring) * 2 * p.nw;
      int c = 0;
      // four columns at a time: their absolute differences four to an
      // instruction, the vertical sums two (16-bit lanes: a sum is at most
      // 255 * 255, and the row that leaves is taken away first)
      for (int j = 0; j < ncol; j += 4) {
        uint32_t an = __vabsdiffu4(load4(nrow, lofs + j), load4(nrow, rofs + j));
        uint32_t ao = __vabsdiffu4(load4(orow, lofs + j), load4(orow, rofs + j));
        const int x = xofs + j;
        if (x < 0 || x + 3 >= W) {  // columns outside the frame add 0
          uint32_t m = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (static_cast<unsigned>(x + k) < static_cast<unsigned>(W))
              m |= 0xffu << (8 * k);
          an &= m;
          ao &= m;
        }
        const uint32_t w0 = __vadd2(__vsub2(Vw[j / 2], __byte_perm(ao, 0, 0x4140)),
                                    __byte_perm(an, 0, 0x4140));
        const uint32_t w1 = __vadd2(__vsub2(Vw[j / 2 + 1], __byte_perm(ao, 0, 0x4342)),
                                    __byte_perm(an, 0, 0x4342));
        Vw[j / 2] = w0;
        Vw[j / 2 + 1] = w1;
        if (emit) {
          const int vk[4] = {static_cast<int>(w0 & 0xffffu),
                             static_cast<int>(w0 >> 16),
                             static_cast<int>(w1 & 0xffffu),
                             static_cast<int>(w1 >> 16)};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int jj = j + k;
            c += vk[k];
            if (jj >= win) c -= Vs[jj - win];
            if (jj >= 2 * r && jj < ncol) Cs[(jj - 2 * r) * p.cp] = c;
          }
        }
      }
    }
    // the right view's d = 0: segment 0's (seg 1's d = 0 summed the texture)
    if (MODE != kNoBox && tid < 32 && emit) {
      __syncwarp();
      for (int i = tid; i < kSW; i += 32) C[(kSW + i) * p.cp] = C[i * p.cp];
    }
    // the next row into its slot, read from the next step on
#pragma unroll
    for (int n = 0; n < kPre; ++n) {
      const int k = tid + n * blockDim.x;
      if (k < 2 * p.nw) next[k] = pre[n];
    }
    for (int k = tid + kPre * blockDim.x; k < 2 * p.nw; k += blockDim.x)
      next[k] = fetch(ynext, k);
    if (!emit) continue;
    __syncthreads();
    if (!wta) continue;
    const int v = v0 + step;
    const int* Cp = C + (wseg * kSW + wi) * p.cp;
    if (MODE == kBoxOnly) {
      int s = 0;
      for (int dd = q; dd < D; dd += p.q) s += Cp[dd];
      for (int o = p.q / 2; o > 0; o /= 2) s += __shfl_xor_sync(kFull, s, o);
      if (q == 0 && wu < W) {
        const size_t o = frame + static_cast<size_t>(v) * W + wu;
        (wseg == 0 ? dl_out : dr_out)[o] = static_cast<float>(s);
      }
      continue;
    }
    if (MODE == kOneWta && wseg == 1) continue;  // whole warps
    // the valid d of the pixel are d < nv: d <= u in the left view,
    // u + d < W in the right one. Of the invalid keys, all at the invalid
    // cost, only the first four can be among the four least.
    const int nv = max(0, min(D, wseg == 0 ? wu + 1 : W - wu));
    Top4 t{0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};
#pragma unroll 4
    for (int dd = q; dd < nv; dd += p.q) t.insert(valid_key(Cp[dd], dd));
    for (int dd = nv + q; dd < min(nv + 4, D); dd += p.q)
      t.insert(invalid_key(dd));
    for (int o = p.q / 2; o > 0; o /= 2) {
      const uint32_t a = __shfl_xor_sync(kFull, t.k0, o);
      const uint32_t b = __shfl_xor_sync(kFull, t.k1, o);
      const uint32_t c = __shfl_xor_sync(kFull, t.k2, o);
      const uint32_t e = __shfl_xor_sync(kFull, t.k3, o);
      t.insert(a);
      t.insert(b);
      t.insert(c);
      t.insert(e);
    }
    if (q != 0 || wu >= W) continue;
    // the view's cost at (wu, dd): kBig where the pair is invalid
    auto cost = [&](int dd) { return dd < nv ? Cp[dd] : kBig; };
    const int bd = static_cast<int>(t.k0 & 255u);
    const int cm = bd > 0 ? cost(bd - 1) : kBig;
    const int cp = bd < D - 1 ? cost(bd + 1) : kBig;
    float disp = finish(t, cm, cp, D, uniq);
    // the texture gate of the left view
    if (wseg == 0 && MODE != kNoBox && C[(kSW + wi) * p.cp + p.dpad] < thr)
      disp = -1.0f;
    const size_t o = frame + static_cast<size_t>(v) * W + wu;
    if (wseg == 0) {
      dl_out[o] = disp;
      if (MODE == kOneWta) dr_out[o] = disp;
    } else {
      dr_out[o] = disp;
    }
  }
}

// ---- the path without shared memory (D > 256, or past the strip) ---------

// V[v, x, d] = the sum over rows v - r .. v + r of AD(y, x, d) = |L(y, x) -
// R(y, x - d)| (R reads 0 for x < d, rows outside the frame add 0): a
// thread a (x, d), d fastest, walking down the rows.
__global__ void __launch_bounds__(256)
    bm_vsum_kernel(const uint8_t* __restrict__ L,
                   const uint8_t* __restrict__ R, int* __restrict__ V, int H,
                   int W, int D, int r) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= static_cast<long long>(W) * D) return;
  const int x = static_cast<int>(e / D), d = static_cast<int>(e % D);
  auto ad = [&](int y) {
    const int rv = x >= d ? R[static_cast<size_t>(y) * W + x - d] : 0;
    return abs(static_cast<int>(L[static_cast<size_t>(y) * W + x]) - rv);
  };
  int sum = 0;
  for (int y = 0; y < min(r, H); ++y) sum += ad(y);
  for (int v = 0; v < H; ++v) {
    if (v + r < H) sum += ad(v + r);
    if (v - r - 1 >= 0) sum -= ad(v - r - 1);
    V[(static_cast<size_t>(v) * W + x) * D + d] = sum;
  }
}

// C[v, u, d] = the sum over columns u - r .. u + r inside the frame of
// V[v, x, d]: a thread a (v, d), d fastest, walking along the row.
__global__ void __launch_bounds__(256)
    bm_hsum_kernel(const int* __restrict__ V, int* __restrict__ C, int H,
                   int W, int D, int r) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= static_cast<long long>(H) * D) return;
  const int v = static_cast<int>(e / D), d = static_cast<int>(e % D);
  const int* src = V + static_cast<size_t>(v) * W * D + d;
  int* dst = C + static_cast<size_t>(v) * W * D + d;
  int sum = 0;
  for (int x = 0; x < min(r, W); ++x) sum += src[static_cast<size_t>(x) * D];
  for (int u = 0; u < W; ++u) {
    if (u + r < W) sum += src[static_cast<size_t>(u + r) * D];
    if (u - r - 1 >= 0) sum -= src[static_cast<size_t>(u - r - 1) * D];
    dst[static_cast<size_t>(u) * D] = sum;
  }
}

// Both views' WTA from the costs C of one frame: a warp a (pixel, view).
// The left view's cost at (u, d) is C[v, u, d], kBig where d > u; the
// right view's C[v, u + d, d], kBig where u + d >= W. A real cost may pass
// kBig (r > 127); it enters the keys and minima as it is.
__global__ void __launch_bounds__(256)
    bm_wta_wide_kernel(const int* __restrict__ C, float* __restrict__ dl,
                       float* __restrict__ dr, int H, int W, int D,
                       float uniq) {
  const long long warp = (blockIdx.x * 256LL + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 2LL * H * W) return;  // the whole warp leaves
  const int view = static_cast<int>(warp % 2);
  const long long px = warp / 2;
  const int u = static_cast<int>(px % W), v = static_cast<int>(px / W);
  const int nv = view == 0 ? min(D, u + 1) : min(D, W - u);  // valid d < nv
  const int* row = C + static_cast<size_t>(v) * W * D;
  auto cost = [&](int d) {
    return d < nv ? row[static_cast<size_t>(u + (view ? d : 0)) * D + d]
                  : kBig;
  };
  unsigned long long key = ~0ull;
  for (int d = lane; d < D; d += 32)
    key = min(key, static_cast<unsigned long long>(cost(d)) << 32 |
                       static_cast<unsigned>(d));
  for (int o = 16; o > 0; o /= 2)
    key = min(key, __shfl_xor_sync(kFull, key, o));
  const int bd = static_cast<int>(key & 0xffffffffu);
  int second = kBig;
  for (int d = lane; d < D; d += 32)
    if (abs(d - bd) > 1) second = min(second, cost(d));
  second = __reduce_min_sync(kFull, second);
  if (lane != 0) return;
  // bm_match's cm, cp: the least of the cost at best_d -+ 1 and 1 << 24
  const float disp = disparity(bd, static_cast<int>(key >> 32), second,
                               bd > 0 ? min(cost(bd - 1), kBig) : kBig,
                               bd < D - 1 ? min(cost(bd + 1), kBig) : kBig,
                               D, uniq);
  (view == 0 ? dl : dr)[px] = disp;
}

// The L/R check of the left view, in place: dl holds the left view's WTA;
// u8 (where not null) gets the checked map's clamp(rint(d), 0, 255).
__global__ void lr_check_kernel(float* __restrict__ dl,
                                const float* __restrict__ dr,
                                uint8_t* __restrict__ u8, int H, int W,
                                int D, float lr_threshold, long long n) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (e >= n) return;
  const int u = static_cast<int>(e % W);
  const long long row = e - u;
  const float d = dl[e];
  const int uw =
      min(max(static_cast<int>(__fsub_rn(static_cast<float>(u), d)), 0),
          W - 1);
  const int idx = u - min(max(u - uw, 0), D);
  const float other = (idx >= 0 && idx < W) ? dr[row + idx] : -1e9f;
  const bool ok =
      d >= 0.0f && other >= 0.0f && fabsf(__fsub_rn(other, d)) <= lr_threshold;
  const float out = ok ? d : -1.0f;
  dl[e] = out;
  if (u8 != nullptr)
    u8[e] = static_cast<uint8_t>(
        static_cast<int>(fminf(fmaxf(rintf(out), 0.0f), 255.0f)));
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int kSW, int MODE>
cudaError_t launch_sw(const uint8_t* L, const uint8_t* R, float* dl, float* dr,
                      int B, int H, int W, int D, int r, int RH, float uniq,
                      int thr, const Plan& p, cudaStream_t s) {
  auto kern = bm_strip_kernel<kSW, MODE>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kSW - 1) / kSW, (H + RH - 1) / RH, B);
  kern<<<grid, p.threads, p.smem, s>>>(L, R, dl, dr, H, W, D, r, RH, uniq,
                                       thr);
  return cudaGetLastError();
}

// Blocks a grid of strips kSW wide and chunks of RH rows has, and blocks
// the card holds at once at this plan
long long blocks(int B, int H, int W, int kSW, int RH) {
  return static_cast<long long>(B) * ((W + kSW - 1) / kSW) * ((H + RH - 1) / RH);
}
long long resident(const Plan& p) {
  return static_cast<long long>(sm_count()) *
         max(1, min(2048 / p.threads, kSmemMax / p.smem));
}

// The strip width and the rows a block that the launch at this shape takes.
// Strips of 64 columns where chunks of 64 rows of them give the card two
// rounds of blocks (less halo a column: config 5's and bench_bm256's
// batches), else of 32 (twice the blocks, half the walk a block: a frame
// at a time); only 32 if ``narrow_only``. Rows a block: the most (64 to 16)
// that still gives two rounds (a block also walks 2r rows above its chunk).
// sw = 0 for a shape the strip does not take.
struct Choice {
  int sw, RH;
};
Choice choose(int B, int H, int W, int D, int r, bool narrow_only) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 2 || D > 256 || r < 0 ||
      r > kStripRMax)
    return {0, 0};
  const Plan wide = plan(D, r, kWide), narrow = plan(D, r, kNarrow);
  if (narrow.smem > kSmemMax) return {0, 0};
  const bool use_wide = !narrow_only && wide.smem <= kSmemMax &&
                        blocks(B, H, W, kWide, 64) >= 2 * resident(wide);
  const Plan& p = use_wide ? wide : narrow;
  const int sw = use_wide ? kWide : kNarrow;
  int RH = 64;
  while (RH > 16 && blocks(B, H, W, sw, RH) < 2 * resident(p)) RH /= 2;
  if ((H + RH - 1) / RH > 65535) return {0, 0};
  return {sw, RH};
}

// The path without shared memory over the frames, one after another
// through ``scratch`` (two int32 [H, W, D] volumes).
cudaError_t launch_wide(const uint8_t* L, const uint8_t* R, float* dl,
                        float* dr, int* scratch, int B, int H, int W, int D,
                        int r, float uniq, cudaStream_t s) {
  if (scratch == nullptr || B < 1 || H < 1 || W < 1 || D < 2 || r < 0 ||
      r > kBoxRMax)
    return cudaErrorInvalidValue;
  const size_t frame = static_cast<size_t>(H) * W;
  int* V = scratch;
  int* C = scratch + frame * D;
  const long long nv = static_cast<long long>(W) * D,
                  nh = static_cast<long long>(H) * D,
                  nw = 64LL * H * W;  // 32 lanes a (pixel, view)
  for (int b = 0; b < B; ++b) {
    bm_vsum_kernel<<<static_cast<unsigned>((nv + 255) / 256), 256, 0, s>>>(
        L + b * frame, R + b * frame, V, H, W, D, r);
    bm_hsum_kernel<<<static_cast<unsigned>((nh + 255) / 256), 256, 0, s>>>(
        V, C, H, W, D, r);
    bm_wta_wide_kernel<<<static_cast<unsigned>((nw + 255) / 256), 256, 0,
                         s>>>(C, dl + b * frame, dr + b * frame, H, W, D,
                              uniq);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Where the strip does not take the shape, box_path = true launches the
// path without shared memory (bm_match); G' and the gated entry
// (box_path = false) refuse it. The strip keeps dl where the texture is at
// least thr (INT_MIN: everywhere); u8 (where not null) gets the u8 map.
template <int MODE>
cudaError_t launch(const uint8_t* L, const uint8_t* R, float* dl, float* dr,
                   uint8_t* u8, int* scratch, int B, int H, int W, int D,
                   int r, float lr_threshold, float uniq, int thr,
                   bool narrow_only, bool box_path, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Choice c = choose(B, H, W, D, r, narrow_only);
  cudaError_t e;
  if (c.sw == 0) {
    if (MODE != kFullMode || !box_path) return cudaErrorInvalidValue;
    e = launch_wide(L, R, dl, dr, scratch, B, H, W, D, r, uniq, s);
  } else {
    e = c.sw == kWide
            ? launch_sw<kWide, MODE>(L, R, dl, dr, B, H, W, D, r, c.RH,
                                     uniq, thr, plan(D, r, kWide), s)
            : launch_sw<kNarrow, MODE>(L, R, dl, dr, B, H, W, D, r, c.RH,
                                       uniq, thr, plan(D, r, kNarrow), s);
  }
  if (e != cudaSuccess || MODE != kFullMode) return e;
  const long long n = static_cast<long long>(B) * H * W;
  lr_check_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      dl, dr, u8, H, W, D, lr_threshold, n);
  return cudaGetLastError();
}

}  // namespace

// The strip width (64 or 32 columns) that bm_match takes at this shape, 0
// where it takes the path without shared memory: lets a test see which
// instantiation it held, and G' refuses a shape at which this is 0.
extern "C" int bm_strip_width(int B, int H, int W, int D, int r) {
  return choose(B, H, W, D, r, false).sw;
}

// Shared bytes a block of bm_match's launch at this shape takes: the
// strip's, or 0 on the path without shared memory.
extern "C" int bm_smem_bytes(int B, int H, int W, int D, int r) {
  const int sw = choose(B, H, W, D, r, false).sw;
  return sw == 0 ? 0 : plan(D, r, sw).smem;
}

// The scratch bytes bm_match needs at this shape: two int32 [H, W, D]
// volumes on the path without shared memory, else 0.
extern "C" long long bm_scratch_bytes(int B, int H, int W, int D, int r) {
  return choose(B, H, W, D, r, false).sw == 0
             ? 2LL * H * W * D * static_cast<long long>(sizeof(int))
             : 0;
}

// scratch: bm_scratch_bytes(B, H, W, D, r) bytes (null where that is 0).
// The strip is the gated entry's, with thr = INT_MIN: it gates nothing.
extern "C" int bm_match(const uint8_t* L, const uint8_t* R, float* dl,
                        float* dr, int B, int H, int W, int D, int r,
                        float lr_threshold, float uniq, int* scratch,
                        void* stream) {
  return static_cast<int>(launch<kFullMode>(
      L, R, dl, dr, nullptr, scratch, B, H, W, D, r, lr_threshold, uniq,
      INT_MIN, false, true, stream));
}

// bm_match with kernel S's work folded in, two launches: dl gated by the
// texture (kept where it is at least thr = texture_threshold * window) and
// checked, dr, and u8 the u8 map of dl. Only the strip's shapes
// (bm_strip_width > 0); others return cudaErrorInvalidValue unlaunched.
extern "C" int bm_match_gated(const uint8_t* L, const uint8_t* R, float* dl,
                              float* dr, uint8_t* u8, int B, int H, int W,
                              int D, int r, float lr_threshold, float uniq,
                              int thr, void* stream) {
  if (u8 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<kFullMode>(
      L, R, dl, dr, u8, nullptr, B, H, W, D, r, lr_threshold, uniq, thr,
      false, false, stream));
}

#ifdef BM_KERNEL_DIAG
// G' runs the strip with its texture lane wherever the box runs (thr
// INT_MIN gates nothing). mode: 0 full (the production kernel),
// 1 the left view alone (its box
// and WTA; dr = dl, no L/R check), 2 the boxes alone (both outputs the
// view's cost summed over d, no WTA), 3 both WTAs on the centre row's AD
// without the box, no L/R check, 4 full with strips of 32 columns at every
// shape (what the 64-column strip gains where it is taken).
extern "C" int bm_match_diag(const uint8_t* L, const uint8_t* R, float* dl,
                             float* dr, int B, int H, int W, int D, int r,
                             float lr_threshold, float uniq, int mode,
                             void* stream) {
  cudaError_t e = cudaErrorInvalidValue;
  switch (mode) {
    case kFullMode:
    case 4:
      e = launch<kFullMode>(L, R, dl, dr, nullptr, nullptr, B, H, W, D, r,
                            lr_threshold, uniq, INT_MIN, mode == 4, false,
                            stream);
      break;
    case kOneWta:
      e = launch<kOneWta>(L, R, dl, dr, nullptr, nullptr, B, H, W, D, r,
                          lr_threshold, uniq, INT_MIN, false, false, stream);
      break;
    case kBoxOnly:
      e = launch<kBoxOnly>(L, R, dl, dr, nullptr, nullptr, B, H, W, D, r,
                           lr_threshold, uniq, INT_MIN, false, false, stream);
      break;
    case kNoBox:
      e = launch<kNoBox>(L, R, dl, dr, nullptr, nullptr, B, H, W, D, r,
                         lr_threshold, uniq, INT_MIN, false, false, stream);
      break;
  }
  return static_cast<int>(e);
}
#endif

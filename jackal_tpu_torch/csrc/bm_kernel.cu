// Block matching (SAD over a box window, both views' WTA, L/R check) in one
// pass that keeps the cost volume out of device memory.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/bm_kernel.py
// (_bm_band_kernel l.107, pallas_call in bm_match_pallas l.225). The plain
// PyTorch version of the same function is bm_match_fused_plain in
// jackal_tpu_torch/ops/bm_kernel.py (matching/bm.bm_views and the L/R
// check); the wrapper is ops/bm_kernel.bm_match_fused. It computes what
// matching/bm.bm_match computes before its texture gate, bit for bit, at
// every D: the invalid cost is 1 << 24 (the Pallas kernel lowers it at
// D > 64 to keep its int32 keys, and so differs from bm_match there).
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
// |dR(u - s) - dL| <= lr_threshold. dl, dr are float32 [B, H, W].
//
// What bounds it on an H100. Per (pixel, disparity) no single streaming
// pass can do less than 12 32-bit integer operations: the cost's two
// running box sums (the absolute difference fused with the vertical add in
// one SAD instruction, the vertical subtract, the horizontal add and
// subtract: 4) and, in each view, a packed (cost, d) key, the duel with
// the best (a minimum and a maximum) and the second best's minimum (4).
// That count leaves out the invalid-d selects (a loop can run over the
// valid d alone), the capture of the costs at best_d -+ 1 (they can be
// recomputed once a pixel) and the keys the +-1 exclusion needs, so it is
// a lower bound: 2.4e8 for a 640x480 frame at D = 64, 0.014 ms at the
// card's 1.67e13 integer operations a second; its bytes (two u8 images in,
// two f32 maps out, 10 a pixel) take 0.0009 ms. So the integer operations
// bound it, by 15x.
//
// The design. One block per (frame, band of TH rows) over the full width,
// so that the right view's cost_L(u + d, d) and the L/R check's dR(u - s)
// are reads of shared memory. The band's L and R rows and a halo of r rows
// above and below sit in shared memory (R with D zero columns in front, so
// x - d < 0 reads 0); the cost volume never leaves the SM. A thread owns
// CW columns (u = thread + T * j) of all TH rows and keeps both views'
// streaming WTA state of its TH * CW pixels in registers: the four least
// (cost, d) keys packed as (min(cost, 2^24 - 1) << 8) | d (real costs stay
// below 255 * 255^2 < 2^24 - 1, so the packing keeps the order, and d
// enters in increasing order, so ties keep the first d), the costs at
// best_d -+ 1 captured as they stream by. Per d: the vertical box of the
// thread's own columns as a running sum (no neighbour needed) into a
// shared row with r zero columns on either side; a barrier; the
// horizontal box from it, the left view's update and the cost row into
// shared memory; a barrier; the right view's update from cost_L(u + d, d).
// Registers bound the pixels a thread can own (TH * CW <= 8), so a wide
// frame gets a shorter band: the vertical halo is then recomputed more
// often, the price of keeping the volume on chip.
//
// Built with -DBM_KERNEL_DIAG, the library also exports bm_match_diag, a
// per-part timing of this kernel (the port of tools/diag_bm_kernel.py
// diag_kernel, pallas_call l.105): the same kernel with a compile-time mode
// that gates the per-d work. The production library compiles only the
// full mode.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 24;                    // bm_match's invalid cost
constexpr uint32_t kKeyCostMax = (1u << 24) - 1; // kBig's cost in a key
constexpr int kMaxCW = 8;                        // columns a thread: W <= 2048
constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;                 // a block's shared memory

enum Mode { kFull = 0, kOneWta = 1, kBoxOnly = 2, kNoBox = 3 };

struct Plan {
  int th, cw, threads, smem;
};

// Rows a block, columns a thread, threads and shared bytes for a width.
__host__ __device__ inline Plan plan(int W, int D, int r) {
  Plan p;
  p.cw = (W + kMaxThreads - 1) / kMaxThreads;
  p.th = p.cw >= 8 ? 1 : 8 / p.cw;
  if (p.th < 1) p.th = 1;
  const int per = (W + p.cw - 1) / p.cw;
  p.threads = (per + 31) / 32 * 32;
  const int thh = p.th + 2 * r;
  p.smem = 4 * p.th * (2 * W + 2 * r) + thh * (2 * W + D);
  return p;
}

__device__ __forceinline__ int key_cost(uint32_t key) {
  const int c = static_cast<int>(key >> 8);
  return c == static_cast<int>(kKeyCostMax) ? kBig : c;
}

// Streaming winner-take-all over increasing d of one view at one pixel.
struct Wta {
  uint32_t best, t1, t2, t3;  // the four least keys, ascending
  int cm, cp, prev;           // costs at best_d - 1, best_d + 1, d - 1
  bool take_cp;               // best improved at the last d

  __device__ __forceinline__ void init() {
    best = t1 = t2 = t3 = 0xFFFFFFFFu;
    cm = cp = prev = kBig;
    take_cp = false;
  }

  __device__ __forceinline__ void update(int cost, int d) {
    const uint32_t key =
        (static_cast<uint32_t>(min(cost, static_cast<int>(kKeyCostMax))) << 8) |
        static_cast<uint32_t>(d);
    const bool improved = key < best;
    if (improved) cm = prev;
    if (take_cp) cp = cost;
    take_cp = improved;
    uint32_t k = improved ? best : key;  // the loser of the duel for best
    best = improved ? key : best;
    uint32_t lo = min(k, t1);
    k = max(k, t1);
    t1 = lo;
    lo = min(k, t2);
    k = max(k, t2);
    t2 = lo;
    t3 = min(k, t3);
    prev = cost;
  }

  __device__ __forceinline__ float finish(int D, float uniq) const {
    const int bd = static_cast<int>(best & 255u);
    const int bc = key_cost(best);
    // at most two of t1..t3 lie at best_d +- 1, so the first that does not
    // is the least cost outside them
    const int second =
        abs(static_cast<int>(t1 & 255u) - bd) > 1   ? key_cost(t1)
        : abs(static_cast<int>(t2 & 255u) - bd) > 1 ? key_cost(t2)
                                                    : key_cost(t3);
    const bool unique = static_cast<float>(bc) <
                        __fmul_rn(uniq, static_cast<float>(second));
    const int den = cm + cp - 2 * bc;
    const float offs =
        (bd > 0 && bd < D - 1 && den > 0)
            ? __fdiv_rn(static_cast<float>(cm - cp),
                        __fmul_rn(2.0f, static_cast<float>(den)))
            : 0.0f;
    return unique ? __fadd_rn(static_cast<float>(bd), offs) : -1.0f;
  }
};

template <int TH, int CW, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
    bm_band_kernel(const uint8_t* __restrict__ L, const uint8_t* __restrict__ R,
                   float* __restrict__ dl_out, float* __restrict__ dr_out,
                   int H, int W, int D, int r, float lr_threshold,
                   float uniq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int ws = W + 2 * r;  // pitch of the vertical sums, r zeros each side
  const int thh = TH + 2 * r;
  const int rp = D + W;      // pitch of the R rows, D zeros in front
  int* colsum = reinterpret_cast<int*>(smem);       // [TH][ws]
  int* cost = colsum + TH * ws;                     // [TH][W]
  uint8_t* Ls = reinterpret_cast<uint8_t*>(cost + TH * W);  // [thh][W]
  uint8_t* Rs = Ls + thh * W;                                // [thh][rp]
  const int v0 = blockIdx.x * TH;
  const size_t frame = static_cast<size_t>(blockIdx.y) * H * W;

  for (int i = tid; i < TH * ws; i += T) colsum[i] = 0;
  for (int y = 0; y < thh; ++y) {
    const int v = v0 - r + y;
    const bool in = v >= 0 && v < H;
    const uint8_t* lrow = L + frame + static_cast<size_t>(in ? v : 0) * W;
    const uint8_t* rrow = R + frame + static_cast<size_t>(in ? v : 0) * W;
    for (int x = tid; x < W; x += T) Ls[y * W + x] = in ? lrow[x] : 0;
    for (int x = tid - D; x < W; x += T)
      Rs[y * rp + D + x] = (in && x >= 0) ? rrow[x] : 0;
  }
  __syncthreads();

  Wta wl[TH][CW], wr[TH][CW];
  int acc[TH][CW];
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      wl[i][j].init();
      wr[i][j].init();
      acc[i][j] = 0;
    }

  for (int d = 0; d < D; ++d) {
    // the vertical box of the AD down each of the thread's columns
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int u = tid + j * T;
      if (u >= W) continue;
      const uint8_t* lc = Ls + u;
      const uint8_t* rc = Rs + D + u - d;
      auto ad = [&](int y) {
        return abs(static_cast<int>(lc[y * W]) - static_cast<int>(rc[y * rp]));
      };
      if (MODE == kNoBox) {
#pragma unroll
        for (int i = 0; i < TH; ++i) colsum[i * ws + r + u] = ad(i + r);
      } else {
        int s = 0;
        for (int y = 0; y <= 2 * r; ++y) s += ad(y);
        colsum[r + u] = s;
#pragma unroll
        for (int i = 1; i < TH; ++i) {
          s += ad(i + 2 * r) - ad(i - 1);
          colsum[i * ws + r + u] = s;
        }
      }
    }
    __syncthreads();
    // the horizontal box, the left view, the cost row for the right view
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int u = tid + j * T;
      if (u >= W) continue;
#pragma unroll
      for (int i = 0; i < TH; ++i) {
        int c;
        if (MODE == kNoBox) {
          c = colsum[i * ws + r + u];
        } else {
          const int* row = colsum + i * ws + u;
          c = 0;
          for (int k = 0; k <= 2 * r; ++k) c += row[k];
        }
        if (MODE == kBoxOnly) {
          acc[i][j] += c;
          continue;
        }
        cost[i * W + u] = c;
        wl[i][j].update(u >= d ? c : kBig, d);
      }
    }
    __syncthreads();
    if (MODE == kFull || MODE == kNoBox) {
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int u = tid + j * T;
        if (u >= W) continue;
#pragma unroll
        for (int i = 0; i < TH; ++i)
          wr[i][j].update(u + d < W ? cost[i * W + u + d] : kBig, d);
      }
    }
  }
  __syncthreads();  // every read of the last cost row is done

  float* drs = reinterpret_cast<float*>(cost);  // the right map, [TH][W]
  float dlv[TH][CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int u = tid + j * T;
    if (u >= W) continue;
#pragma unroll
    for (int i = 0; i < TH; ++i) {
      const size_t o = frame + static_cast<size_t>(v0 + i) * W + u;
      if (MODE == kBoxOnly) {
        if (v0 + i < H) dl_out[o] = dr_out[o] = static_cast<float>(acc[i][j]);
        continue;
      }
      dlv[i][j] = wl[i][j].finish(D, uniq);
      const float dr = MODE == kOneWta ? dlv[i][j] : wr[i][j].finish(D, uniq);
      drs[i * W + u] = dr;
      if (v0 + i < H) dr_out[o] = dr;
    }
  }
  if (MODE == kBoxOnly) return;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    const int u = tid + j * T;
    if (u >= W) continue;
#pragma unroll
    for (int i = 0; i < TH; ++i) {
      if (v0 + i >= H) continue;
      float dl = dlv[i][j];
      if (MODE == kFull) {
        const int uw =
            min(max(static_cast<int>(__fsub_rn(static_cast<float>(u), dl)), 0),
                W - 1);
        const int idx = u - min(max(u - uw, 0), D);
        const float other = (idx >= 0 && idx < W) ? drs[i * W + idx] : -1e9f;
        const bool ok = dl >= 0.0f && other >= 0.0f &&
                        fabsf(__fsub_rn(other, dl)) <= lr_threshold;
        dl = ok ? dl : -1.0f;
      }
      dl_out[frame + static_cast<size_t>(v0 + i) * W + u] = dl;
    }
  }
}

template <int TH, int CW, int MODE>
cudaError_t launch_one(const uint8_t* L, const uint8_t* R, float* dl,
                       float* dr, int B, int H, int W, int D, int r,
                       float lr_threshold, float uniq, const Plan& p,
                       cudaStream_t stream) {
  auto kern = bm_band_kernel<TH, CW, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((H + TH - 1) / TH, B);
  kern<<<grid, p.threads, p.smem, stream>>>(L, R, dl, dr, H, W, D, r,
                                           lr_threshold, uniq);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const uint8_t* L, const uint8_t* R, float* dl, float* dr,
                   int B, int H, int W, int D, int r, float lr_threshold,
                   float uniq, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || D < 2 || D > 256 || r < 0 ||
      r > 127)
    return cudaErrorInvalidValue;
  const Plan p = plan(W, D, r);
  if (p.cw > kMaxCW || p.smem > kSmemMax) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
#define BM_CASE(CW_)                                                        \
  case CW_:                                                                 \
    return launch_one<(CW_ >= 8 ? 1 : 8 / CW_), CW_, MODE>(                 \
        L, R, dl, dr, B, H, W, D, r, lr_threshold, uniq, p, s);
  switch (p.cw) {
    BM_CASE(1)
    BM_CASE(2)
    BM_CASE(3)
    BM_CASE(4)
    BM_CASE(5)
    BM_CASE(6)
    BM_CASE(7)
    BM_CASE(8)
  }
#undef BM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared bytes a block needs at this width, D and r; -1 if the width is
// more than the kernel's threads can cover or the bytes pass a block's
// 227 KB. The wrapper refuses a shape that gives -1.
extern "C" int bm_smem_bytes(int W, int D, int r) {
  const Plan p = plan(W, D, r);
  return p.cw > kMaxCW || p.smem > kSmemMax ? -1 : p.smem;
}

extern "C" int bm_match(const uint8_t* L, const uint8_t* R, float* dl,
                        float* dr, int B, int H, int W, int D, int r,
                        float lr_threshold, float uniq, void* stream) {
  return static_cast<int>(
      launch<kFull>(L, R, dl, dr, B, H, W, D, r, lr_threshold, uniq, stream));
}

#ifdef BM_KERNEL_DIAG
// mode: 0 full (the production kernel), 1 left WTA only (dr = dl, no L/R
// check), 2 cost and box only (both outputs the cost summed over d), 3 the
// AD of the centre row without the box.
extern "C" int bm_match_diag(const uint8_t* L, const uint8_t* R, float* dl,
                             float* dr, int B, int H, int W, int D, int r,
                             float lr_threshold, float uniq, int mode,
                             void* stream) {
  cudaError_t e = cudaErrorInvalidValue;
  switch (mode) {
    case kFull:
      e = launch<kFull>(L, R, dl, dr, B, H, W, D, r, lr_threshold, uniq, stream);
      break;
    case kOneWta:
      e = launch<kOneWta>(L, R, dl, dr, B, H, W, D, r, lr_threshold, uniq,
                          stream);
      break;
    case kBoxOnly:
      e = launch<kBoxOnly>(L, R, dl, dr, B, H, W, D, r, lr_threshold, uniq,
                           stream);
      break;
    case kNoBox:
      e = launch<kNoBox>(L, R, dl, dr, B, H, W, D, r, lr_threshold, uniq,
                         stream);
      break;
  }
  return static_cast<int>(e);
}
#endif

// The SGM engine around kernels D-F: the census cost volume (O1) and the
// float epilogue with the u8 map (O2).
//
// Replaces no Pallas kernel: the reference package computes both inside its
// jitted program jackal_tpu/matching/sgm.py:sgm_match_pallas, O1 as
// census_cost_volume_hdw (l.98, vmapped at l.292) with right_view_volume
// (l.198, as l.301-302 apply it), O2 as _wta_from_maps (l.183) on both
// views, _lr_tail (l.216, with jackal_tpu/ops/shifts.py:18
// shifted_row_lookup) and the node's u8 conversion
// (jackal_tpu/pipeline/frame_pipeline.py:170). The plain PyTorch versions
// are sgm_cost_volume_plain and sgm_epilogue_plain in
// jackal_tpu_torch/ops/sgm_kernel.py, whose wrappers sgm_cost_volume and
// sgm_epilogue launch these kernels.
//
// O1. cl and cr are int32 census codes [B, H, W]. out is int16
// [B, H, D, W]: out[b, v, d, u] = popcount(cl[u] ^ cr[u - d]) where u >= d,
// else 12000 (_INVALID). With a second output, the right view's volume in
// the same launch: outR[b, v, d, u] = popcount(cl[u + d] ^ cr[u]) where
// u + d < W, else 12000, which is shift_by_d(out, -2) (true_right
// aggregates it on its own). __popc of the codes as unsigned gives the
// plain _popcount's count for every int32, negative ones too. Any D >= 2
// and W, D > W included (rows d >= W are all 12000). Integer only: exact.
//
// What bounds O1 on an H100: the volume written once, 2 D bytes a pixel
// (39.3 MB at the SGM node, 640x480, D = 64, 0.0117 ms at 3.35 TB/s); the
// codes read are 8 bytes a pixel, and the integer work (an xor, a popc and
// a select a cell) is below the byte time. The design: a block takes one
// (frame, row) and a view; a thread takes 8 adjacent columns and 8
// consecutive d. It holds its own 8 codes in registers and slides a window
// of 8 codes of the other view one column a d (one load a d), and writes
// each d's 8 costs as one 16-byte store: consecutive threads take
// consecutive columns, so a warp writes 512 contiguous bytes. Widths that
// are no multiple of 8 take scalar loads and stores.
//
// O2. maps is F's int16 [B, H, 10, W] (the left view's best, best_d,
// second, cost at best_d - 1 and at best_d + 1 in rows 0-4, the right
// view's in rows 5-9); with true_right the right view's five rows are rows
// 0-4 of F's maps of the right volume (rmaps, roff 0) instead. For each
// pixel each view's disparity (uniqueness, sub-pixel), the L/R check and
// the u8 map as csrc/sgm_epilogue.cuh computes them (the plain version's
// float32 arithmetic, nothing contracted, IEEE division). dR at the lookup
// column is computed again from that column's maps rather than read back,
// so a thread needs no other thread's result and the kernel has no barrier
// and no width limit. Kernel F takes O2's work into its own launch up to
// D = 64 (sgm_wta_kernel.cu, sgm_wta_epilogue); O2 stays for true_right
// and past D = 64, where the fold is slower (ops/sgm_kernel.
// sgm_tail_route).
//
// What bounds O2 on an H100: the ten int16 maps read and dL, dR and the u8
// map written once, 29 bytes a pixel (8.9 MB at the node, 0.0027 ms); a
// thread a pixel, every access coalesced but the lookup's, which reads
// columns at most D to the left of its own, from L1.
#include <cstdint>
#include <cuda_runtime.h>

#include "sgm_epilogue.cuh"

namespace {

constexpr int kInvalid = 12000;       // the cost volume's "no such pair"
constexpr int kCostThreads = 256;
constexpr int kLanes = 8;             // columns a thread, and d a thread
constexpr int kEpiThreads = 256;
constexpr int kMapRows = 10;

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) |
         (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t code_at(const uint32_t* row, int i,
                                            int W) {
  return (i >= 0 && i < W) ? __ldg(row + i) : 0u;
}

// One (frame, row) of one view's volume. kRight: the right view, whose
// thread holds the right codes of its columns and slides the left ones.
template <bool kVec, bool kRight>
__device__ __forceinline__ void cost_row(const uint32_t* __restrict__ L,
                                         const uint32_t* __restrict__ R,
                                         int16_t* __restrict__ o, int D,
                                         int W) {
  const int chunks = (W + kLanes - 1) / kLanes;
  const int items = chunks * ((D + kLanes - 1) / kLanes);
  const uint32_t* own = kRight ? R : L;
  const uint32_t* other = kRight ? L : R;
  for (int item = threadIdx.x; item < items; item += kCostThreads) {
    const int u0 = (item % chunks) * kLanes;
    const int d0 = (item / chunks) * kLanes;
    uint32_t mine[kLanes], win[kLanes];
    if (kVec) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(own + u0));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(own + u0 + 4));
      mine[0] = a.x; mine[1] = a.y; mine[2] = a.z; mine[3] = a.w;
      mine[4] = b.x; mine[5] = b.y; mine[6] = b.z; mine[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < kLanes; ++k) mine[k] = code_at(own, u0 + k, W);
    }
    // the window at d0: left view cr[u - d0], right view cl[u + d0]
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      win[k] = code_at(other, kRight ? u0 + k + d0 : u0 + k - d0, W);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int d = d0 + j;
      if (d >= D) break;
      int c[kLanes];
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        const bool valid = kRight ? (u0 + k + d < W) : (u0 + k >= d);
        c[k] = valid ? __popc(mine[k] ^ win[k]) : kInvalid;
      }
      int16_t* dst = o + static_cast<size_t>(d) * W + u0;
      if (kVec) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack2(c[0], c[1]), pack2(c[2], c[3]),
                       pack2(c[4], c[5]), pack2(c[6], c[7]));
      } else {
#pragma unroll
        for (int k = 0; k < kLanes; ++k)
          if (u0 + k < W) dst[k] = static_cast<int16_t>(c[k]);
      }
      // slide one column: the left view's window moves left, the right's
      // right
      if (kRight) {
#pragma unroll
        for (int k = 0; k < kLanes - 1; ++k) win[k] = win[k + 1];
        win[kLanes - 1] = code_at(other, u0 + kLanes + d, W);
      } else {
#pragma unroll
        for (int k = kLanes - 1; k > 0; --k) win[k] = win[k - 1];
        win[0] = code_at(other, u0 - d - 1, W);
      }
    }
  }
}

// blockIdx.x: frame * H + row; blockIdx.y: 0 the left view's volume, 1
// the right view's (launched only when outR is given)
template <bool kVec>
__global__ void __launch_bounds__(kCostThreads)
    sgm_cost_volume_kernel(const uint32_t* __restrict__ cl,
                           const uint32_t* __restrict__ cr,
                           int16_t* __restrict__ out,
                           int16_t* __restrict__ outR, int D, int W) {
  const size_t row = blockIdx.x;
  const uint32_t* L = cl + row * W;
  const uint32_t* R = cr + row * W;
  const size_t plane = row * static_cast<size_t>(D) * W;
  if (blockIdx.y == 0)
    cost_row<kVec, false>(L, R, out + plane, D, W);
  else
    cost_row<kVec, true>(L, R, outR + plane, D, W);
}

// a view's disparity at column u from its five map rows m (row pitch W)
__device__ __forceinline__ float wta_disp(const int16_t* __restrict__ m,
                                          int W, int u, int D, float ratio) {
  return sgm_wta_disp(m[u], m[W + u], m[2 * W + u], m[3 * W + u],
                      m[4 * W + u], D, ratio);
}

__global__ void __launch_bounds__(kEpiThreads)
    sgm_epilogue_kernel(const int16_t* __restrict__ maps,
                        const int16_t* __restrict__ rmaps, int roff,
                        float* __restrict__ dl, float* __restrict__ dr,
                        uint8_t* __restrict__ u8, int W, int D, float ratio,
                        float lr, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kEpiThreads +
                      threadIdx.x;
  if (i >= n) return;
  const long long row = i / W;
  const int u = static_cast<int>(i - row * W);
  const int16_t* ml = maps + row * kMapRows * W;
  const int16_t* mr = rmaps + (row * kMapRows + roff) * W;
  const float dL = wta_disp(ml, W, u, D, ratio);
  dr[i] = wta_disp(mr, W, u, D, ratio);
  const int j = sgm_lr_column(u, dL, W, D);
  const float other =
      (j >= 0 && j < W) ? wta_disp(mr, W, j, D, ratio) : -1e9f;
  const float out = sgm_lr_keep(dL, other, lr);
  dl[i] = out;
  if (u8 != nullptr) u8[i] = sgm_u8(out);
}

}  // namespace

// O1: out (and outR where not null) int16 [B, H, D, W] from int32 codes
// [B, H, W]. 16-byte stores where W % 8 == 0 (the codes and outputs then
// 16-byte aligned), scalar ones otherwise.
extern "C" int sgm_cost_volume(const int32_t* cl, const int32_t* cr,
                               int16_t* out, int16_t* outR, int B, int H,
                               int W, int D, void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 2 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(B * H), outR != nullptr ? 2 : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* l = reinterpret_cast<const uint32_t*>(cl);
  const uint32_t* r = reinterpret_cast<const uint32_t*>(cr);
  if (W % kLanes == 0)
    sgm_cost_volume_kernel<true><<<grid, kCostThreads, 0, s>>>(l, r, out,
                                                                outR, D, W);
  else
    sgm_cost_volume_kernel<false><<<grid, kCostThreads, 0, s>>>(l, r, out,
                                                                 outR, D, W);
  return static_cast<int>(cudaGetLastError());
}

// O2: dl, dr float32 [B, H, W] and, where u8 is not null, the u8 map of dl,
// from F's maps [B, H, 10, W]; the right view's rows are rows 5-9 of maps,
// or rows 0-4 of maps_right where it is not null (true_right).
extern "C" int sgm_epilogue(const int16_t* maps, const int16_t* maps_right,
                            float* dl, float* dr, uint8_t* u8, int B, int H,
                            int W, int D, float ratio, float lr,
                            void* stream) {
  const long long n = static_cast<long long>(B) * H * W;
  const long long blocks = (n + kEpiThreads - 1) / kEpiThreads;
  if (B < 1 || H < 1 || W < 1 || D < 2 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int16_t* rmaps = maps_right != nullptr ? maps_right : maps;
  const int roff = maps_right != nullptr ? 0 : 5;
  sgm_epilogue_kernel<<<static_cast<unsigned>(blocks), kEpiThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      maps, rmaps, roff, dl, dr, u8, W, D, ratio, lr, n);
  return static_cast<int>(cudaGetLastError());
}

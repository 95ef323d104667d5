// SGM winner-take-all maps of both views in one read of the path sum.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/sgm_kernel.py
// (_wta_maps_kernel l.415, pallas_call in sgm_wta_maps_pallas l.506). The
// plain PyTorch version of the same function is sgm_wta_maps_plain in
// jackal_tpu_torch/ops/sgm_kernel.py (wta_maps of matching/sgm.py on the
// volume and on its right view); the wrapper is ops/sgm_kernel.sgm_wta_maps.
//
// What it computes. S is int16 [B, H, D, W]. For each pixel (b, v, u) and
// each view, five statistics over d: the best (least) value, the FIRST d
// that has it, the least value outside best_d +- 1, and the values at
// best_d - 1 and best_d + 1 (30000 where the d does not exist or no d is
// left). The left view reads S[d, v, u]; the right view reads SR[d, v, u] =
// S[d, v, u + d], and 12000 (the cost volume's "no such pair" sentinel,
// not the carry clamp) where u + d >= W, as both reference engines do:
// at the right border that sentinel can win the right view's WTA, and it
// must. out is int16 [B, H, 10, W]: the left view's five rows, then the
// right view's.
//
// What bounds it on an H100. The least work is one read of S and the
// writes of the maps: 2 D + 20 bytes a pixel, 39.3 MB + 6.1 MB for a
// 640x480 frame at D = 64, 0.0136 ms at 3.35 TB/s; the arithmetic, a
// compare and a select a value in each of two walks, both views, is
// 0.0094 ms at the card's 32-bit integer rate, so it is bound by bytes.
// The design: one thread per
// (frame, row, column), 128 columns a block; every load of the walk over d
// is coalesced along u (neighbouring threads, neighbouring columns; the
// right view's loads are the same row shifted by d). Each view walks d
// twice: first for the best and its first d, then for the second best and
// the neighbours. The second walk reads the block's [D, 128] slab again,
// 16 KB at D = 64, from L1 or L2, so device memory sees S about once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWtaBig = 30000;
constexpr int kInvalid = 12000;

// get(d) -> the view's value at d
template <typename Get>
__device__ __forceinline__ void wta5(Get get, int D, int16_t* out,
                                     int stride) {
  int best = get(0), bd = 0;
  for (int d = 1; d < D; ++d) {
    const int x = get(d);
    if (x < best) {  // strict: the first d at the minimum
      best = x;
      bd = d;
    }
  }
  int second = kWtaBig;
  for (int d = 0; d < D; ++d)
    if (d < bd - 1 || d > bd + 1) second = min(second, get(d));
  const int cm = bd > 0 ? get(bd - 1) : kWtaBig;
  const int cp = bd < D - 1 ? get(bd + 1) : kWtaBig;
  out[0] = static_cast<int16_t>(best);
  out[stride] = static_cast<int16_t>(bd);
  out[2 * stride] = static_cast<int16_t>(second);
  out[3 * stride] = static_cast<int16_t>(cm);
  out[4 * stride] = static_cast<int16_t>(cp);
}

__global__ void sgm_wta_maps_kernel(const int16_t* __restrict__ S,
                                    int16_t* __restrict__ out, int H, int D,
                                    int W) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= W) return;
  const size_t row = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const int16_t* s = S + row * D * W;
  int16_t* o = out + row * 10 * W + u;
  wta5([&](int d) { return static_cast<int>(__ldg(s + static_cast<size_t>(d) * W + u)); },
       D, o, W);
  wta5([&](int d) {
         return u + d < W
                    ? static_cast<int>(__ldg(s + static_cast<size_t>(d) * W + u + d))
                    : kInvalid;
       },
       D, o + 5 * W, W);
}

}  // namespace

extern "C" int sgm_wta_maps(const int16_t* S, int16_t* out, int B, int H,
                            int D, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 2 || D > 256 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  sgm_wta_maps_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(S, out, H, D, W);
  return static_cast<int>(cudaGetLastError());
}

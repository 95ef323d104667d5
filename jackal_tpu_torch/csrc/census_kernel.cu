// SGM census transform: 24-bit 5x5 census codes of a batch of images.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/sgm_kernel.py
// (_census_kernel, pallas_call in census5x5_pallas l.374). The plain
// PyTorch version of the same function is census5x5 in
// jackal_tpu_torch/matching/sgm.py; the wrapper is
// ops/sgm_kernel.census5x5_batch.
//
// What it computes. img is uint8 [N, H, W]; out[n, v, u] is int32 with bit
// k set where the k-th neighbour of the 5x5 window, visited dv-major then
// du (-2..2 each, the centre skipped), is darker than the centre.
// Coordinates are clamped into the image, which is the reference's
// edge-mode padding. The node launches it once for the left and right
// batches together (N = 2B).
//
// What bounds it on an H100. Each pixel needs one byte read and four bytes
// written, 3.1 MB for a 640x480 pair (0.9 us at 3.35 TB/s), and 24
// compares and 24 bit inserts, 29.5e6 integer operations (1.8 us at the
// card's 32-bit integer rate, 64 a clock an SM): bound by operations, and
// at that size by the launch. The design: one thread per output pixel,
// 128 along a row; the 25 window loads go through the read-only cache,
// where the neighbouring threads' windows overlap, so device memory sees
// each byte about once. A shared-memory tile with a halo would save L1 traffic,
// not device-memory bytes, and is left out.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void census5x5_kernel(const uint8_t* __restrict__ img,
                                 int32_t* __restrict__ out, int H, int W) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y;
  if (u >= W) return;
  const uint8_t* p = img + static_cast<size_t>(blockIdx.z) * H * W;
  const int c = __ldg(p + static_cast<size_t>(v) * W + u);
  int code = 0, bit = 0;
#pragma unroll
  for (int dv = -2; dv <= 2; ++dv) {
    const uint8_t* row = p + static_cast<size_t>(min(max(v + dv, 0), H - 1)) * W;
#pragma unroll
    for (int du = -2; du <= 2; ++du) {
      if (dv == 0 && du == 0) continue;
      const int nb = __ldg(row + min(max(u + du, 0), W - 1));
      code |= (nb < c ? 1 : 0) << bit;
      ++bit;
    }
  }
  out[(static_cast<size_t>(blockIdx.z) * H + v) * W + u] = code;
}

}  // namespace

extern "C" int census5x5(const uint8_t* img, int32_t* out, int N, int H,
                         int W, void* stream) {
  if (N < 1 || H < 1 || W < 1 || H > 65535 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, H, N);
  census5x5_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

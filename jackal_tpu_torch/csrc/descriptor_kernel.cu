// ELAS descriptor: bias-128 Sobel gradients and the 16-byte feature of
// every pixel, one launch for all frames.
//
// Replaces no Pallas kernel: the reference runs it as one jitted program,
// jackal_tpu/ops/descriptor.py:74 create_descriptor (with sobel3x3 :51).
// The plain PyTorch version of the same function is
// create_descriptor_plain in ops/descriptor.py; the wrapper there
// (create_descriptor) launches this kernel on a CUDA tensor.
//
// What it computes. img is u8 [N, H, W]; out is u8 [N, H, W, 16]. With
//   tv(y, x) = im(y-1, x) + 2 im(y, x) + im(y+1, x)
//   th(y, x) = im(y-1, x) - im(y+1, x)
//   du(y, x) = sat_u8(((tv(y, x-1) - tv(y, x+1)) >> 2) + 128)
//   dv(y, x) = sat_u8(((th(y, x-1) + 2 th(y, x) + th(y, x+1)) >> 2) + 128)
// in int32 with an arithmetic shift (filter::sobel3x3), the 16 channels of
// pixel (v, u) are du or dv at (v + dy, u + dx) in the reference's order
// (DESC_OFFSETS, descriptor.cpp:94-109). Outside the valid region the
// output is 0: 3 <= v <= H-4 and 3 <= u <= W-4, or with half_resolution
// (ELAS subsampling) the even rows 4 <= v <= H-4 and 3 <= u <= W-4. Every
// tap of a valid pixel lies in [1, H-2] x [1, W-2], where du and dv read
// only pixels of the image, so the 1-pixel border of 128 that sobel3x3
// writes is never read and the kernel needs no padding.
//
// What bounds it on an H100: bytes. N*H*W in and 16*N*H*W out (both views
// at 640x480: 10.4 MB, 0.0031 ms at 3.35 TB/s); the integer work is ~60
// instructions a pixel, some 0.0011 ms at 64 a clock an SM.
//
// The design. A block of 256 threads owns an output tile of 8 rows and 32
// columns of one frame. It stages the tile's source with a 3-pixel halo
// (14 x 38 bytes, coordinates clamped into the image: a clamped byte only
// feeds a du or dv that no valid pixel reads) in shared memory, computes
// du and dv on the tile with a 2-pixel halo (12 x 36) into shared memory,
// then a thread gathers its pixel's 16 channels, packs them into four
// words and writes them with one 16-byte store: a warp writes one row's
// 512 contiguous bytes. Zeros outside the valid region are written by the
// same store, so the output needs no fill.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;            // tile columns
constexpr int kTH = 8;             // tile rows
constexpr int kThreads = kTW * kTH;
constexpr int kSW = kTW + 6;       // source tile, 3-pixel halo
constexpr int kSH = kTH + 6;
constexpr int kGW = kTW + 4;       // gradients, 2-pixel halo
constexpr int kGH = kTH + 4;

__device__ __forceinline__ uint32_t sat_u8(int x) {
  return static_cast<uint32_t>(min(max(x, 0), 255));
}

__global__ void __launch_bounds__(kThreads)
descriptor_kernel(const uint8_t* __restrict__ img, uint4* __restrict__ out,
                  int H, int W, int half) {
  __shared__ int src[kSH][kSW];
  __shared__ uint8_t du[kGH][kGW];
  __shared__ uint8_t dv[kGH][kGW];
  const int u0 = blockIdx.x * kTW, v0 = blockIdx.y * kTH;
  const size_t frame = static_cast<size_t>(blockIdx.z) * H * W;
  const uint8_t* im = img + frame;
  const int t = threadIdx.x;
  for (int i = t; i < kSH * kSW; i += kThreads) {
    const int y = min(max(v0 - 3 + i / kSW, 0), H - 1);
    const int x = min(max(u0 - 3 + i % kSW, 0), W - 1);
    src[i / kSW][i % kSW] = im[static_cast<size_t>(y) * W + x];
  }
  __syncthreads();
  // gradient (gy, gx) sits at image (v0 - 2 + gy, u0 - 2 + gx), source
  // (gy + 1, gx + 1)
  for (int i = t; i < kGH * kGW; i += kThreads) {
    const int gy = i / kGW, gx = i % kGW;
    const int* a = &src[gy][gx];            // row y - 1, column x - 1
    const int* b = a + kSW;                 // row y
    const int* c = b + kSW;                 // row y + 1
    const int tvl = a[0] + 2 * b[0] + c[0], tvr = a[2] + 2 * b[2] + c[2];
    const int thl = a[0] - c[0], thm = a[1] - c[1], thr = a[2] - c[2];
    du[gy][gx] = static_cast<uint8_t>(sat_u8(((tvl - tvr) >> 2) + 128));
    dv[gy][gx] =
        static_cast<uint8_t>(sat_u8(((thl + 2 * thm + thr) >> 2) + 128));
  }
  __syncthreads();
  const int tx = t % kTW, ty = t / kTW;
  const int u = u0 + tx, v = v0 + ty;
  if (u >= W || v >= H) return;
  const bool valid =
      u >= 3 && u <= W - 4 && v <= H - 4 &&
      (half ? (v >= 4 && (v & 1) == 0) : v >= 3);
  uint4 o = make_uint4(0, 0, 0, 0);
  if (valid) {
    // pixel (v, u) at gradient (ty + 2, tx + 2)
    const uint8_t* U = &du[ty + 2][tx + 2];
    const uint8_t* V = &dv[ty + 2][tx + 2];
    auto p = [](uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
      return a | (b << 8) | (c << 16) | (d << 24);
    };
    o.x = p(U[-2 * kGW], U[-kGW - 2], U[-kGW], U[-kGW + 2]);
    o.y = p(U[-1], U[0], U[0], U[1]);
    o.z = p(U[kGW - 2], U[kGW], U[kGW + 2], U[2 * kGW]);
    o.w = p(V[-kGW], V[-1], V[1], V[kGW]);
  }
  out[frame + static_cast<size_t>(v) * W + u] = o;
}

}  // namespace

// out: u8 [N, H, W, 16] (16-byte aligned); img: u8 [N, H, W]. One launch.
// Returns cudaErrorInvalidValue for a shape the grid cannot hold.
extern "C" int elas_descriptor(const uint8_t* img, uint8_t* out, int N, int H,
                               int W, int half, void* stream) {
  if (N < 1 || H < 1 || W < 1 || N > 65535 || (H + kTH - 1) / kTH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, N);
  descriptor_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, reinterpret_cast<uint4*>(out), H, W, half);
  return static_cast<int>(cudaGetLastError());
}

// ELAS descriptor: bias-128 Sobel gradients and the 16-byte feature of
// every pixel, one launch for all frames of both views.
//
// Replaces no Pallas kernel: the reference runs it as one jitted program,
// jackal_tpu/ops/descriptor.py:74 create_descriptor (with sobel3x3 :51).
// The plain PyTorch version of the same function is
// create_descriptor_plain in ops/descriptor.py; the wrappers there
// (create_descriptor, create_descriptor_pair) launch this kernel on CUDA
// tensors.
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
// writes is never read and the kernel needs no padding: a coordinate
// outside the image is clamped into it, and what it feeds no valid pixel
// reads.
//
// What bounds it on an H100: bytes. N*H*W in and 16*N*H*W out (both views
// at 640x480: 10.4 MB, 0.0031 ms at 3.35 TB/s; the output is 94 % of it);
// the integer work is ~55 instructions a pixel, some 0.001 ms at 64 a
// clock an SM.
//
// The design: a warp slides down a strip of columns, with no shared
// memory and no barrier. Lane l owns column x = u0 - 3 + l of a strip of
// 26 output columns [u0, u0 + 26) and TH output rows [v0, v0 + TH) of one
// frame. It loads its column's TH + 6 source rows up front (one coalesced
// 32-byte segment a warp and row, all in flight at once), then for each
// gradient row y in [v0 - 2, v0 + TH + 2):
//  - tv and th of its column from three source rows in registers, packed
//    into one word (tv + th * 65536) that two shuffles bring from lanes
//    l -+ 1: du and dv of its column (valid on lanes 1..30);
//  - four more shuffles: du at x -+ 2 (read at rows v -+ 1) and du, dv at
//    x -+ 1 (read at row v), kept in registers with its own du, dv of the
//    last five rows;
//  - once row y = v + 2 is in, lanes 3..28 pack pixel (v, x)'s 16 bytes
//    and store them with one 16-byte store: the warp writes one row's 416
//    contiguous bytes, TH stores a lane back to back, and the zeros
//    outside the valid region go by the same store, so the output needs
//    no fill.
// The halo costs 6/32 of a warp's lanes and 4 of its TH + 4 gradient
// rows. TH (the band, DESCRIPTOR_BAND) is 8: taller bands cost less halo
// but leave fewer warps in flight, and measured slower at both nodes'
// shapes (640x480 on an H100 SXM at 700 W, tools/time_support_kernel.py
// --kernel front, which times the band variants of ops/cuda_lib.VARIANTS:
// both views 0.0062 ms at 8 rows, 0.0069 at 16, 0.0089 at 32, 0.0065 at
// 4; 16 frames 0.0332, 0.0345, 0.0359, 0.0348). The first design (an
// 8 x 32 tile a block: source and du, dv staged in shared memory a byte a
// load, three phases split by two barriers, one store a thread) took
// 0.00834 ms for both views at 640x480 on an H100 SXM at 700 W.
#include <cstdint>
#include <cuda_runtime.h>

#ifndef DESCRIPTOR_BAND
#define DESCRIPTOR_BAND 8
#endif

namespace {

constexpr int TH = DESCRIPTOR_BAND;  // the rows a warp slides down
constexpr int kOut = 26;      // output columns a warp: lanes 3..28
constexpr int kWarps = 4;     // warps a block, each on its own strip
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int sat_u8(int x) { return min(max(x, 0), 255); }

// frames [0, n1) of the launch are left's, [n1, N) right's
__global__ void __launch_bounds__(kWarps * 32)
descriptor_kernel(const uint8_t* __restrict__ left,
                  const uint8_t* __restrict__ right, int n1,
                  uint4* __restrict__ out, int H, int W, int half,
                  int strips) {
  const int lane = threadIdx.x & 31;
  const int strip = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (strip >= strips) return;  // the whole warp: no shuffle is left short
  const int z = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  const uint8_t* im = z < n1 ? left + z * plane : right + (z - n1) * plane;
  const int x = strip * kOut - 3 + lane;
  const int xc = min(max(x, 0), W - 1);
  const int v0 = blockIdx.y * TH;
  // source rows v0 - 3 + i
  int s[TH + 6];
#pragma unroll
  for (int i = 0; i < TH + 6; ++i) {
    const int y = min(max(v0 - 3 + i, 0), H - 1);
    s[i] = __ldg(im + static_cast<size_t>(y) * W + xc);
  }
  const bool lane_out = lane >= 3 && lane < 3 + kOut && x < W;
  const bool col_ok = x >= 3 && x <= W - 4;
  uint4* o = out + z * plane + x;
  // gradient row k is image row v0 - 2 + k: own du | dv << 8 (g), du at
  // x -+ 2 (d2m, d2p), g at x -+ 1 (g1m, g1p)
  int g[TH + 4], d2m[TH + 4], d2p[TH + 4], g1m[TH + 4], g1p[TH + 4];
#pragma unroll
  for (int k = 0; k < TH + 4; ++k) {
    const int th = s[k] - s[k + 2];
    const int p = s[k] + 2 * s[k + 1] + s[k + 2] + th * 65536;
    const int pm = __shfl_up_sync(kAll, p, 1);
    const int pp = __shfl_down_sync(kAll, p, 1);
    const int du = sat_u8((((pm & 0xffff) - (pp & 0xffff)) >> 2) + 128);
    const int dv = sat_u8((((pm >> 16) + 2 * th + (pp >> 16)) >> 2) + 128);
    g[k] = du | dv << 8;
    d2m[k] = __shfl_up_sync(kAll, du, 2);
    d2p[k] = __shfl_down_sync(kAll, du, 2);
    g1m[k] = __shfl_up_sync(kAll, g[k], 1);
    g1p[k] = __shfl_down_sync(kAll, g[k], 1);
    if (k < 4) continue;
    const int c = k - 2;        // pixel row v = v0 + c - 2
    const int v = v0 + c - 2;
    if (!lane_out || v >= H) continue;
    const bool valid = col_ok && v <= H - 4 &&
                       (half ? (v >= 4 && (v & 1) == 0) : v >= 3);
    uint4 q = make_uint4(0, 0, 0, 0);
    if (valid) {
      const uint32_t um = g[c - 1] & 255, u0 = g[c] & 255,
                     up = g[c + 1] & 255;
      q.x = (g[c - 2] & 255) | d2m[c - 1] << 8 | um << 16 |
            static_cast<uint32_t>(d2p[c - 1]) << 24;
      q.y = (g1m[c] & 255) | u0 << 8 | u0 << 16 |
            static_cast<uint32_t>(g1p[c] & 255) << 24;
      q.z = d2m[c + 1] | up << 8 | d2p[c + 1] << 16 |
            static_cast<uint32_t>(g[c + 2] & 255) << 24;
      q.w = (g[c - 1] >> 8) | (g1m[c] >> 8) << 8 | (g1p[c] >> 8) << 16 |
            static_cast<uint32_t>(g[c + 1] >> 8) << 24;
    }
    o[static_cast<size_t>(v) * W] = q;
  }
}

}  // namespace

// out: u8 [N, H, W, 16] (16-byte aligned): frames [0, n1) from left
// (u8 [n1, H, W]), frames [n1, N) from right (u8 [N - n1, H, W]), each
// read where they lie (left and right may be one tensor). One launch.
// Returns cudaErrorInvalidValue for a shape the grid cannot hold.
extern "C" int elas_descriptor_pair(const uint8_t* left, const uint8_t* right,
                                    uint8_t* out, int n1, int N, int H, int W,
                                    int half, void* stream) {
  if (N < 1 || H < 1 || W < 1 || N > 65535 || n1 < 0 || n1 > N ||
      (H + TH - 1) / TH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int strips = (W + kOut - 1) / kOut;
  const dim3 grid((strips + kWarps - 1) / kWarps, (H + TH - 1) / TH, N);
  descriptor_kernel<<<grid, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      left, right, n1, reinterpret_cast<uint4*>(out), H, W, half, strips);
  return static_cast<int>(cudaGetLastError());
}

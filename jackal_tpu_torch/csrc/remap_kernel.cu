// Kernel N: the bilinear rectify warp of uint8 frames, cv::remap with
// INTER_LINEAR and BORDER_CONSTANT(0) in 15-bit fixed point.
//
// Replaces jackal_tpu/geometry/remap.py remap_bilinear (l.57) and
// remap_bilinear_batch (l.106), which the reference runs as jnp gathers
// under jit (no Pallas kernel). Its plain PyTorch version is
// geometry/remap.py remap_bilinear_plain; this kernel computes the same
// function, bit for bit:
//
//   sx = rint(2^15 * mapx)   __float2int_rn: half to even, as torch.round;
//                            saturating, NaN -> 0, as XLA's convert
//   x0 = sx >> 15, fx = sx & 0x7fff (the same for y)
//   v  = frame[y, x] inside the frame, else 0 (BORDER_CONSTANT)
//   h0 = (v00 * (2^15 - fx) + v01 * fx + 2^14) >> 15, h1 likewise
//   out = (h0 * (2^15 - fy) + h1 * fy + 2^14) >> 15
//
// Every product is at most 255 * 2^15 < 2^23 and every sum below 2^24,
// so the integer arithmetic equals the plain version's exact f32 lerp and
// its floor. The multiply by 2^15 is exact in f32 (a power of two) unless
// it overflows to inf, which saturates like any value past 2^31.
//
// What bounds it on an H100: bytes. It must read each frame once (u8),
// both maps once (f32) and write each output once (u8): at 640x480 one
// frame and its maps are 0.3 MB in, 2.5 MB of maps, 0.3 MB out. The
// reference's jnp path gathers four taps through index arrays; the plain
// version does the same with four gathers, wheres and lerps, ~40 eager
// launches. Design: one thread an output pixel of a view computes its
// taps and weights once from the maps (read once, coalesced) and loops
// over the leading frames (the batch, and the colour channels riding the
// batch axis), so the maps are read once whatever the batch, as the
// reference's batch path shares one gather across frames. Both views of a
// stereo pair go in one launch (blockIdx.y the view), each with its own
// maps. The taps are gathers of neighbouring bytes: a warp's 32 output
// pixels read ~33 neighbouring source columns of one or two rows, which
// the L1 serves.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kViews = 2;

struct View {
  const uint8_t* img;   // [F, H, W]
  const float* mapx;    // [Ho, Wo]
  const float* mapy;
  uint8_t* out;         // [F, Ho, Wo]
};

struct Views {
  View v[kViews];
};

__device__ __forceinline__ int tap(const uint8_t* frame, int y, int x, int H,
                                   int W) {
  return (x >= 0 && x < W && y >= 0 && y < H)
             ? static_cast<int>(frame[static_cast<int64_t>(y) * W + x])
             : 0;
}

__global__ void __launch_bounds__(kThreads)
remap_kernel(Views views, int F, int H, int W, int Ho, int Wo) {
  const int64_t npix = static_cast<int64_t>(Ho) * Wo;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= npix) return;
  // a select, not an index into the parameters: no copy to local memory
  const View v = blockIdx.y ? views.v[1] : views.v[0];
  const int sx = __float2int_rn(__fmul_rn(v.mapx[p], 32768.f));
  const int sy = __float2int_rn(__fmul_rn(v.mapy[p], 32768.f));
  const int x0 = sx >> 15, y0 = sy >> 15;
  const int fx = sx & 0x7fff, fy = sy & 0x7fff;
  const int wx0 = 32768 - fx, wy0 = 32768 - fy;
  const int64_t fs = static_cast<int64_t>(H) * W;
  for (int f = 0; f < F; ++f) {
    const uint8_t* frame = v.img + f * fs;
    const int h0 = (tap(frame, y0, x0, H, W) * wx0 +
                    tap(frame, y0, x0 + 1, H, W) * fx + 16384) >> 15;
    const int h1 = (tap(frame, y0 + 1, x0, H, W) * wx0 +
                    tap(frame, y0 + 1, x0 + 1, H, W) * fx + 16384) >> 15;
    v.out[f * npix + p] =
        static_cast<uint8_t>((h0 * wy0 + h1 * fy + 16384) >> 15);
  }
}

}  // namespace

// views sets of (img, mapx, mapy, out), 1 <= views <= kViews; the unused
// ones are null. F frames of H x W a view, maps and outputs Ho x Wo.
extern "C" int remap_bilinear_u8(const uint8_t* img0, const float* mapx0,
                                 const float* mapy0, uint8_t* out0,
                                 const uint8_t* img1, const float* mapx1,
                                 const float* mapy1, uint8_t* out1, int views,
                                 int F, int H, int W, int Ho, int Wo,
                                 void* stream) {
  if (views < 1 || views > kViews || F < 0 || H < 1 || W < 1 || Ho < 0 ||
      Wo < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t npix = static_cast<int64_t>(Ho) * Wo;
  const int64_t blocks = (npix + kThreads - 1) / kThreads;
  if (F == 0 || blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  Views vs;
  vs.v[0] = View{img0, mapx0, mapy0, out0};
  vs.v[1] = View{img1, mapx1, mapy1, out1};
  remap_kernel<<<dim3(static_cast<unsigned>(blocks), views), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(vs, F, H, W, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}

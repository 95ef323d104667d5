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
// frame and its maps are 0.3 MB in, 2.5 MB of maps, 0.3 MB out.
//
// Design: a block owns a 64 x 16 output tile of one view (blockIdx.y; both
// views of a stereo pair go in one launch, each with its own maps) and
// every frame of that view (the batch, and the colour channels riding the
// batch axis), so the maps are read once whatever the batch. A thread
// owns 4 adjacent outputs of a row: it reads their maps once, keeps their
// taps and weights in registers for every frame, and writes the 4 bytes
// in one 32-bit store where the row width allows. The block reduces its
// tile's source box (the least and largest x0, y0, plus one) from the
// maps alone, and takes one of two paths for the whole tile:
//   staged  the box, widened to 16-byte columns, fits kStageBytes (the
//           nodes' rectification maps, 360 -> 480 rows and config 5's
//           480 -> 480: 576 to 896 bytes a tile). Each frame's window is
//           copied into shared memory with cp.async in 16-byte chunks,
//           kStages frames in flight (chunks outside the frame fill with
//           zeros, which is BORDER_CONSTANT); the four taps are read from
//           shared memory.
//           It needs W % 16 == 0 and 16-byte aligned frames, so that a
//           chunk lies wholly inside or outside a row;
//   global  anything else (NaN, far out-of-range or scattered
//           coordinates, other widths): the taps are gathered from global
//           memory as before, through the read-only cache, four frames
//           unrolled.
// Both compute the same function; the choice is the tile's, from the
// maps and the frame's width and alignment alone.
//
// What the design before it (a thread an output pixel, a loop over the
// frames gathering four taps from global memory) lost time on: its view
// pointers carried no __restrict__, so each frame's loads waited for the
// store of the frame before (the output might alias the frame), a serial
// chain of load latencies that set its time at config 5's 32 frames.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kViews = 2;
constexpr int kTileW = 64, kTileH = 16;
constexpr int kPerThread = 4;                    // adjacent outputs a thread
constexpr int kThreads = kTileW * kTileH / kPerThread;
constexpr int kStages = 6;                       // frames in flight
constexpr int kStageBytes = 2048;                // a frame's window

struct View {
  const uint8_t* img;   // [F, H, W]
  const float* mapx;    // [Ho, Wo]
  const float* mapy;
  uint8_t* out;         // [F, Ho, Wo]
};

struct Views {
  View v[kViews];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest kStages - 2 groups of this thread's copies are done
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

__device__ __forceinline__ int lerp15(int v00, int v01, int v10, int v11,
                                      int fx, int fy) {
  const int h0 = (v00 * (32768 - fx) + v01 * fx + 16384) >> 15;
  const int h1 = (v10 * (32768 - fx) + v11 * fx + 16384) >> 15;
  return (h0 * (32768 - fy) + h1 * fy + 16384) >> 15;
}

__device__ __forceinline__ int tap(const uint8_t* __restrict__ frame, int y,
                                   int x, int H, int W) {
  return (x >= 0 && x < W && y >= 0 && y < H)
             ? static_cast<int>(__ldg(frame + static_cast<int64_t>(y) * W + x))
             : 0;
}

// the 4 outputs of row oy from column ox of frame f: one 32-bit store
// where all 4 lie in the row and the row width is a multiple of 4
__device__ __forceinline__ void store4(uint8_t* __restrict__ out, int64_t at,
                                       const int (&r)[kPerThread], int n,
                                       bool vec) {
  if (vec && n == kPerThread) {
    *reinterpret_cast<unsigned*>(out + at) =
        static_cast<unsigned>(r[0]) | (static_cast<unsigned>(r[1]) << 8) |
        (static_cast<unsigned>(r[2]) << 16) |
        (static_cast<unsigned>(r[3]) << 24);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (j < n) out[at + j] = static_cast<uint8_t>(r[j]);
  }
}

// at least 4 blocks an SM, 64 registers a thread: unbounded, the compiler
// took 90 and fit 2 blocks, too few to hide the staged loop's latency
// (PERF.md, Findings)
__global__ void __launch_bounds__(kThreads, 4)
remap_kernel(Views views, int F, int H, int W, int Ho, int Wo, bool stage_ok,
             int* paths) {
  __shared__ __align__(16) uint8_t win[kStages][kStageBytes];
  __shared__ int box[4];
  // a select, not an index into the parameters: no copy to local memory
  const View v = blockIdx.y ? views.v[1] : views.v[0];
  const uint8_t* __restrict__ img = v.img;
  uint8_t* __restrict__ out = v.out;
  const int tiles_x = (Wo + kTileW - 1) / kTileW;
  const int oy = (blockIdx.x / tiles_x) * kTileH +
                 threadIdx.x / (kTileW / kPerThread);
  const int ox = (blockIdx.x % tiles_x) * kTileW +
                 (threadIdx.x % (kTileW / kPerThread)) * kPerThread;
  // the thread's outputs in the frame: 0 below the last row, else up to 4
  const int n = oy < Ho ? min(kPerThread, max(Wo - ox, 0)) : 0;
  const int64_t row = static_cast<int64_t>(oy) * Wo + ox;
  int x0[kPerThread], y0[kPerThread], fx[kPerThread], fy[kPerThread];
  int xmin = INT_MAX, xmax = INT_MIN, ymin = INT_MAX, ymax = INT_MIN;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const float mx = j < n ? v.mapx[row + j] : 0.f;
    const float my = j < n ? v.mapy[row + j] : 0.f;
    const int sx = __float2int_rn(__fmul_rn(mx, 32768.f));
    const int sy = __float2int_rn(__fmul_rn(my, 32768.f));
    x0[j] = sx >> 15;
    y0[j] = sy >> 15;
    fx[j] = sx & 0x7fff;
    fy[j] = sy & 0x7fff;
    if (j < n) {
      xmin = min(xmin, x0[j]);
      xmax = max(xmax, x0[j]);
      ymin = min(ymin, y0[j]);
      ymax = max(ymax, y0[j]);
    }
  }
  const int64_t npix = static_cast<int64_t>(Ho) * Wo;
  const int64_t fs = static_cast<int64_t>(H) * W;
  const bool vec = (Wo % kPerThread) == 0;
  bool staged = false;
  int wx0 = 0, wy0 = 0, ws = 0, rows = 0;
  if (stage_ok) {
    if (threadIdx.x == 0) {
      box[0] = INT_MAX;
      box[1] = INT_MIN;
      box[2] = INT_MAX;
      box[3] = INT_MIN;
    }
    __syncthreads();
    xmin = __reduce_min_sync(0xffffffffu, xmin);
    xmax = __reduce_max_sync(0xffffffffu, xmax);
    ymin = __reduce_min_sync(0xffffffffu, ymin);
    ymax = __reduce_max_sync(0xffffffffu, ymax);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&box[0], xmin);
      atomicMax(&box[1], xmax);
      atomicMin(&box[2], ymin);
      atomicMax(&box[3], ymax);
    }
    __syncthreads();
    // columns wx0 .. box[1] + 1 in whole 16-byte chunks, rows box[2] ..
    // box[3] + 1; in 64 bits, since saturated coordinates reach +-2^16
    wx0 = box[0] & ~15;
    wy0 = box[2];
    const int64_t cols = ((static_cast<int64_t>(box[1]) + 2 - wx0) + 15) &
                         ~static_cast<int64_t>(15);
    const int64_t nrows = static_cast<int64_t>(box[3]) + 2 - wy0;
    staged = cols * nrows <= kStageBytes;
    ws = static_cast<int>(cols);
    rows = static_cast<int>(nrows);
  }
  if (paths != nullptr && threadIdx.x == 0)
    atomicAdd(&paths[staged ? 0 : 1], 1);
  if (staged) {
    const int chunks_row = ws / 16, chunks = rows * chunks_row;
    auto stage_frame = [&](int f, int buf) {
      const uint8_t* frame = img + f * fs;
      for (int c = threadIdx.x; c < chunks; c += kThreads) {
        const int r = c / chunks_row, x = wx0 + (c - r * chunks_row) * 16;
        const int y = wy0 + r;
        const bool in = y >= 0 && y < H && x >= 0 && x < W;
        // a chunk outside the frame copies 0 bytes and fills with zeros
        cp_async16(&win[buf][r * ws + (x - wx0)],
                   in ? frame + static_cast<int64_t>(y) * W + x : img,
                   in ? 16 : 0);
      }
    };
    int off[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      off[j] = j < n ? (y0[j] - wy0) * ws + (x0[j] - wx0) : 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < F) stage_frame(s, s);
      cp_async_commit();
    }
    for (int f = 0; f < F; ++f) {
      cp_async_wait_stages();      // frame f's copies, this thread's
      // every thread's, and every thread is done with frame f - 1, whose
      // window frame f + kStages - 1 takes
      __syncthreads();
      const int nf = f + kStages - 1;
      if (nf < F) stage_frame(nf, nf % kStages);
      cp_async_commit();
      const int buf = f % kStages;
      int r[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int o = off[j];
        r[j] = lerp15(win[buf][o], win[buf][o + 1], win[buf][o + ws],
                      win[buf][o + ws + 1], fx[j], fy[j]);
      }
      if (n > 0) store4(out, f * npix + row, r, n, vec);
    }
    return;
  }
  if (n == 0) return;
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const uint8_t* frame = img + f * fs;
    int r[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      r[j] = lerp15(tap(frame, y0[j], x0[j], H, W),
                    tap(frame, y0[j], x0[j] + 1, H, W),
                    tap(frame, y0[j] + 1, x0[j], H, W),
                    tap(frame, y0[j] + 1, x0[j] + 1, H, W), fx[j], fy[j]);
    store4(out, f * npix + row, r, n, vec);
  }
}

}  // namespace

// views sets of (img, mapx, mapy, out), 1 <= views <= kViews; the unused
// ones are null. F frames of H x W a view, maps and outputs Ho x Wo.
// paths (may be null): two counters the launch adds its tiles to, staged
// and global.
extern "C" int remap_bilinear_u8(const uint8_t* img0, const float* mapx0,
                                 const float* mapy0, uint8_t* out0,
                                 const uint8_t* img1, const float* mapx1,
                                 const float* mapy1, uint8_t* out1, int views,
                                 int F, int H, int W, int Ho, int Wo,
                                 int* paths, void* stream) {
  if (views < 1 || views > kViews || F < 0 || H < 1 || W < 1 || Ho < 0 ||
      Wo < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>((Wo + kTileW - 1) / kTileW) *
                        ((Ho + kTileH - 1) / kTileH);
  if (F == 0 || tiles == 0) return static_cast<int>(cudaSuccess);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // staging copies whole 16-byte chunks of a row
  bool stage_ok = W % 16 == 0;
  const uint8_t* imgs[kViews] = {img0, img1};
  for (int i = 0; i < views; ++i)
    stage_ok = stage_ok && reinterpret_cast<uintptr_t>(imgs[i]) % 16 == 0;
  Views vs;
  vs.v[0] = View{img0, mapx0, mapy0, out0};
  vs.v[1] = View{img1, mapx1, mapy1, out1};
  remap_kernel<<<dim3(static_cast<unsigned>(tiles), views), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(vs, F, H, W, Ho, Wo,
                                                      stage_ok, paths);
  return static_cast<int>(cudaGetLastError());
}

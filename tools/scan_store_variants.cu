// Timing variants of kernel P2 and of the fused cloud and scan
// (jackal_tpu_torch/csrc/scan_kernel.cu) that stage the points in shared
// memory and write them with 16-byte stores, where those kernels write each
// point's three floats with scalar stores as they compute them:
//   mode 1: a block's kThreads * kCloudItems points staged, then written
//           after one __syncthreads;
//   mode 2: each warp's 32 points of a round staged, then written by 24 of
//           its lanes (a __syncwarp on either side).
// The outputs are the kernels' own, bit for bit. No path of the port calls
// them: tools/time_support_kernel.py --kernel scan builds this file (with
// the checkout's csrc/ on the include path) and times them beside the
// kernels.

#include "scan_kernel.cu"

namespace {

template <bool kScan, int kMode>
__global__ void __launch_bounds__(kThreads)
cloud_staged_kernel(const uint8_t* __restrict__ dmap,
                    const uint8_t* __restrict__ col,
                    const float* __restrict__ Q, const float* __restrict__ XR,
                    const float* __restrict__ XT, float* __restrict__ pts,
                    int32_t* __restrict__ rgb, uint8_t* __restrict__ valid,
                    unsigned* __restrict__ scratch, float* __restrict__ out,
                    long long sb, long long sy, long long sx, long long sc,
                    int B, int H, int W, int ox, int oy, int min_disp,
                    BinParams p, GroundParams g) {
  constexpr int kChunk = kThreads * kCloudItems;
  extern __shared__ unsigned sh[];
  __shared__ float q[16], R[9], T[3];
  __shared__ __align__(16) float stage[3 * (kMode == 1 ? kChunk : kThreads)];
  load_calib(Q, XR, XT, q, R, T);
  if (kScan) clear_bins(sh, p.bins + kExtrema);
  else __syncthreads();
  const int N = H * W;
  const int set = blockIdx.y;
  const int chunk0 = blockIdx.x * kChunk;
  const int base = chunk0 + threadIdx.x;
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x & ~31;
  int y = base / W, x = base - y * W;
  unsigned ext[kExtrema] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int it = 0; it < kCloudItems; ++it, x += kThreads) {
    while (x >= W) {
      x -= W;
      ++y;
    }
    const int i = base + it * kThreads;
    float xr = 0.0f, yr = 0.0f, zr = 0.0f;
    bool accept = false;
    if (i < N) {
      const size_t at = (size_t)set * N + i;
      const int d = dmap[at];
      robot_point<false>(q, R, T, (float)(x + ox), (float)(y + oy), (float)d,
                         xr, yr, zr);
      int32_t c = 0;
      if (col) {
        const uint8_t* px = col + set * sb + y * sy + x * sx;
        c = ((int32_t)px[2 * sc] << 16) | ((int32_t)px[sc] << 8) |
            (int32_t)px[0];
      }
      float* st = stage + 3 * (kMode == 1 ? i - chunk0 : (int)threadIdx.x);
      st[0] = xr;
      st[1] = yr;
      st[2] = zr;
      rgb[at] = c;
      valid[at] = d >= min_disp;
      accept = kScan && d >= min_disp && !is_ground(xr, zr, g);
    }
    if (kMode == 2) {
      // the warp's 32 points of this round, 24 float4s where whole and
      // aligned
      __syncwarp();
      const int w0 = chunk0 + it * kThreads + warp0;
      const int n = min(32, N - w0);
      float* dst = pts + 3 * ((size_t)set * N + w0);
      const float* src = stage + 3 * warp0;
      if (n == 32 && ((uintptr_t)dst & 15) == 0) {
        if (lane < 24)
          reinterpret_cast<float4*>(dst)[lane] =
              reinterpret_cast<const float4*>(src)[lane];
      } else {
        for (int k = lane; k < 3 * n; k += 32) dst[k] = src[k];
      }
      __syncwarp();
    }
    if (kScan) scan_point(xr, yr, accept, p, sh, ext);
  }
  if (kMode == 1) {
    __syncthreads();
    const int n = min(kChunk, N - chunk0);
    float* dst = pts + 3 * ((size_t)set * N + chunk0);
    if (n == kChunk && ((uintptr_t)dst & 15) == 0) {
      for (int k = threadIdx.x; k < 3 * kChunk / 4; k += kThreads)
        reinterpret_cast<float4*>(dst)[k] =
            reinterpret_cast<const float4*>(stage)[k];
    } else {
      for (int k = threadIdx.x; k < 3 * n; k += kThreads) dst[k] = stage[k];
    }
  }
  if (kScan) {
    const size_t keys = (size_t)set * (p.bins + kExtrema);
    finish_set(sh, ext, p, scratch + keys,
               scratch + (size_t)B * (p.bins + kExtrema) + set, out, B, set);
  }
}

template <bool kScan, int kMode>
void launch_staged(const uint8_t* dmap, const uint8_t* col, const float* Q,
                   const float* XR, const float* XT, float* pts, int32_t* rgb,
                   uint8_t* valid, unsigned* scratch, float* out, long long sb,
                   long long sy, long long sx, long long sc, int B, int H,
                   int W, int ox, int oy, int min_disp, const BinParams& p,
                   const GroundParams& g, cudaStream_t stream) {
  cloud_staged_kernel<kScan, kMode>
      <<<grid_of(B, H * W, kCloudItems), kThreads,
         kScan ? bins_smem(p.bins) : 0, stream>>>(
          dmap, col, Q, XR, XT, pts, rgb, valid, scratch, out, sb, sy, sx, sc,
          B, H, W, ox, oy, min_disp, p, g);
}

}  // namespace

extern "C" {

// P2 (scan 0: scratch and out unused) or cloud_scan (scan 1) with the
// points staged: mode 1 a block's, mode 2 a warp's; the other arguments as
// cloud_scan's
int cloud_staged(int mode, int scan, const uint8_t* dmap, const uint8_t* col,
                 const float* Q, const float* XR, const float* XT, float* pts,
                 int32_t* rgb, uint8_t* valid, unsigned* scratch, float* out,
                 long long sb, long long sy, long long sx, long long sc, int B,
                 int H, int W, int ox, int oy, int min_disp, int bins,
                 float deg, float half, float ratio, float tan_a, float height,
                 float dist, cudaStream_t stream) {
  if ((mode != 1 && mode != 2) || (scan && (bins < 1 || bins > kMaxBins)))
    return (int)cudaErrorInvalidValue;
  const BinParams p{bins, deg, half, ratio};
  const GroundParams g{tan_a, height, dist};
  auto* f = scan ? (mode == 1 ? launch_staged<true, 1> : launch_staged<true, 2>)
                 : (mode == 1 ? launch_staged<false, 1>
                              : launch_staged<false, 2>);
  f(dmap, col, Q, XR, XT, pts, rgb, valid, scratch, out, sb, sy, sx, sc, B, H,
    W, ox, oy, min_disp, p, g, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"

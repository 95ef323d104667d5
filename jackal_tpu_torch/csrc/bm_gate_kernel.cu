// BM's texture gate with the node's u8 map (kernel S).
//
// Replaces no Pallas kernel: the reference package computes it inside its
// jitted programs, as jackal_tpu/matching/bm.py:113 bm_texture_gate (with
// :23 _box_filter) and the node's u8 conversion
// (jackal_tpu/pipeline/frame_pipeline.py:170). The plain PyTorch versions
// are bm_texture_gate_plain and bm_gate_u8_plain in
// jackal_tpu_torch/matching/bm.py, whose wrappers bm_texture_gate and
// bm_gate_u8 launch this kernel.
//
// What it computes. img is the uint8 left frames [N, H, W], dl their
// float32 disparities. The texture of a pixel is the (2r+1)^2 box sum,
// zero outside the frame, of g(y, x) = |L(y, x+1) - L(y, x-1)| on the
// edge-replicated frame; the pixel keeps dl where texture >= thr
// (texture_threshold * window), else -1. The gated map goes to out_f, its
// u8 map clamp(rint(d), 0, 255) (rint: half to even, as torch.round and
// jnp.round) to out_u8, either or both. Every sum fits int32: at most
// 255 * 2901^2 < 2^31 for r <= 1450 (window 2901, the widest BM takes).
// The reference's cumulative sums may wrap in between, but their
// differences are exact mod 2^32, so a direct sum equals them. Integer
// only up to the gate: exact.
//
// What bounds it on an H100: the u8 frame and dl read and the u8 map
// written once, 6 bytes a pixel (58.9 MB at BASELINE config 5, 32 x
// 640x480: 0.0176 ms at 3.35 TB/s); the box costs two adds a pixel and
// row of the window at the least. The design: a block takes 128 columns
// and 16 rows of one frame, a thread a column:
//  (a) it loads its 16 dl values into registers first, so that their
//      latency overlaps the staging, and stages the frame's rows and
//      columns its windows read (16 + 2r rows, 128 + 2r + 2 columns,
//      clipped to the frame) in shared memory where that fits 16 KB
//      (window <= about 51): 4-byte loads where W % 4 == 0 and the
//      frame's address allow (bytes otherwise), eight a thread in flight
//      before any store; wider
//      windows read the frame from device memory where (b) needs it;
//  (b) each column x of the block's window span sums g over the 2r+1 rows
//      of its first output row, then slides down the 16 rows (add the row
//      entering, drop the row leaving), keeping the 16 vertical sums in
//      shared memory;
//  (c) each output column sums the 2r+1 vertical sums of its row, gates
//      its dl value and stores, coalesced.
// Windows wider or taller than the frame clip to it; any window up to 2901
// runs (wide ones slowly: (c) is 2r+1 adds a pixel, clipped to W). Global
// load instructions cost more than the rest here: on an H100 a design that
// staged g (two byte loads each) instead of the frame was 20-30 % slower
// than the first design, which staged the frame a byte a load behind an
// integer division and loaded dl a row at a time in (c) (PERF.md,
// Findings).
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;        // output columns a block (one a thread)
constexpr int kRows = 16;         // output rows a block
constexpr int kTileMax = 16384;   // staged frame bytes a block at most
constexpr int kRMax = 1450;       // the widest window, 2901

constexpr int kBatch = 8;         // staging loads a thread in flight

// g(y, x) = |L(y, x+1) - L(y, x-1)| on the edge-replicated frame, row y
// of the frame (or of the staged tile, whose column 0 is frame column
// c0) at column x
__device__ __forceinline__ int grad(const uint8_t* row, int c0, int x,
                                    int W) {
  return abs(static_cast<int>(row[min(x + 1, W - 1) - c0]) -
             static_cast<int>(row[max(x - 1, 0) - c0]));
}

// the tile: frame rows [ya, ya + th), columns [ca, ca + tw), kBatch loads
// a thread issued before their stores; T is uint32_t (W % 4 == 0, ca and
// tw multiples of 4) or uint8_t
template <typename T>
__device__ __forceinline__ void stage(const uint8_t* __restrict__ frame,
                                      uint8_t* tile, int ya, int th, int ca,
                                      int tw, int W) {
  const int per_row = tw / static_cast<int>(sizeof(T));
  const int n = th * per_row;
  T* dst = reinterpret_cast<T*>(tile);
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kCols) {
    T w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kCols;
      if (i < n) {
        const int y = i / per_row;
        const T* src = reinterpret_cast<const T*>(
            frame + static_cast<size_t>(ya + y) * W + ca);
        w[j] = __ldg(src + (i - y * per_row));
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (i0 + j * kCols < n) dst[i0 + j * kCols] = w[j];
  }
}

template <bool kStaged, bool kWords>
__global__ void __launch_bounds__(kCols)
    bm_gate_kernel(const uint8_t* __restrict__ img,
                   const float* __restrict__ dl, float* __restrict__ out_f,
                   uint8_t* __restrict__ out_u8, int H, int W, int r,
                   int thr, int pitch) {
  extern __shared__ int smem[];
  int* V = smem;                                         // [kRows][pitch]
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem + kRows * pitch);
  const int u0 = blockIdx.x * kCols, v0 = blockIdx.y * kRows;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t base = blockIdx.z * plane;
  const uint8_t* frame = img + base;
  const int rows = min(kRows, H - v0);
  const int u = u0 + static_cast<int>(threadIdx.x);
  // the window span: columns [xa, xb), rows [ya, yb)
  const int xa = max(u0 - r, 0), xb = min(u0 + kCols + r, W);
  const int ya = max(v0 - r, 0), yb = min(v0 + rows - 1 + r, H - 1) + 1;
  // (a) the column's dl values, then the frame the span reads
  float d[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    d[k] = (u < W && k < rows)
               ? __ldg(dl + base + static_cast<size_t>(v0 + k) * W + u)
               : 0.0f;
  int ca = 0, tw = W;
  if (kStaged) {
    ca = max(xa - 1, 0);
    int cb = min(xb + 1, W);
    if (kWords) {
      ca &= ~3;
      cb = (cb + 3) & ~3;                  // <= W: W % 4 == 0
    }
    tw = cb - ca;
    if (kWords)
      stage<uint32_t>(frame, tile, ya, yb - ya, ca, tw, W);
    else
      stage<uint8_t>(frame, tile, ya, yb - ya, ca, tw, W);
    __syncthreads();
  }
  auto g = [&](int y, int x) {
    return kStaged ? grad(tile + (y - ya) * tw, ca, x, W)
                   : grad(frame + static_cast<size_t>(y) * W, 0, x, W);
  };
  // (b) vertical sums of g over each output row's 2r+1 rows
  for (int x = xa + static_cast<int>(threadIdx.x); x < xb; x += kCols) {
    int acc = 0;
    for (int y = ya, ye = min(v0 + r, H - 1); y <= ye; ++y) acc += g(y, x);
    for (int k = 0; k < rows; ++k) {
      V[k * pitch + (x - xa)] = acc;
      if (k + 1 == rows) break;
      const int v = v0 + k;
      if (v + 1 + r < H) acc += g(v + 1 + r, x);
      if (v - r >= 0) acc -= g(v - r, x);
    }
  }
  __syncthreads();
  // (c) horizontal sums, the gate, the stores
  if (u >= W) return;
  const int lo = max(u - r, 0) - xa, hi = min(u + r, W - 1) - xa;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k >= rows) break;
    const int* row = V + k * pitch;
    int tex = 0;
    for (int x = lo; x <= hi; ++x) tex += row[x];
    const size_t i = base + static_cast<size_t>(v0 + k) * W + u;
    const float dk = tex >= thr ? d[k] : -1.0f;
    if (out_f != nullptr) out_f[i] = dk;
    if (out_u8 != nullptr)
      out_u8[i] = static_cast<uint8_t>(
          static_cast<int>(fminf(fmaxf(rintf(dk), 0.0f), 255.0f)));
  }
}

template <bool kStaged, bool kWords>
int launch(const uint8_t* img, const float* dl, float* out_f,
           uint8_t* out_u8, int N, int H, int W, int r, int thr, int pitch,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bm_gate_kernel<kStaged, kWords>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + kCols - 1) / kCols, (H + kRows - 1) / kRows, N);
  bm_gate_kernel<kStaged, kWords><<<grid, kCols, smem, stream>>>(
      img, dl, out_f, out_u8, H, W, r, thr, pitch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S: the gated float map (out_f) and / or its u8 map (out_u8) of N frames;
// r = window / 2, thr = texture_threshold * window.
extern "C" int bm_gate(const uint8_t* img, const float* dl, float* out_f,
                       uint8_t* out_u8, int N, int H, int W, int r, int thr,
                       void* stream) {
  if (N < 1 || H < 1 || W < 1 || N > 65535 || r < 0 || r > kRMax ||
      (H + kRows - 1) / kRows > 65535 ||
      (out_f == nullptr && out_u8 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int span = std::min(W, kCols + 2 * r);
  const int pitch = span | 1;         // odd: the rows fall on other banks
  // the staged columns: the span, a column each side, and up to 3 more
  // each side where the tile is loaded as words
  const size_t tile =
      static_cast<size_t>(std::min(H, kRows + 2 * r)) * (span + 8);
  const size_t v_bytes = static_cast<size_t>(kRows) * pitch * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile > kTileMax)
    return launch<false, false>(img, dl, out_f, out_u8, N, H, W, r, thr,
                                pitch, v_bytes, s);
  if (W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 4 == 0)
    return launch<true, true>(img, dl, out_f, out_u8, N, H, W, r, thr,
                              pitch, v_bytes + tile, s);
  return launch<true, false>(img, dl, out_f, out_u8, N, H, W, r, thr, pitch,
                             v_bytes + tile, s);
}

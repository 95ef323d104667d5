// ELAS prior slab raster: per pixel, the winner key of the last-painted
// triangle that covers it.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/raster_kernel.py
// (_raster_kernel l.59, wrapper raster_pallas l.137). The plain PyTorch
// version of the same function is raster_plain in
// matching/elas/device_prior.py (_slab_products_impl + _slab_raster_impl).
//
// What it computes. The image is cut into tiles of 16 rows x 128 columns
// (S x C tiles). sel[f, tile, :] lists the frame-local rows of the
// triangle table that can touch the tile, padded with the degenerate row
// Tp-1. Table row t (pack_table): corners A_u <= B_u <= C_u, rows A_v, B_v,
// the float32 bits of the edge slopes AC, AB, BC and of the plane
// coefficients pa, pb, pc, pvalid and paint (-1 for padding). For a
// pixel (u, v) of the tile and a triangle with paint >= 0:
//   b_x  = A_v - s_x * A_u   (x = AC, AB; BC uses B_v, B_u)
//   v1   = (uint32) trunc(s_ac * u + b_ac)
//   v2   = (uint32) trunc(u < B_u ? s_ab * u + b_ab : s_bc * u + b_bc)
//   lo   = min(v1, v2, H), hi = min(max(v1, v2), H)
//   covered: A_u <= u < C_u and lo <= v < hi
//   f    = (pa * u + pb * v) + pc,  dt = clamp(trunc(f), -512, 511)
//   key  = (paint << 11) | ((dt + 512) << 1) | pvalid
// and win[f, v, u] is the maximum key over the tile's triangles, -1 where
// none covers the pixel. trunc() is float -> int32 toward zero with XLA's
// saturation (NaN -> 0), as ops/convert.to_int32; the casts to uint32 make
// negative scanline bounds wrap, as the reference's cast chain does
// (elas.cpp:878-879). Every multiply, add and subtract is written as
// __fmul_rn / __fadd_rn / __fsub_rn so that nvcc fuses none of them into
// an FFMA: the reference rounds each one on its own.
//
// What bounds it on an H100. Per frame the work is one key per (pixel,
// triangle slot of its tile): at 640x480 a few tens of live slots per tile
// give ~1e7 keys of ~12 float and integer operations each, against 1.2 MB
// of output and well under 1 MB of input, so the bound is set by
// operations, and it is small. The design: one block of 128 threads per
// (frame, 16-row band, 128-column tile), one thread per column. The block
// stages the tile's live triangle rows in shared memory (compacted, so the
// pad slots cost nothing), then each thread computes a triangle's
// column-only terms once (the scanline bounds and pa*u) and walks its 16
// rows with two adds per row, keeping the 16 running maxima in registers.
// The TPU kernel swept 16-triangle chunks with a live-count skip over a
// VMEM-resident output block; here the maximum never leaves registers.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlab = 16;    // rows of a tile (device_prior._RASTER_SLAB)
constexpr int kCTile = 128;  // columns of a tile (device_prior._RASTER_CTILE)
constexpr int kCols = 16;    // int32 words of a table row
constexpr int kRow = 13;     // words of a table row the raster reads

__device__ __forceinline__ int sat_i32(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return __float2int_rz(x);
}

__device__ __forceinline__ unsigned line_u32(float s, float u, float b) {
  return static_cast<unsigned>(sat_i32(__fadd_rn(__fmul_rn(s, u), b)));
}

__global__ void __launch_bounds__(kCTile)
raster_kernel(const int32_t* __restrict__ table,
              const int32_t* __restrict__ sel, int32_t* __restrict__ win,
              int Tp, int S, int C, int Ts, int W, int H) {
  __shared__ int32_t rows[kCTile][kRow];
  __shared__ int n_live;

  const int c = blockIdx.x, s = blockIdx.y, f = blockIdx.z;
  const int tid = threadIdx.x;
  const int u = c * kCTile + tid;
  const int v0 = s * kSlab;
  const float u_f = static_cast<float>(u);
  const int32_t* tile_sel =
      sel + ((static_cast<size_t>(f) * S + s) * C + c) * Ts;
  const int32_t* frame_tab = table + static_cast<size_t>(f) * Tp * kCols;

  int acc[kSlab];
#pragma unroll
  for (int r = 0; r < kSlab; ++r) acc[r] = -1;

  for (int j0 = 0; j0 < Ts; j0 += kCTile) {
    if (tid == 0) n_live = 0;
    __syncthreads();
    const int j = j0 + tid;
    if (j < Ts) {
      const int t = tile_sel[j];
      if (t >= 0 && t < Tp - 1) {
        const int32_t* src = frame_tab + static_cast<size_t>(t) * kCols;
        if (src[12] >= 0) {             // paint -1: a padding row
          const int slot = atomicAdd(&n_live, 1);
#pragma unroll
          for (int k = 0; k < kRow; ++k) rows[slot][k] = src[k];
        }
      }
    }
    __syncthreads();
    const int n = n_live;
    for (int i = 0; i < n && u < W; ++i) {
      const int32_t* e = rows[i];
      const int A_u = e[0], B_u = e[1], C_u = e[2];
      if (u < A_u || u >= C_u) continue;       // outside the column span
      const float A_u_f = static_cast<float>(A_u);
      const float A_v_f = static_cast<float>(e[3]);
      const float B_u_f = static_cast<float>(B_u);
      const float B_v_f = static_cast<float>(e[4]);
      const float s_ac = __int_as_float(e[5]);
      const float s_ab = __int_as_float(e[6]);
      const float s_bc = __int_as_float(e[7]);
      const float pa = __int_as_float(e[8]);
      const float pb = __int_as_float(e[9]);
      const float pc = __int_as_float(e[10]);
      const unsigned v1 =
          line_u32(s_ac, u_f, __fsub_rn(A_v_f, __fmul_rn(s_ac, A_u_f)));
      const unsigned v2 = u < B_u
          ? line_u32(s_ab, u_f, __fsub_rn(A_v_f, __fmul_rn(s_ab, A_u_f)))
          : line_u32(s_bc, u_f, __fsub_rn(B_v_f, __fmul_rn(s_bc, B_u_f)));
      const unsigned Hu = static_cast<unsigned>(H);
      const int lo = static_cast<int>(min(min(v1, v2), Hu));
      const int hi = static_cast<int>(min(max(v1, v2), Hu));
      if (hi <= v0 || lo >= v0 + kSlab) continue;
      const int base = (e[12] << 11) | e[11];
      const float au = __fmul_rn(pa, u_f);
#pragma unroll
      for (int r = 0; r < kSlab; ++r) {
        const int v = v0 + r;
        if (v >= lo && v < hi) {
          const float fv = __fadd_rn(
              __fadd_rn(au, __fmul_rn(pb, static_cast<float>(v))), pc);
          const int dt = min(max(sat_i32(fv), -512), 511);
          acc[r] = max(acc[r], base | ((dt + 512) << 1));
        }
      }
    }
    __syncthreads();
  }

  if (u < W) {
#pragma unroll
    for (int r = 0; r < kSlab; ++r) {
      const int v = v0 + r;
      if (v < H) win[(static_cast<size_t>(f) * H + v) * W + u] = acc[r];
    }
  }
}

}  // namespace

extern "C" int raster_win(const int32_t* table, const int32_t* sel,
                          int32_t* win, int CH, int Tp, int S, int C, int Ts,
                          int W, int H, void* stream) {
  const dim3 blocks(C, S, CH);
  raster_kernel<<<blocks, kCTile, 0, static_cast<cudaStream_t>(stream)>>>(
      table, sel, win, Tp, S, C, Ts, W, H);
  return static_cast<int>(cudaGetLastError());
}

// ELAS prior slab raster: per pixel, the plane of the last-painted
// triangle that covers it, decoded into the dense matcher's prior maps.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/raster_kernel.py
// (_raster_kernel l.59, wrapper raster_pallas l.137) and the decode that
// follows it in the same jitted program (decode_win l.162). The plain
// PyTorch version of the same function is raster_maps_plain in
// matching/elas/device_prior.py: decode_win of raster_plain
// (_slab_products_impl + _slab_raster_impl), a side at a time.
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
// none covers the pixel. The kernel stores it decoded, as the dense
// matcher reads it: covered = win >= 0, d_plane = ((win >> 1) & 1023) - 512
// (int16, 0 where not covered) and valid = covered && (win & 1), 4 bytes a
// pixel. One launch takes both sides of a chunk (grid z = sides * CH, the
// side's table and tile lists chosen by z), as the reference's one jitted
// raster program takes both. trunc() is float -> int32 toward zero with XLA's
// saturation (NaN -> 0), as ops/convert.to_int32; the casts to uint32 make
// negative scanline bounds wrap, as the reference's cast chain does
// (elas.cpp:878-879). Every multiply, add and subtract is written as
// __fmul_rn / __fadd_rn / __fsub_rn so that nvcc fuses none of them into
// an FFMA: the reference rounds each one on its own.
//
// What bounds it on an H100. The output, 4 bytes a pixel a side (19.7 MB
// for both sides of 8 frames at 640x480), and well under 4 MB of tables
// and tile lists: about 0.007 ms at 3.35 TB/s. The operations are what this run's triangles need:
// per live tile slot its three intercepts; per column of the tile inside
// its span the two scanline bounds and pa * u (f32 multiplies and adds,
// two float -> int conversions); per pixel it covers the plane value's two
// adds, one conversion, the clamp, the key and the maximum
// (chip_smoke.raster_work counts them by type: f32 at 128, integer at 64,
// conversions at 16 a clock an SM).
//
// With one thread a column of the tile, every thread walking every live
// triangle and its 16 rows, a triangle that spans 20 of the tile's 128
// columns steps all four warps through it, and most of the time goes to
// columns outside the span and rows outside the triangle. So the design
// spreads the work over live (slot, column in span) pairs:
//  - a block of 4 warps takes a (frame, 16-row band, 128-column tile) and
//    keeps its 16 x 128 int32 keys in shared memory (8 KB), -1 at first;
//  - the tile's slot list is read 128 slots a round; a slot is live if it
//    names a row of the frame other than the pad row and that row's paint
//    is >= 0. The live slots are compacted by a warp ballot and a prefix
//    sum of the 4 warps' counts; the thread of a slot loads its row with
//    four 16-byte loads (the paint among them, so the tile list and the
//    row are the only dependent loads) and computes its three intercepts
//    once;
//  - warp w takes the round's live slots w, w + 4, ...: its lanes take the
//    columns of the slot's span inside the tile (32, 16 or 8 at a time, in
//    1, 2 or 4 groups of rows, as the span is wide), compute the column's
//    scanline bounds, and walk only the rows of their group the triangle
//    covers (a triangle covers about a fifth of the (column, row) cells of
//    its span in the band), each key going into the tile by a shared
//    atomicMax. The maximum of keys does not depend on the order,
//    so the result is exact;
//  - the block ends with one coalesced store of the tile's three maps.
// What still holds it above the bound: the instructions it runs. A warp walks, for
// each of its slots, the longest covered row range of its lanes, while
// the rows a column covers vary along the span; the staging and the store
// take the smaller part, the shared atomics no measurable time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlab = 16;    // rows of a tile (device_prior._RASTER_SLAB)
constexpr int kCTile = 128;  // columns of a tile (device_prior._RASTER_CTILE)
constexpr int kCols = 16;    // int32 words of a table row
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// A live slot's terms, computed once by the thread that stages it.
struct Tri {
  int A_u, B_u, C_u, base;   // base = paint << 11 | pvalid
  float s_ac, s_ab, s_bc, b_ac, b_ab, b_bc, pa, pb, pc;
};

// float -> int32 toward zero with XLA's saturation: cvt.rzi.s32.f32 clamps
// to the int32 range and converts NaN to 0 (PTX ISA, cvt)
__device__ __forceinline__ int sat_i32(float x) { return __float2int_rz(x); }

__device__ __forceinline__ unsigned line_u32(float s, float u, float b) {
  return static_cast<unsigned>(sat_i32(__fadd_rn(__fmul_rn(s, u), b)));
}

// The terms of table row a, b, c, d (its four 16-byte quarters: a = A_u
// B_u C_u A_v, b = B_v s_ac s_ab s_bc, c = pa pb pc pvalid, d = paint ...)
__device__ __forceinline__ Tri terms(const int4& a, const int4& b,
                                     const int4& c, const int4& d) {
  const float A_u_f = static_cast<float>(a.x);
  const float A_v_f = static_cast<float>(a.w);
  const float B_u_f = static_cast<float>(a.y);
  const float B_v_f = static_cast<float>(b.x);
  Tri t;
  t.A_u = a.x;
  t.B_u = a.y;
  t.C_u = a.z;
  t.base = (d.x << 11) | c.w;
  t.s_ac = __int_as_float(b.y);
  t.s_ab = __int_as_float(b.z);
  t.s_bc = __int_as_float(b.w);
  t.b_ac = __fsub_rn(A_v_f, __fmul_rn(t.s_ac, A_u_f));
  t.b_ab = __fsub_rn(A_v_f, __fmul_rn(t.s_ab, A_u_f));
  t.b_bc = __fsub_rn(B_v_f, __fmul_rn(t.s_bc, B_u_f));
  t.pa = __int_as_float(c.x);
  t.pb = __int_as_float(c.y);
  t.pc = __int_as_float(c.z);
  return t;
}

// One warp rasters one live slot into the tile's keys: its lanes take
// 32 / k columns of the span at a time and k groups of 16 / k rows, k = 1,
// 2 or 4 as the span inside the tile is wider than 16 columns, than 8, or
// not, so that narrow triangles keep the lanes busy.
__device__ __forceinline__ void raster_tri(const Tri& e, int (*keys)[kCTile],
                                           int c0, int v0, int W, int H,
                                           int lane) {
  const int ub = max(e.A_u, c0);
  const int ue = min(min(e.C_u, c0 + kCTile), W);
  const int lg = ue - ub > 16 ? 0 : ue - ub > 8 ? 1 : 2;   // log2 k
  const int cols = 32 >> lg, rows = kSlab >> lg;
  const int g0 = (lane >> (5 - lg)) * rows;   // the lane's first band row
  const unsigned Hu = static_cast<unsigned>(H);
  for (int u = ub + (lane & (cols - 1)); u < ue; u += cols) {
    const float u_f = static_cast<float>(u);
    const unsigned v1 = line_u32(e.s_ac, u_f, e.b_ac);
    const bool ab = u < e.B_u;           // the AB or the BC segment
    const unsigned v2 = line_u32(ab ? e.s_ab : e.s_bc, u_f,
                                 ab ? e.b_ab : e.b_bc);
    const int lo = static_cast<int>(min(min(v1, v2), Hu));
    const int hi = static_cast<int>(min(max(v1, v2), Hu));
    const int r0 = max(lo - v0, g0), r1 = min(hi - v0, g0 + rows);
    const float au = __fmul_rn(e.pa, u_f);
    int* col = &keys[0][u - c0];
    float vf = static_cast<float>(v0 + r0);   // exact: v < 2^24
    for (int r = r0; r < r1; ++r, vf = __fadd_rn(vf, 1.0f)) {
      const float fv = __fadd_rn(__fadd_rn(au, __fmul_rn(e.pb, vf)), e.pc);
      const int dt = min(max(sat_i32(fv), -512), 511);
      atomicMax(col + r * kCTile, e.base | ((dt + 512) << 1));
    }
  }
}

// The two sides' inputs: side i's table [CH * Tp, 16] and tile lists
// [CH, S * C, Ts]
struct Sides {
  const int32_t* table[2];
  const int32_t* sel[2];
};

__global__ void __launch_bounds__(kThreads)
raster_kernel(Sides in, int16_t* __restrict__ d_plane,
              uint8_t* __restrict__ valid, uint8_t* __restrict__ covered,
              int CH, int Tp, int S, int C, int Ts, int W, int H) {
  __shared__ int keys[kSlab][kCTile];
  __shared__ Tri tris[kThreads];
  __shared__ int warp_live[kWarps];

  const int c = blockIdx.x, s = blockIdx.y, z = blockIdx.z;
  const int side = z >= CH, f = z - side * CH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c * kCTile, v0 = s * kSlab;
  const int32_t* tile_sel =
      in.sel[side] + ((static_cast<size_t>(f) * S + s) * C + c) * Ts;
  const int32_t* frame_tab =
      in.table[side] + static_cast<size_t>(f) * Tp * kCols;

#pragma unroll
  for (int r = 0; r < kSlab; ++r) keys[r][tid] = -1;

  for (int j0 = 0; j0 < Ts; j0 += kThreads) {
    // compact the round's live slots: ballot, then the warps' prefix sum
    const int j = j0 + tid;
    const int t = j < Ts ? __ldg(tile_sel + j) : -1;
    int4 q[4] = {};
    if (t >= 0 && t < Tp - 1) {
      const int4* src = reinterpret_cast<const int4*>(
          frame_tab + static_cast<size_t>(t) * kCols);
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = __ldg(src + k);
    }
    const bool live = t >= 0 && t < Tp - 1 && q[3].x >= 0;
    const unsigned ballot = __ballot_sync(kFull, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int n = 0, before = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_live[w] : 0;
      n += warp_live[w];
    }
    if (live)
      tris[before + __popc(ballot & ((1u << lane) - 1u))] =
          terms(q[0], q[1], q[2], q[3]);
    __syncthreads();
    for (int i = warp; i < n; i += kWarps)
      raster_tri(tris[i], keys, c0, v0, W, H, lane);
    __syncthreads();   // before the next round reuses tris and warp_live
  }
  __syncthreads();     // Ts = 0: the keys' -1 before the store

  const int u = c0 + tid;
  if (u < W) {
#pragma unroll
    for (int r = 0; r < kSlab; ++r) {
      const int v = v0 + r;
      if (v >= H) continue;
      const size_t o = (static_cast<size_t>(z) * H + v) * W + u;
      const int k = keys[r][tid];
      const bool cov = k >= 0;
      d_plane[o] = static_cast<int16_t>(cov ? ((k >> 1) & 1023) - 512 : 0);
      valid[o] = cov && (k & 1);
      covered[o] = cov;
    }
  }
}

}  // namespace

// sides (1 or 2) x CH frames: side i from table_i and sel_i; the maps
// [sides * CH, H, W], side 0's frames first.
extern "C" int raster_maps(const int32_t* table0, const int32_t* sel0,
                           const int32_t* table1, const int32_t* sel1,
                           int16_t* d_plane, uint8_t* valid,
                           uint8_t* covered, int sides, int CH, int Tp, int S,
                           int C, int Ts, int W, int H, void* stream) {
  if (sides < 1 || sides > 2 || static_cast<int64_t>(sides) * CH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sides in{{table0, sides > 1 ? table1 : table0},
                 {sel0, sides > 1 ? sel1 : sel0}};
  const dim3 blocks(C, S, sides * CH);
  raster_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, d_plane, valid, covered, CH, Tp, S, C, Ts, W, H);
  return static_cast<int>(cudaGetLastError());
}

// Kernels M1 and M2: the batched ELAS prior's coefficient table and
// candidate grids, read straight from one chunk's flat int16 wire, for
// Hopper (sm_90a).
//
// Replace the part of the reference's one jitted chunk program that runs
// before the raster (jackal_tpu/matching/elas/pipeline.py:488 coeffs, in
// _raster_chunk), which has no Pallas call:
//   M1 coeff_table  jackal_tpu/matching/elas/device_prior.py:522
//                   _tri_coeffs_impl with device_fit.py:126
//                   _fit_planes_impl (:71 _gj_solve3), packed as the
//                   port's device_prior.pack_table; it also widens both
//                   sides' int16 tile lists to the int32 lists the raster
//                   (kernel C) reads;
//   M2 grid_words   jackal_tpu/matching/elas/device_prior.py:579
//                   _grid_impl (createGrid, elas.cpp:579-659), packed as
//                   the port's device_prior.pack_grid_device.
// Their plain versions are coeff_table_plain and grid_words_plain in
// matching/elas/device_prior.py; its wrapper coeff_grid launches both in
// one kernel, coeff_grid_kernel, on a CUDA wire (M2's blocks first, then
// M1's: M2's output does not depend on M1's, and both read the same wire).
//
// The wire (int16, pipeline._flatten_chunk_wire): support [CH, Np, 3]
// (u, v, d; pad rows (0, 0, -1)); per side the triangles [CH, Tp, 3]
// (frame-local vertex indices; pad rows (0, 0, 0)) and paints [CH, Tp]
// (pad -1); per side the tile lists [CH, S*C, Ts].
//
// M1, two lanes a table row, both sides in one launch (row r >= CH*Tp is
// the right side's). Lanes 2i and 2i + 1 take row i; lane s solves plane
// s of the triangle's unsorted corners (0 the left plane, 1 the right: u - d
// for u), a 3x3 full-pivot Gauss-Jordan solve in float64 whose every
// product, difference and quotient is rounded on its own (__dmul_rn,
// __dsub_rn, __ddiv_rn), in the plain version's order; so the only DFMA
// and FFMA of this library are those inside the divisions (chip_smoke.py
// compares their count with a build at -fmad=false). The pivot is the
// first maximal |A[i][j]| of the trailing submatrix in i-major order; below
// 1e-20 the solve is singular and gives +0 thrice. Only b and the trailing
// columns are computed: no other entry feeds them. The lane whose plane is
// the row's side gets the other plane's a by a shuffle, forms pvalid and
// writes the row's plane, pvalid and paint (two 16-byte stores); the other
// lane writes the three corners (u - d on the right side) after the
// reference's pairwise swaps (elas.cpp:847-854; not a stable sort on ties)
// and the three edge slopes, IEEE float32 quotients of integer differences
// (__fdiv_rn; +0 where du = 0) (two 16-byte stores). A row's two solves,
// its serial float64 chain, run side by side. The blocks past the rows
// widen the tile lists, 8 entries a thread by one 16-byte load and two
// 16-byte stores where the side's list starts 16-byte aligned in the wire,
// by scalar entries otherwise.
//
// M2, a block a (frame and side, tile of kTileWords / nw grid cells): an
// output cell c in [gw + 1, G - gw - 1) is the OR, over the flat 3x3
// neighbourhood c + {-gw-1, -gw, -gw+1, -1, 0, 1, gw-1, gw, gw+1} (it wraps
// across grid rows, as the reference's loop does), of each source cell's
// marks dilated by d -+ 1. Every step is an OR and dilation distributes
// over it, so c's words are the OR of the bits d-1, d, d+1 (those in
// [0, D)) of every support point whose cell lies in that neighbourhood.
// The block scans its frame's Np points and ORs those bits into its
// tile's words in shared memory (atomicOr); cells outside the range stay
// 0, and every word of the grid is written, so the output needs no fill.
// Shared memory is the tile's own words whatever gw is, so one path takes
// every grid. The cell of a point is floor((u - d) / gs) on the right side
// and floor(v / gs), floor division as the reference's //.
//
// What bounds them: M1 its float64 operations (60 a row, a DMUL, DSUB or
// DDIV counted as one); its bytes are the wire once and 64 a row out. M2
// its bytes: the support triples in, the grid words out
// (chip_smoke.prior_work). Alone, each is one launch's latency at the
// batched node's chunk (M2 96 blocks at 59 times its bound), so they share
// one launch. Built with -DPRIOR_KERNEL_PARTS (the build variant
// prior_kernel_parts) the library also has prior_coeff_grid_parts, which
// launches M1's blocks or M2's alone, to time them apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSelItems = 8;        // tile-list entries a thread widens
constexpr int kTileWords = 1024;    // grid words a block of M2 owns
constexpr double kEps = 1e-20;      // the solve's singularity gate

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <typename T>
__device__ __forceinline__ void swap_if(bool c, T& a, T& b) {
  const T x = a, y = b;
  a = c ? y : x;
  b = c ? x : y;
}

// x = A^-1 b: the reference's full-pivot Gauss-Jordan (matrix.cpp:414-502,
// the port's device_fit._gj_solve3), every index static so that A stays
// in registers. out gets the float32 roundings of x, or +0 thrice when a
// pivot is below kEps.
__device__ __forceinline__ void gj_solve3(double A[3][3], double b[3],
                                          float out[3]) {
  int col[3] = {0, 1, 2};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    double best = -1.0;
    int pr = k, pc = k;
#pragma unroll
    for (int i = k; i < 3; ++i) {
#pragma unroll
      for (int j = k; j < 3; ++j) {
        const double m = fabs(A[i][j]);
        if (m > best) {
          best = m;
          pr = i;
          pc = j;
        }
      }
    }
    if (!(best >= kEps)) {
      out[0] = out[1] = out[2] = 0.0f;
      return;
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) swap_if(pr == i, A[k][j], A[i][j]);
      swap_if(pr == i, b[k], b[i]);
    }
#pragma unroll
    for (int j = k + 1; j < 3; ++j) {
#pragma unroll
      for (int i = 0; i < 3; ++i) swap_if(pc == j, A[i][k], A[i][j]);
      swap_if(pc == j, col[k], col[j]);
    }
    const double piv = A[k][k];
#pragma unroll
    for (int j = k + 1; j < 3; ++j) A[k][j] = __ddiv_rn(A[k][j], piv);
    b[k] = __ddiv_rn(b[k], piv);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i == k) continue;
      const double f = A[i][k];
#pragma unroll
      for (int j = k + 1; j < 3; ++j)
        A[i][j] = __dsub_rn(A[i][j], __dmul_rn(f, A[k][j]));
      b[i] = __dsub_rn(b[i], __dmul_rn(f, b[k]));
    }
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const double x = col[0] == m ? b[0] : (col[1] == m ? b[1] : b[2]);
    out[m] = __double2float_rn(x);
  }
}

__device__ __forceinline__ float slope(int dv, int du) {
  return du != 0 ? __fdiv_rn(__int2float_rn(dv), __int2float_rn(du)) : 0.0f;
}

// M1's block b: two lanes a table row, or past row_blocks the tile lists
__device__ __forceinline__ void coeff_table_block(
    const int16_t* __restrict__ wire, int4* __restrict__ table,
    int32_t* __restrict__ sel0, int32_t* __restrict__ sel1, int CH, int Np,
    int Tp, int nsel, int row_blocks, int b) {
  const long long K = static_cast<long long>(CH) * Tp;
  const long long tri_at = static_cast<long long>(CH) * Np * 3;
  if (b >= row_blocks) {
    // the tile lists: int16 [2, CH, S*C, Ts] after the triangles -> int32,
    // a thread kSelItems entries of one side
    const long long per_side = (nsel + kSelItems - 1) / kSelItems;
    const long long c =
        static_cast<long long>(b - row_blocks) * kThreads + threadIdx.x;
    if (c >= 2 * per_side) return;
    const int side = c >= per_side ? 1 : 0;
    const long long i0 = (c - side * per_side) * kSelItems;
    const int16_t* src = wire + tri_at + 8 * K + side * nsel + i0;
    int32_t* dst = (side ? sel1 : sel0) + i0;
    const int n = static_cast<int>(min(static_cast<long long>(kSelItems),
                                       nsel - i0));
    if (n == kSelItems && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int4 w = *reinterpret_cast<const int4*>(src);
      // each int32 word holds two int16 entries, the lower one first
      const int lo[4] = {w.x, w.y, w.z, w.w};
      int v[kSelItems];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = static_cast<int16_t>(lo[k] & 0xffff);
        v[2 * k + 1] = lo[k] >> 16;
      }
      int4* o = reinterpret_cast<int4*>(dst);
      o[0] = make_int4(v[0], v[1], v[2], v[3]);
      o[1] = make_int4(v[4], v[5], v[6], v[7]);
    } else {
      for (int k = 0; k < n; ++k) dst[k] = src[k];
    }
    return;
  }
  // every lane reaches the shuffle below: a lane past the table repeats
  // the last row and writes nothing
  const long long t = static_cast<long long>(b) * kThreads + threadIdx.x;
  const int s = threadIdx.x & 1;          // the plane this lane solves
  const bool live = (t >> 1) < 2 * K;
  const long long r = live ? t >> 1 : 2 * K - 1;
  const bool right = r >= K;
  const long long rr = right ? r - K : r;
  const long long f = rr / Tp;
  const long long side_at = tri_at + (right ? 4 * K : 0);
  const int16_t* tri = wire + side_at + 3 * rr;
  const int16_t* sp = wire + 3 * f * Np;

  int u[3], v[3], d[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int16_t* p = sp + 3 * static_cast<int>(tri[j]);
    u[j] = p[0];
    v[j] = p[1];
    d[j] = p[2];
  }
  double A[3][3], rhs[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    // u - d is exact in int32 and in float64
    A[j][0] = static_cast<double>(s ? u[j] - d[j] : u[j]);
    A[j][1] = static_cast<double>(v[j]);
    A[j][2] = 1.0;
    rhs[j] = static_cast<double>(d[j]);
  }
  float pl[3];
  gj_solve3(A, rhs, pl);
  const float other = __shfl_xor_sync(0xffffffffu, pl[0], 1);
  if (!live) return;
  int4* row = table + 4 * r;
  if (s == (right ? 1 : 0)) {
    // this side's plane, and the other side's a
    const int pvalid = fabsf(pl[0]) < 0.7f && fabsf(other) < 0.7f;
    row[2] = make_int4(__float_as_int(pl[0]), __float_as_int(pl[1]),
                       __float_as_int(pl[2]), pvalid);
    row[3] = make_int4(wire[side_at + 3 * K + rr], 0, 0, 0);
    return;
  }
  int tu[3], tv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    tu[j] = right ? u[j] - d[j] : u[j];
    tv[j] = v[j];
  }
  // (j, k) = (1, 0), (2, 0), (2, 1): swap when corner k lies right of j
  {
    bool sw = tu[0] > tu[1];
    swap_if(sw, tu[0], tu[1]);
    swap_if(sw, tv[0], tv[1]);
    sw = tu[0] > tu[2];
    swap_if(sw, tu[0], tu[2]);
    swap_if(sw, tv[0], tv[2]);
    sw = tu[1] > tu[2];
    swap_if(sw, tu[1], tu[2]);
    swap_if(sw, tv[1], tv[2]);
  }
  const float ac = slope(tv[0] - tv[2], tu[0] - tu[2]);
  const float ab = slope(tv[0] - tv[1], tu[0] - tu[1]);
  const float bc = slope(tv[1] - tv[2], tu[1] - tu[2]);
  row[0] = make_int4(tu[0], tu[1], tu[2], tv[0]);
  row[1] = make_int4(tv[1], __float_as_int(ac), __float_as_int(ab),
                     __float_as_int(bc));
}

// M2's block of frame and side fs, cell tile ct; words: [tile][nw] shared
__device__ __forceinline__ void grid_words_block(
    const int16_t* __restrict__ wire, uint32_t* __restrict__ out,
    uint32_t* words, int CH, int Np, int gs, int gh, int gw, int D, int nw,
    int tile, int fs, int ct) {
  const bool right = fs >= CH;
  const int f = right ? fs - CH : fs;
  const int G = gh * gw;
  const int c0 = ct * tile;
  const int n = min(tile, G - c0);
  const int16_t* sp = wire + 3LL * f * Np;
  for (int i = threadIdx.x; i < n * nw; i += kThreads) words[i] = 0u;
  __syncthreads();
  const int lo = max(c0, gw + 1), hi = min(c0 + n, G - gw - 1);
  if (lo < hi) {
    const int offs[9] = {-gw - 1, -gw, -gw + 1, -1, 0, 1,
                         gw - 1, gw, gw + 1};
    for (int p = threadIdx.x; p < Np; p += kThreads) {
      const int u = sp[3 * p], v = sp[3 * p + 1], d = sp[3 * p + 2];
      if (d < 0 || d >= D) continue;
      const int x = floor_div(right ? u - d : u, gs), y = floor_div(v, gs);
      if (x < 0 || x >= gw || y < 0 || y >= gh) continue;
      const int s = y * gw + x;
      if (s + gw + 1 < lo || s - gw - 1 >= hi) continue;
      // the bits d-1, d, d+1 that lie in [0, D), in one word or two
      const int dl = max(d - 1, 0), dh = min(d + 1, D - 1);
      const int w0 = dl >> 5, w1 = dh >> 5;
      uint32_t m0, m1 = 0u;
      if (w0 == w1) {
        m0 = ((1u << (dh - dl + 1)) - 1u) << (dl & 31);
      } else {
        m0 = 0xffffffffu << (dl & 31);
        m1 = (2u << (dh & 31)) - 1u;
      }
#pragma unroll
      for (int o = 0; o < 9; ++o) {
        const int c = s + offs[o];
        if (c < lo || c >= hi) continue;
        uint32_t* w = words + (c - c0) * nw;
        atomicOr(w + w0, m0);
        if (m1) atomicOr(w + w1, m1);
      }
    }
  }
  __syncthreads();
  uint32_t* o = out + (static_cast<long long>(fs) * G + c0) * nw;
  for (int i = threadIdx.x; i < n * nw; i += kThreads) o[i] = words[i];
}

// M1 and M2 in one launch: blocks [0, grid_blocks) are M2's, a (frame
// and side, cell tile) each, cell tile fastest; the rest M1's (table rows,
// then tile lists). M2's blocks come first: each scans a frame-side's
// points, the longest walk of the launch.
__global__ void __launch_bounds__(kThreads)
coeff_grid_kernel(const int16_t* __restrict__ wire, int4* __restrict__ table,
                  int32_t* __restrict__ sel0, int32_t* __restrict__ sel1,
                  uint32_t* __restrict__ out, int CH, int Np, int Tp,
                  int nsel, int row_blocks, int gs, int gh, int gw, int D,
                  int nw, int tile, int tiles, int grid_blocks) {
  extern __shared__ uint32_t words[];                   // [tile][nw]
  const int b = static_cast<int>(blockIdx.x);
  if (b < grid_blocks)
    grid_words_block(wire, out, words, CH, Np, gs, gh, gw, D, nw, tile,
                     b / tiles, b % tiles);
  else
    coeff_table_block(wire, table, sel0, sel1, CH, Np, Tp, nsel, row_blocks,
                      b - grid_blocks);
}

}  // namespace

// M1's blocks (m1) and M2's (m2) of one launch on a chunk's wire
static int launch_parts(const int16_t* wire, int32_t* table, int32_t* sel0,
                        int32_t* sel1, int32_t* out, int CH, int Np, int Tp,
                        long long nsel, int gs, int gh, int gw, int D,
                        bool m1, bool m2, cudaStream_t stream) {
  const int nw = (D + 31) / 32;
  const long long rows = 2LL * CH * Tp;
  const long long row_blocks = (2 * rows + kThreads - 1) / kThreads;
  const long long per_side = (nsel + kSelItems - 1) / kSelItems;
  const long long sel_blocks = (2 * per_side + kThreads - 1) / kThreads;
  if (CH < 1 || CH > 32767 || Np < 1 || Tp < 1 || nsel < 0 ||
      nsel > 0x3fffffffLL || gs < 1 || gh < 1 || gw < 1 || D < 1 ||
      nw > kTileWords || static_cast<long long>(gh) * gw > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = gh * gw;
  const int tile = kTileWords / nw;
  const long long tiles = (G + tile - 1) / tile;
  const long long n1 = m1 ? row_blocks + sel_blocks : 0;
  const long long n2 = m2 ? 2LL * CH * tiles : 0;
  if (n1 + n2 > 0x7fffffffLL || n1 + n2 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tile * nw * sizeof(uint32_t);
  coeff_grid_kernel<<<static_cast<unsigned>(n1 + n2), kThreads, smem,
                      stream>>>(
      wire, reinterpret_cast<int4*>(table), sel0, sel1,
      reinterpret_cast<uint32_t*>(out), CH, Np, Tp, static_cast<int>(nsel),
      static_cast<int>(row_blocks), gs, gh, gw, D, nw, tile,
      static_cast<int>(tiles), static_cast<int>(n2));
  return static_cast<int>(cudaGetLastError());
}

// One launch of M1 and M2 on a chunk's wire. table: int32 [2*CH*Tp, 16]
// (16-byte aligned; the left side's rows, then the right side's); sel0,
// sel1: int32 [CH, S*C, Ts] each (16-byte aligned), nsel = CH*S*C*Ts
// entries; out: int32 [2*CH, gh, gw, nw], nw = ceil(D / 32): frames
// 0..CH-1 the left grids, CH..2CH-1 the right ones.
extern "C" int prior_coeff_grid(const int16_t* wire, int32_t* table,
                                int32_t* sel0, int32_t* sel1, int32_t* out,
                                int CH, int Np, int Tp, long long nsel,
                                int gs, int gh, int gw, int D,
                                void* stream) {
  return launch_parts(wire, table, sel0, sel1, out, CH, Np, Tp, nsel, gs, gh,
                      gw, D, true, true, static_cast<cudaStream_t>(stream));
}

#ifdef PRIOR_KERNEL_PARTS
// The same launch with only M1's blocks (parts 1: the table and tile
// lists) or only M2's (parts 2: the grid words); parts 3 is the launch.
extern "C" int prior_coeff_grid_parts(const int16_t* wire, int32_t* table,
                                      int32_t* sel0, int32_t* sel1,
                                      int32_t* out, int CH, int Np, int Tp,
                                      long long nsel, int gs, int gh, int gw,
                                      int D, int parts, void* stream) {
  return launch_parts(wire, table, sel0, sel1, out, CH, Np, Tp, nsel, gs, gh,
                      gw, D, parts & 1, parts & 2,
                      static_cast<cudaStream_t>(stream));
}
#endif

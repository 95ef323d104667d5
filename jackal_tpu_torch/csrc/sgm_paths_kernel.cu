// SGM path aggregation: the 8-path (or 4-path) recurrence and its sum.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/sgm_kernel.py
// (_sgm_dir_kernel l.64, pallas_call in sgm_paths_dir_pallas l.207, driven
// by aggregate_paths_pallas_bhdw l.285). The plain PyTorch version of the
// same function is aggregate_paths in jackal_tpu_torch/matching/sgm.py;
// the wrapper is ops/sgm_kernel.aggregate_paths_bhdw.
//
// What it computes. cost is int16 [B, H, W, DP] (d innermost, padded with
// BIG to DP, a multiple of 64: the wrapper lays out the reference's
// [B, H, D, W] so). Along each path direction r,
//   L(p, d) = min(C(p, d) + min(L(q, d), L(q, d+-1) + P1, m + P2) - m, BIG)
// with q = p - r, m = min_d' L(q, d'), BIG = 28000, the missing d-1 / d+1
// neighbour a plain BIG, and L(q, .) = BIG where q lies outside the image
// (the first row of a pass, and the reference's edge reset of the
// diagonal carries). With an all-BIG carry the step gives min(C, BIG),
// which is the reference's first row, so every path starts the same way.
// S(p, d) is the sum of the 8 (or 4) paths, clamped to BIG, written as
// int16 [B, H, D, W], the reference's layout.
//
// Why one clamp at the end equals the reference's grouped clamps. The
// reference clamps to BIG after the down group, after adding the up group,
// after each horizontal pass and after the total. Every path value is >= 0
// (costs are >= 0: census costs are <= 24 or the 12000 sentinel): best >=
// m because every candidate of the minimum is >= m (prev >= m, m + P2 >= m,
// and a neighbour + P1 >= m, as P1, P2 >= 0 and the BIG cap is >= every
// carry). For a, b >= 0, min(min(a, BIG) + b, BIG) = min(a + b, BIG): if
// a >= BIG both sides are BIG, else they are the same expression. So any
// grouping, and any order, of clamped partial sums gives min(total, BIG),
// and this kernel sums the paths once, in int32, and clamps once.
//
// What bounds it on an H100. The least work is one read of the int16 cost
// and one write of S: 4 bytes a cell, 78.6 MB for a 640x480 frame at D =
// 64 (0.0235 ms at 3.35 TB/s). The operations: per cell, d and path the
// carry's minimum into m, the two neighbours + P1, the minimum with the
// carry and with m + P2, C + best - m with its clamp, and the add into the
// sum; on 16-bit lanes, two a 32-bit instruction, with Hopper's DPX forms
// min(a + b, c) and min(a, b, c) fusing two operations each, at least 3.25
// instructions (chip_smoke.sgm_work), 0.0306 ms for that frame at 8 paths
// at the card's 64 instructions a clock an SM.
//
// The design, against the three limits of one warp a line, one launch a
// direction:
//  - layout: sgm_pad_transpose_kernel lays the cost out as [B, H, W, DP]
//    (d innermost, BIG past D) through shared-memory tiles, so that a step
//    of any path reads its cell's DP costs as one coalesced run;
//  - occupancy: every direction of the call runs in one launch (a warp a
//    (direction, frame, line): 6716 warps at 640x480 with 8 paths, the
//    long lines first), so the card is full at B = 1. Directions that run
//    together cannot share one running sum without atomics, so each
//    writes its own int16 path volume (the values are <= BIG), and a
//    third kernel, sgm_sum_kernel, adds the 8 (or 4) in int32, clamps
//    once and writes S in [B, H, D, W] through a shared-memory transpose;
//  - latency: a warp keeps a ring of kRing steps of its line's costs in
//    registers, loaded kRing steps ahead, so a step waits on its own
//    arithmetic alone: one __reduce_min_sync, a shuffle up and one down,
//    and the DPX chain;
//  - operations: the lanes split d, K = DP / 32 consecutive values a lane,
//    as K / 2 pairs of 16-bit lanes in 32-bit words. Where BIG + max(P1,
//    P2) <= 32767 every value of the step fits an unsigned 16-bit lane
//    (C + best - m <= 32767 + P2 < 65536), and the step is __viaddmin_u16x2
//    (the neighbours + P1 against the carry), __vminu2 (against m + P2),
//    __vsub2 and __viaddmin_u16x2 (C + best - m against BIG) a pair.
//    Larger penalties take the 32-bit path (the same walk, one value a
//    register, int32 arithmetic), as the plain version's int32 does.
// D > 256 (DP > 256): K = DP / 32 values a lane would spill the ring's
// registers, so the launcher takes a second, simple line kernel there,
// sgm_lines_wide_kernel (below): the carry in shared memory, d strided
// over the lanes, int32 at every penalty; the layout and sum kernels are
// the same. D <= 256 keeps the register kernels.
// Bytes: the layout pass (2 + 2 bytes a cell), the 8 paths' cost reads
// (16, partly from L2: the volume is 39 MB at 640x480), their path volumes
// written (16) and read back (16), S (2): about 52 bytes a cell, where the
// least is 4. Keeping every path of a cell on chip needs a wavefront over
// the image; not tried.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 28000;
constexpr int kWarps = 4;    // lines a block
constexpr int kRing = 8;     // steps loaded ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kBig2 = (kBig << 16) | kBig;

// (dv, du) of the 8 directions; the first 4 are the 4-path set. Horizontal
// first: the longest lines start first.
#define SGM_DIRS                                                 \
  {{0, 1}, {0, -1}, {1, 0}, {-1, 0}, {1, 1}, {1, -1}, {-1, 1}, {-1, -1}}
__constant__ int kDirs[8][2] = SGM_DIRS;
constexpr int kHostDirs[8][2] = SGM_DIRS;

struct Work {
  int n_dirs;
  int start[9];  // first warp of each direction, start[n_dirs] = total
};

// K int16 values a lane, as K / 2 words
template <int K>
struct Vec {
  uint32_t w[K / 2];
};

// 16 bytes a load where K allows, else 8 or 4 (a lane's values start at a
// multiple of 2K bytes)
template <int K>
__device__ __forceinline__ Vec<K> load_vec(const int16_t* p) {
  Vec<K> v;
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int q = 0; q < K / 8; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[q];
      v.w[4 * q] = x.x;
      v.w[4 * q + 1] = x.y;
      v.w[4 * q + 2] = x.z;
      v.w[4 * q + 3] = x.w;
    }
  } else if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[q];
      v.w[2 * q] = x.x;
      v.w[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < K / 2; ++q)
      v.w[q] = reinterpret_cast<const uint32_t*>(p)[q];
  }
  return v;
}

template <int K>
__device__ __forceinline__ void store_vec(int16_t* p, const Vec<K>& v) {
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int q = 0; q < K / 8; ++q)
      reinterpret_cast<uint4*>(p)[q] =
          make_uint4(v.w[4 * q], v.w[4 * q + 1], v.w[4 * q + 2],
                     v.w[4 * q + 3]);
  } else if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      reinterpret_cast<uint2*>(p)[q] = make_uint2(v.w[2 * q], v.w[2 * q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < K / 2; ++q)
      reinterpret_cast<uint32_t*>(p)[q] = v.w[q];
  }
}

__device__ __forceinline__ int lo16(uint32_t w) { return w & 0xffffu; }
__device__ __forceinline__ int hi16(uint32_t w) { return w >> 16; }

// One step on 16-bit lanes: prev is the carry, c the cost; returns L.
template <int K>
__device__ __forceinline__ Vec<K> step16(const Vec<K>& prev, const Vec<K>& c,
                                         int lane, uint32_t p1x2, int p2) {
  constexpr int KW = K / 2;
  uint32_t mw = prev.w[0];
#pragma unroll
  for (int j = 1; j < KW; ++j) mw = __vminu2(mw, prev.w[j]);
  const int m = __reduce_min_sync(kFull, min(lo16(mw), hi16(mw)));
  uint32_t below = __shfl_up_sync(kFull, prev.w[KW - 1], 1);
  uint32_t above = __shfl_down_sync(kFull, prev.w[0], 1);
  if (lane == 0) below = kBig2;
  if (lane == 31) above = kBig2;
  const uint32_t m2 = __byte_perm(m, m, 0x1010);
  const uint32_t mp2 = __byte_perm(m + p2, m + p2, 0x1010);
  Vec<K> out;
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    // the d-1 and d+1 neighbours of the pair (d, d+1)
    const uint32_t up = __byte_perm(j == 0 ? below : prev.w[j - 1],
                                    prev.w[j], 0x5432);
    const uint32_t dn = __byte_perm(prev.w[j],
                                    j == KW - 1 ? above : prev.w[j + 1],
                                    0x5432);
    uint32_t best = __viaddmin_u16x2(up, p1x2, prev.w[j]);
    best = __viaddmin_u16x2(dn, p1x2, best);
    best = __vminu2(best, mp2);
    out.w[j] = __viaddmin_u16x2(c.w[j], __vsub2(best, m2), kBig2);
  }
  return out;
}

// One step in int32, for penalties past the 16-bit lanes.
template <int K>
__device__ __forceinline__ Vec<K> step32(const Vec<K>& prev, const Vec<K>& c,
                                         int lane, int p1, int p2) {
  int pv[K], cv[K];
#pragma unroll
  for (int j = 0; j < K / 2; ++j) {
    pv[2 * j] = lo16(prev.w[j]);
    pv[2 * j + 1] = hi16(prev.w[j]);
    cv[2 * j] = static_cast<int16_t>(lo16(c.w[j]));
    cv[2 * j + 1] = static_cast<int16_t>(hi16(c.w[j]));
  }
  int mloc = pv[0];
#pragma unroll
  for (int j = 1; j < K; ++j) mloc = min(mloc, pv[j]);
  const int m = __reduce_min_sync(kFull, mloc);
  int lo = __shfl_up_sync(kFull, pv[K - 1], 1);
  int hi = __shfl_down_sync(kFull, pv[0], 1);
  if (lane == 0) lo = kBig;
  if (lane == 31) hi = kBig;
  Vec<K> out;
#pragma unroll
  for (int j = 0; j < K; j += 2) {
    int o[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int up = j + i == 0 ? lo : pv[j + i - 1];
      const int dn = j + i == K - 1 ? hi : pv[j + i + 1];
      const int best = min(min(pv[j + i], m + p2), min(up, dn) + p1);
      o[i] = min(cv[j + i] + best - m, kBig);
    }
    out.w[j / 2] = (static_cast<uint32_t>(o[1]) << 16) |
                   static_cast<uint32_t>(o[0]);
  }
  return out;
}

// The line a warp walks: its direction k, its length, and the offsets
// (in cells of DP values) of its first cell and of a step.
struct Line {
  int k, len;
  long long first, step;
};

__device__ __forceinline__ Line line_of(int warp, const Work& work, int H,
                                        int W, int DP) {
  int k = 0;
  while (warp >= work.start[k + 1]) ++k;
  const int dv = kDirs[k][0], du = kDirs[k][1];
  const int n_lines = dv == 0 ? H : (du == 0 ? W : H + W - 1);
  const int idx = warp - work.start[k];
  const int b = idx / n_lines, i = idx % n_lines;
  // the line's first cell: on the edge the direction enters from
  int v, u;
  if (dv == 0) {
    v = i;
    u = du > 0 ? 0 : W - 1;
  } else if (du == 0 || i < W) {
    u = i;
    v = dv > 0 ? 0 : H - 1;
  } else {
    v = dv > 0 ? i - W + 1 : H - 1 - (i - W + 1);
    u = du > 0 ? 0 : W - 1;
  }
  const int len_v = dv > 0 ? H - v : (dv < 0 ? v + 1 : INT_MAX);
  const int len_u = du > 0 ? W - u : (du < 0 ? u + 1 : INT_MAX);
  Line ln;
  ln.k = k;
  ln.len = min(len_v, len_u);
  ln.step = (static_cast<long long>(dv) * W + du) * DP;
  ln.first = ((static_cast<long long>(b) * H + v) * W + u) * DP;
  return ln;
}

template <int K, bool WIDE>
__global__ void __launch_bounds__(kWarps * 32)
    sgm_lines_kernel(const int16_t* __restrict__ cost,
                     int16_t* __restrict__ paths, int B, int H, int W,
                     int DP, int p1, int p2, Work work) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= work.start[work.n_dirs]) return;  // the whole warp leaves
  const Line ln = line_of(warp, work, H, W, DP);
  const int len = ln.len;
  const long long step = ln.step;
  const long long first = ln.first + lane * K;
  const int16_t* cl = cost + first;
  int16_t* out = paths + static_cast<long long>(ln.k) * B * H * W * DP + first;
  const uint32_t p1x2 = WIDE ? 0u : __byte_perm(p1, p1, 0x1010);

  Vec<K> ring[kRing];
#pragma unroll
  for (int r = 0; r < kRing; ++r)
    if (r < len) ring[r] = load_vec<K>(cl + r * step);
  Vec<K> prev;
#pragma unroll
  for (int j = 0; j < K / 2; ++j) prev.w[j] = kBig2;
  for (int t0 = 0; t0 < len; t0 += kRing) {
#pragma unroll
    for (int r = 0; r < kRing; ++r) {
      const int t = t0 + r;
      if (t >= len) break;
      const Vec<K> c = ring[r];
      if (t + kRing < len) ring[r] = load_vec<K>(cl + (t + kRing) * step);
      prev = WIDE ? step32<K>(prev, c, lane, p1, p2)
                  : step16<K>(prev, c, lane, p1x2, p2);
      store_vec<K>(out + t * step, prev);
    }
  }
}

// The D > 256 path (DP > 256): one warp a line as above, the lanes taking
// d = lane, lane + 32, ..., the carry in shared memory (two int32 rows of
// DP + 2 a warp, the previous step's and this one's, BIG at both ends for
// the missing d - 1 / d + 1 neighbours), int32 arithmetic at every
// penalty. A step: the carry's minimum m over all d (a lane's strided
// minimum, then __reduce_min_sync), then each d's value, stored to the
// path volume and into the other row; __syncwarp before the rows swap.
__global__ void __launch_bounds__(kWarps * 32)
    sgm_lines_wide_kernel(const int16_t* __restrict__ cost,
                          int16_t* __restrict__ paths, int B, int H, int W,
                          int DP, int p1, int p2, Work work, int wpb) {
  extern __shared__ int carry[];  // [wpb][2][DP + 2]
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp = blockIdx.x * wpb + wib;
  if (wib >= wpb || warp >= work.start[work.n_dirs]) return;
  const Line ln = line_of(warp, work, H, W, DP);
  const int16_t* cl = cost + ln.first;
  int16_t* out =
      paths + static_cast<long long>(ln.k) * B * H * W * DP + ln.first;
  int* prev = carry + wib * 2 * (DP + 2);
  int* next = prev + DP + 2;
  for (int d = lane; d < DP + 2; d += 32) prev[d] = next[d] = kBig;
  __syncwarp();
  for (int t = 0; t < ln.len; ++t) {
    const int16_t* c = cl + t * ln.step;
    int16_t* o = out + t * ln.step;
    int mloc = kBig;
    for (int d = lane; d < DP; d += 32) mloc = min(mloc, prev[d + 1]);
    const int m = __reduce_min_sync(kFull, mloc);
    for (int d = lane; d < DP; d += 32) {
      const int best = min(min(prev[d + 1], m + p2),
                           min(prev[d], prev[d + 2]) + p1);
      const int val = min(c[d] + (best - m), kBig);
      next[d + 1] = val;
      o[d] = static_cast<int16_t>(val);
    }
    __syncwarp();
    int* tmp = prev;
    prev = next;
    next = tmp;
  }
}

constexpr int kTileU = 64, kTileD = 64;

// The walk's layout of the cost: [B, H, D, W] -> [B, H, W, DP], BIG past D.
// A block a (frame, row, 64 columns, 64 disparities), read along u and
// written along d through shared memory.
__global__ void __launch_bounds__(256)
    sgm_pad_transpose_kernel(const int16_t* __restrict__ cost,
                             int16_t* __restrict__ out, int H, int W, int D,
                             int DP) {
  __shared__ int16_t tile[kTileD][kTileU + 2];
  const int tiles_u = (W + kTileU - 1) / kTileU;
  const int row = blockIdx.x / tiles_u;  // b * H + v
  const int u0 = (blockIdx.x % tiles_u) * kTileU;
  const int d0 = blockIdx.y * kTileD;
  for (int e = threadIdx.x; e < kTileU * kTileD; e += blockDim.x) {
    const int dd = e / kTileU, uu = e % kTileU;
    const int d = d0 + dd, u = u0 + uu;
    tile[dd][uu] = d < D && u < W
                       ? cost[(static_cast<long long>(row) * D + d) * W + u]
                       : static_cast<int16_t>(kBig);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTileU * kTileD; e += blockDim.x) {
    const int uu = e / kTileD, dd = e % kTileD;
    const int u = u0 + uu;
    if (u < W)
      out[(static_cast<long long>(row) * W + u) * DP + d0 + dd] = tile[dd][uu];
  }
}

// S[b, v, d, u] = min(sum_k paths[k, b, v, u, d], BIG) for d < D: a block
// a (frame, row, 64 columns, 64 disparities), read along d, written along
// u through shared memory.
__global__ void __launch_bounds__(256)
    sgm_sum_kernel(const int16_t* __restrict__ paths,
                   int16_t* __restrict__ S, int B, int H, int W, int D,
                   int DP, int n_paths) {
  __shared__ int16_t tile[kTileD][kTileU + 2];
  const int tiles_u = (W + kTileU - 1) / kTileU;
  const int row = blockIdx.x / tiles_u;  // b * H + v
  const int u0 = (blockIdx.x % tiles_u) * kTileU;
  const int d0 = blockIdx.y * kTileD;
  const long long vol = static_cast<long long>(B) * H * W * DP;
  // 64 columns x 64 d as 8-value vectors: 512 vectors, 2 a thread
  for (int e = threadIdx.x; e < kTileU * kTileD / 8; e += blockDim.x) {
    const int uu = e / (kTileD / 8), dd = (e % (kTileD / 8)) * 8;
    const int u = u0 + uu;
    if (u >= W) continue;
    const long long o = (static_cast<long long>(row) * W + u) * DP + d0 + dd;
    int s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < n_paths; ++k) {
      const uint4 x = *reinterpret_cast<const uint4*>(paths + k * vol + o);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[2 * q] += lo16(w[q]);
        s[2 * q + 1] += hi16(w[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      tile[dd + q][uu] = static_cast<int16_t>(min(s[q], kBig));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTileU * kTileD; e += blockDim.x) {
    const int dd = e / kTileU, uu = e % kTileU;
    const int d = d0 + dd, u = u0 + uu;
    if (d < D && u < W)
      S[(static_cast<long long>(row) * D + d) * W + u] = tile[dd][uu];
  }
}

template <int K, bool WIDE>
cudaError_t launch_lines(const int16_t* cost, int16_t* paths, int B, int H,
                         int W, int DP, int p1, int p2, const Work& work,
                         cudaStream_t s) {
  const int blocks = (work.start[work.n_dirs] + kWarps - 1) / kWarps;
  sgm_lines_kernel<K, WIDE><<<blocks, kWarps * 32, 0, s>>>(
      cost, paths, B, H, W, DP, p1, p2, work);
  return cudaGetLastError();
}

constexpr int kSmemMax = 232448;   // a block's shared memory

// The D > 256 path's launch: as many warps a block (at most kWarps) as
// their carries fit in shared memory.
cudaError_t launch_wide(const int16_t* cost, int16_t* paths, int B, int H,
                        int W, int DP, int p1, int p2, const Work& work,
                        cudaStream_t s) {
  const int per_warp = 2 * (DP + 2) * static_cast<int>(sizeof(int));
  const int wpb = min(kWarps, kSmemMax / per_warp);
  if (wpb < 1) return cudaErrorInvalidValue;
  const int smem = wpb * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgm_lines_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (work.start[work.n_dirs] + wpb - 1) / wpb;
  sgm_lines_wide_kernel<<<blocks, kWarps * 32, smem, s>>>(
      cost, paths, B, H, W, DP, p1, p2, work, wpb);
  return cudaGetLastError();
}

template <bool WIDE>
cudaError_t launch_k(const int16_t* cost, int16_t* paths, int B, int H,
                     int W, int DP, int p1, int p2, const Work& work,
                     cudaStream_t s) {
  switch (DP / 32) {
    case 2: return launch_lines<2, WIDE>(cost, paths, B, H, W, DP, p1, p2, work, s);
    case 4: return launch_lines<4, WIDE>(cost, paths, B, H, W, DP, p1, p2, work, s);
    case 6: return launch_lines<6, WIDE>(cost, paths, B, H, W, DP, p1, p2, work, s);
    case 8: return launch_lines<8, WIDE>(cost, paths, B, H, W, DP, p1, p2, work, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The padded D of the cost and path volumes the wrapper allocates.
static int sgm_padded_d(int D) { return (D + 63) / 64 * 64; }

// One aggregation of the int16 cost [B, H, D, W] into S [B, H, D, W]:
// the cost laid out as [B, H, W, DP] into ``padded``, the lines of every
// direction in one launch, each into its own path volume of ``paths``
// (num_paths x [B, H, W, DP] int16), then their sum. DP is D rounded up to
// a multiple of 64; num_paths is 8 or 4.
extern "C" int sgm_paths(const int16_t* cost, int16_t* padded,
                         int16_t* paths, int16_t* S, int B, int H, int W,
                         int D, int p1, int p2, int num_paths, void* stream) {
  const int DP = sgm_padded_d(D);
  if (B < 1 || H < 1 || W < 1 || D < 2 || p1 < 0 || p2 < 0 ||
      p1 > INT_MAX - kBig || p2 > INT_MAX - kBig ||
      (num_paths != 8 && num_paths != 4) ||
      static_cast<long long>(B) * H * ((W + kTileU - 1) / kTileU) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Work work;
  work.n_dirs = num_paths;
  long long total = 0;
  for (int k = 0; k < num_paths; ++k) {
    work.start[k] = static_cast<int>(total);
    const int dv = kHostDirs[k][0], du = kHostDirs[k][1];
    total += static_cast<long long>(B) *
             (dv == 0 ? H : (du == 0 ? W : H + W - 1));
    if (total > INT_MAX / 32) return static_cast<int>(cudaErrorInvalidValue);
  }
  work.start[num_paths] = static_cast<int>(total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tiles(B * H * ((W + kTileU - 1) / kTileU), DP / kTileD);
  sgm_pad_transpose_kernel<<<tiles, 256, 0, s>>>(cost, padded, H, W, D, DP);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool wide = p1 > 32767 - kBig || p2 > 32767 - kBig;
  if (DP > 256)
    e = launch_wide(padded, paths, B, H, W, DP, p1, p2, work, s);
  else
    e = wide ? launch_k<true>(padded, paths, B, H, W, DP, p1, p2, work, s)
             : launch_k<false>(padded, paths, B, H, W, DP, p1, p2, work, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  sgm_sum_kernel<<<tiles, 256, 0, s>>>(paths, S, B, H, W, D, DP, num_paths);
  return static_cast<int>(cudaGetLastError());
}

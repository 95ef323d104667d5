// BM with its disparity axis split over ranks (TP BM): a rank's SAD box and
// partial WTA over its disparity range (kernel T1), and a data row's
// combine of the ranks' partials with the L/R check (kernel T2).
//
// Replaces no Pallas kernel: the reference package runs TP BM as one jitted
// program under shard_map, jackal_tpu/parallel/mesh.py:118 _bm_tp_shard
// (T1's part: the rank's cost slice and the local halves of the keyed
// pmins) and :81 _tp_wta (T2's part: the pmins' combine, uniqueness and
// the parabola), followed by the L/R check of bm_finalize
// (jackal_tpu/matching/bm.py). The plain PyTorch versions of the same
// functions are tp_partials_plain and tp_combine_plain in
// jackal_tpu_torch/ops/bm_tp_kernel.py, whose wrappers tp_partials and
// tp_combine launch these kernels; parallel/mesh.bm_match_tp calls them on
// the card, then kernel S (csrc/bm_gate_kernel.cu) for the texture gate.
//
// What T1 computes. L, R are a rank's uint8 frames [B, H, W]; the rank
// scores d in [d0, d0 + Dl) of D. cost_L(u, d) is the (2r+1)^2 box sum,
// zero outside the frame, of |L(y, x) - R(y, x - d)| (R reads 0 for x < d),
// and 1 << 24 where u < d; the right view's cost_R(u, d) = cost_L(u + d, d),
// 1 << 24 where u + d >= W. Per view and pixel it writes nine int32
// partials (NF, the order of kField below), each cost clamped to 1 << 24:
//   key    min over the range of min(c, kclamp) * D + d (ties: the smaller
//          d), kclamp = min(1 << 24, 2^30 / D - 1) as _invalid_cost;
//   best   the cost at that d, q;
//   cm, cp the costs at q - 1 and q + 1 where they lie in the range, else
//          1 << 24;
//   second the least cost in the range outside q - 1 .. q + 1;
//   first, last  the costs at d0 and d0 + Dl - 1;
//   xfirst, xlast  the least cost in the range without d0, and without
//          d0 + Dl - 1 (1 << 24 where that leaves nothing).
// The reference's masked pmins always meet 1 << 24 from a d they do not
// keep, so every cost they combine is clamped to it, as here. partials is
// int32 [2 views, NF, B, H, W].
//
// What T2 computes. The ranks' partials [K, 2, NF, B, H, W], rank k holding
// [k Dl, (k + 1) Dl). Per pixel and view: the least key wins (keys are
// distinct across ranks), q = key % D; best from the winning rank; cm from
// it where q - 1 lies in its range, else the last cost of the rank below
// (1 << 24 at q = 0); cp likewise from the first cost of the rank above
// (1 << 24 where no rank scores q + 1: the D % K top disparities no rank
// holds read the sentinel, as in the reference); second the least of the
// winner's second and, for each other rank, its least cost outside q +- 1:
// its xlast where q - 1 is its last d, its xfirst where q + 1 is its first,
// else the least of first and xfirst. That is every one of _tp_wta's five
// pmins, bit for bit: a rank other than the winner loses at most one end d
// to q +- 1. Then as _tp_wta: unique = f32(best) < f32(uniqueness) *
// f32(second) (the product rounded to f32), offs = f32(cm - cp) /
// (2 f32(cm + cp - 2 best)) (IEEE division) where 0 < q < D - 1 and the
// denominator is > 0, disparity q + offs, -1 where not unique. Then the
// L/R check of the left view as matching/sgm._lr_tail: uw = clip(trunc(
// f32(u) - dL), 0, W - 1), s = clip(u - uw, 0, D), keep dL where dL >= 0,
// dR(u - s) >= 0 and |dR(u - s) - dL| <= lr_threshold. dl (checked) and
// dr are float32 [B, H, W]. The texture gate, kernel S, runs after: gate
// and check only write -1 and the check reads dL at its own pixel, so
// their order does not change the maps.
//
// What bounds them on an H100. T1: per (pixel, scored d) G's integer count,
// 5.75 instructions (the cost's two running box sums and two minima a
// view, chip_smoke.bm_work); its bytes are the frames in and 72 bytes of
// partials a pixel out. T2: bytes, the partials its combine reads (every
// rank's key and about two more fields a rank, of 9, a pixel and view:
// chip_smoke.tp_combine_reads) and the two float maps out. The design, simple first: T1 runs
// three kernels a frame through a scratch of two int32 [H, W, Dl] volumes
// (Dl innermost) that the wrapper allocates: tp_vsum_kernel, a thread a
// (column, d) walking down a chunk of rows with the running vertical sum of
// the AD; tp_hsum_kernel, a thread a (row, d) walking along a chunk of
// columns with the running horizontal sum, the box cost; tp_partials_kernel,
// a thread a (pixel, view) walking its Dl costs twice (the least key, then
// the minima outside q +- 1) in a tile of the row staged in shared memory.
// On an H100, for D = 64 on 2 ranks at 640x480, T1 took 0.53 ms with that
// thread reading its costs from device memory (a warp's loads of one d
// 4 Dl bytes apart) and 0.68 ms with a warp a pixel (PERF.md). Every D >= 2 with Dl >= 1 and every window up
// to 2901 (r <= 1450: the box sums fit int32) takes the same path: no
// shared memory, so no shape passes a block's budget. T2: a block a (frame,
// row); its threads combine both views of the row into shared memory
// (2 W floats), then apply the L/R check from the row of dR held there.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 24;        // bm_match's invalid cost
constexpr int kNF = 9;               // partials a pixel and view
constexpr int kBoxRMax = 1450;       // (2r + 1)^2 * 255 < 2^31
constexpr int kChunk = 64;           // rows (vsum) or columns (hsum) a thread
enum kField { kKey, kBest, kCm, kCp, kSecond, kFirst, kLast, kXFirst, kXLast };

// V[v, x, j] = the sum over rows v - r .. v + r inside the frame of
// |L(y, x) - R(y, x - d)|, d = d0 + j (R reads 0 for x < d): a thread a
// (x, j), j fastest, walking down kChunk rows (blockIdx.y's chunk).
__global__ void __launch_bounds__(256)
    tp_vsum_kernel(const uint8_t* __restrict__ L,
                   const uint8_t* __restrict__ R, int* __restrict__ V, int H,
                   int W, int d0, int Dl, int r) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= static_cast<long long>(W) * Dl) return;
  const int x = static_cast<int>(e / Dl), j = static_cast<int>(e % Dl);
  const int d = d0 + j;
  auto ad = [&](int y) {
    const int rv = x >= d ? R[static_cast<size_t>(y) * W + x - d] : 0;
    return abs(static_cast<int>(L[static_cast<size_t>(y) * W + x]) - rv);
  };
  const int v0 = blockIdx.y * kChunk, v1 = min(H, v0 + kChunk);
  int sum = 0;
  for (int y = max(0, v0 - r); y <= min(H - 1, v0 + r); ++y) sum += ad(y);
  for (int v = v0; v < v1; ++v) {
    V[(static_cast<size_t>(v) * W + x) * Dl + j] = sum;
    if (v + 1 + r < H) sum += ad(v + 1 + r);
    if (v - r >= 0) sum -= ad(v - r);
  }
}

// C[v, u, j] = the sum over columns u - r .. u + r inside the frame of
// V[v, x, j]: a thread a (v, j), j fastest, walking along kChunk columns.
__global__ void __launch_bounds__(256)
    tp_hsum_kernel(const int* __restrict__ V, int* __restrict__ C, int H,
                   int W, int Dl, int r) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= static_cast<long long>(H) * Dl) return;
  const int v = static_cast<int>(e / Dl), j = static_cast<int>(e % Dl);
  const int* src = V + static_cast<size_t>(v) * W * Dl + j;
  int* dst = C + static_cast<size_t>(v) * W * Dl + j;
  const int u0 = blockIdx.y * kChunk, u1 = min(W, u0 + kChunk);
  int sum = 0;
  for (int x = max(0, u0 - r); x <= min(W - 1, u0 + r); ++x)
    sum += src[static_cast<size_t>(x) * Dl];
  for (int u = u0; u < u1; ++u) {
    dst[static_cast<size_t>(u) * Dl] = sum;
    if (u + 1 + r < W) sum += src[static_cast<size_t>(u + 1 + r) * Dl];
    if (u - r >= 0) sum -= src[static_cast<size_t>(u - r) * Dl];
  }
}

// The nine partials of a (pixel, view) from the box costs C of one frame:
// a block kPx pixels of a row and a view (blockIdx.z), a thread a pixel.
// The block stages the costs its pixels read, kJ disparities at a time, in
// shared memory (C keeps d innermost, so a tile is one contiguous run of
// the row: coalesced loads), and each thread walks its costs there twice:
// the least key, then the minima outside q +- 1 and the costs it keeps.
// Where Dl <= kJ the second walk reads the same tile. P points at the
// frame's [H, W] plane of field 0 of view 0; a field's planes lie fstride
// apart, a view's kNF fstride.
constexpr int kPx = 128;  // pixels a block
constexpr int kJ = 32;    // disparities a tile

__global__ void __launch_bounds__(kPx)
    tp_partials_kernel(const int* __restrict__ C, int* __restrict__ P, int W,
                       int D, int d0, int Dl, int kclamp, long long fstride) {
  __shared__ int tile[(kPx + kJ - 1) * (kJ + 1)];  // [column][j], odd pitch
  const int view = blockIdx.z, v = blockIdx.y, u0 = blockIdx.x * kPx;
  const int i = threadIdx.x, u = u0 + i;
  const int* row = C + static_cast<size_t>(v) * W * Dl;
  // tile[c][jj] = C[v, xs + c, jc + jj]: the left view's pixels read their
  // own column, the right view's pixel u column u + d, xs = u0 + d0 + jc
  auto load = [&](int jc) {
    const int nj = min(kJ, Dl - jc);
    const int xs = u0 + (view ? d0 + jc : 0);
    const int ncol = kPx + (view ? nj - 1 : 0);
    __syncthreads();  // the last tile's readers are done
    for (int e = i; e < ncol * nj; e += kPx) {
      const int c = e / nj, jj = e - c * nj, x = xs + c;
      tile[c * (kJ + 1) + jj] =
          x < W ? row[static_cast<size_t>(x) * Dl + jc + jj] : kBig;
    }
    __syncthreads();
    return nj;
  };
  // the view's cost at jc + jj, kBig where the pair is invalid (a real cost
  // may pass kBig past r = 127; it enters the key clamped to kclamp)
  auto cost = [&](int jc, int jj) {
    const int d = d0 + jc + jj;
    const bool ok = view == 0 ? u >= d : u + d < W;
    return ok ? tile[(i + (view ? jj : 0)) * (kJ + 1) + jj] : kBig;
  };
  int key = INT_MAX, bj = 0, nj = 0;
  for (int jc = 0; jc < Dl; jc += kJ) {
    nj = load(jc);
    for (int jj = 0; jj < nj; ++jj) {
      const int k = min(cost(jc, jj), kclamp) * D + d0 + jc + jj;
      if (k < key) {  // ties: the smaller d
        key = k;
        bj = jc + jj;
      }
    }
  }
  int best = kBig, cm = kBig, cp = kBig, first = kBig, last = kBig;
  int second = kBig, xfirst = kBig, xlast = kBig;
  for (int jc = 0; jc < Dl; jc += kJ) {
    if (Dl > kJ) nj = load(jc);
    for (int jj = 0; jj < nj; ++jj) {
      const int j = jc + jj, c = min(cost(jc, jj), kBig);
      if (abs(j - bj) > 1) second = min(second, c);
      if (j > 0) xfirst = min(xfirst, c);
      if (j < Dl - 1) xlast = min(xlast, c);
      if (j == bj) best = c;
      if (j == bj - 1) cm = c;
      if (j == bj + 1) cp = c;
      if (j == 0) first = c;
      if (j == Dl - 1) last = c;
    }
  }
  if (u >= W) return;
  int* dst = P + view * kNF * fstride + static_cast<long long>(v) * W + u;
  const int out[kNF] = {key, best, cm, cp, second, first, last, xfirst, xlast};
#pragma unroll
  for (int f = 0; f < kNF; ++f) dst[f * fstride] = out[f];
}

// Disparity of one pixel of one view from its best d and cost, its least
// cost outside best_d +- 1 and its costs at best_d -+ 1, every cost at most
// kBig (as kernel G's disparity()).
__device__ __forceinline__ float disparity(int bd, int bc, int second,
                                           int cm, int cp, int D,
                                           float uniq) {
  const bool unique =
      static_cast<float>(bc) < __fmul_rn(uniq, static_cast<float>(second));
  const int den = cm + cp - 2 * bc;  // |.| <= 2^26: no wrap
  const float offs =
      (bd > 0 && bd < D - 1 && den > 0)
          ? __fdiv_rn(static_cast<float>(cm - cp),
                      __fmul_rn(2.0f, static_cast<float>(den)))
          : 0.0f;
  return unique ? __fadd_rn(static_cast<float>(bd), offs) : -1.0f;
}

// The combine of one (pixel, view) over the K ranks' partials; p points at
// rank 0's field 0 of this pixel and view, rank k's lie kstride apart.
__device__ float combine(const int* __restrict__ p, long long kstride,
                         long long fstride, int K, int D, int Dl,
                         float uniq) {
  auto at = [&](int k, int f) { return p[k * kstride + f * fstride]; };
  int w = 0, key = at(0, kKey);
  for (int k = 1; k < K; ++k) {
    const int kk = at(k, kKey);
    if (kk < key) {
      key = kk;
      w = k;
    }
  }
  const int q = key % D, lo = w * Dl, hi = lo + Dl;  // the winner's [lo, hi)
  const int cm = q - 1 >= lo ? at(w, kCm) : (w > 0 ? at(w - 1, kLast) : kBig);
  const int cp = q + 1 < hi ? at(w, kCp) : (w + 1 < K ? at(w + 1, kFirst) : kBig);
  int second = at(w, kSecond);
  for (int k = 0; k < K; ++k) {
    if (k == w) continue;
    const int s = (k == w - 1 && q == lo)       ? at(k, kXLast)
                  : (k == w + 1 && q == hi - 1) ? at(k, kXFirst)
                                                : min(at(k, kFirst), at(k, kXFirst));
    second = min(second, s);
  }
  return disparity(q, at(w, kBest), second, cm, cp, D, uniq);
}

__global__ void __launch_bounds__(256)
    tp_combine_kernel(const int* __restrict__ P, float* __restrict__ dl,
                      float* __restrict__ dr, int K, int B, int H, int W,
                      int D, int Dl, float uniq, float lr_threshold) {
  extern __shared__ float row[];  // [2][W]: the row's dL, then its dR
  const int v = blockIdx.x, b = blockIdx.y;
  const long long plane = static_cast<long long>(H) * W;
  const long long fstride = static_cast<long long>(B) * plane;
  const long long vstride = kNF * fstride, kstride = 2 * vstride;
  const long long base = b * plane + static_cast<long long>(v) * W;
  for (int u = threadIdx.x; u < W; u += blockDim.x)
    for (int view = 0; view < 2; ++view)
      row[view * W + u] = combine(P + view * vstride + base + u, kstride,
                                  fstride, K, D, Dl, uniq);
  __syncthreads();
  for (int u = threadIdx.x; u < W; u += blockDim.x) {
    const float d = row[u];
    const int uw =
        min(max(static_cast<int>(__fsub_rn(static_cast<float>(u), d)), 0),
            W - 1);
    const int idx = u - min(max(u - uw, 0), D);
    const float other = (idx >= 0 && idx < W) ? row[W + idx] : -1e9f;
    const bool ok = d >= 0.0f && other >= 0.0f &&
                    fabsf(__fsub_rn(other, d)) <= lr_threshold;
    dl[base + u] = ok ? d : -1.0f;
    dr[base + u] = row[W + u];
  }
}

}  // namespace

// T1 over a rank's B frames, one after another through ``scratch`` (two
// int32 [H, W, Dl] volumes, 2 H W Dl ints): three launches a frame.
// partials: int32 [2, NF, B, H, W].
extern "C" int tp_partials(const uint8_t* L, const uint8_t* R, int* partials,
                           int* scratch, int B, int H, int W, int D, int d0,
                           int Dl, int r, void* stream) {
  if (scratch == nullptr || B < 1 || H < 1 || W < 1 || D < 2 || Dl < 1 ||
      d0 < 0 || d0 + Dl > D || r < 0 || r > kBoxRMax ||
      D > (1 << 30) / 2)  // the key clamp must stay >= 1
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t frame = static_cast<size_t>(H) * W;
  int* V = scratch;
  int* C = scratch + frame * Dl;
  const int kclamp = min(kBig, (1 << 30) / D - 1);
  const long long nv = static_cast<long long>(W) * Dl,
                  nh = static_cast<long long>(H) * Dl,
                  fstride = static_cast<long long>(B) * frame;
  const dim3 gv(static_cast<unsigned>((nv + 255) / 256), (H + kChunk - 1) / kChunk);
  const dim3 gh(static_cast<unsigned>((nh + 255) / 256), (W + kChunk - 1) / kChunk);
  const dim3 gp((W + kPx - 1) / kPx, H, 2);
  if (gv.y > 65535 || gh.y > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int b = 0; b < B; ++b) {
    tp_vsum_kernel<<<gv, 256, 0, s>>>(L + b * frame, R + b * frame, V, H, W,
                                      d0, Dl, r);
    tp_hsum_kernel<<<gh, 256, 0, s>>>(V, C, H, W, Dl, r);
    tp_partials_kernel<<<gp, kPx, 0, s>>>(C, partials + b * frame, W, D, d0,
                                          Dl, kclamp, fstride);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

// T2: partials int32 [K, 2, NF, B, H, W] -> dl (after the L/R check) and dr,
// float32 [B, H, W]; one launch, a block a (frame, row).
extern "C" int tp_combine(const int* partials, float* dl, float* dr, int K,
                          int B, int H, int W, int D, int Dl, float uniq,
                          float lr_threshold, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(W) * sizeof(float);
  if (K < 1 || B < 1 || B > 65535 || H < 1 || W < 1 || D < 2 || Dl < 1 ||
      static_cast<long long>(K) * Dl > D || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 49152) {
    const cudaError_t e = cudaFuncSetAttribute(
        tp_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tp_combine_kernel<<<dim3(H, B), 256, smem, static_cast<cudaStream_t>(stream)>>>(
      partials, dl, dr, K, B, H, W, D, Dl, uniq, lr_threshold);
  return static_cast<int>(cudaGetLastError());
}

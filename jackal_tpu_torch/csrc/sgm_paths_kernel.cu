// SGM path aggregation: the 8-path (or 4-path) recurrence and its sum.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/sgm_kernel.py
// (_sgm_dir_kernel l.64, pallas_call in sgm_paths_dir_pallas l.207, driven
// by aggregate_paths_pallas_bhdw l.285). The plain PyTorch version of the
// same function is aggregate_paths in jackal_tpu_torch/matching/sgm.py;
// the wrapper is ops/sgm_kernel.aggregate_paths_bhdw.
//
// What it computes. cost is int16 [B, H, W, D] (d innermost: the wrapper
// transposes the reference's [B, H, D, W]). Along each path direction r,
//   L(p, d) = min(C(p, d) + min(L(q, d), L(q, d+-1) + P1, m + P2) - m, BIG)
// with q = p - r, m = min_d' L(q, d'), BIG = 28000, the missing d-1 / d+1
// neighbour a plain BIG, and L(q, .) = BIG where q lies outside the image
// (the first row of a pass, and the reference's edge reset of the
// diagonal carries). With an all-BIG carry the step gives min(C, BIG),
// which is the reference's first row, so every path starts the same way.
// S(p, d) is the sum of the 8 (or 4) paths, clamped to BIG.
//
// Why one clamp at the end equals the reference's grouped clamps. The
// reference clamps to BIG after the down group, after adding the up group,
// after each horizontal pass and after the total. Every path value is >= 0:
// C >= 0, and best >= m because every candidate of the minimum is >= m
// (prev >= m, m + P2 >= m, and a neighbour + P1 >= m, as P1, P2 >= 0 and
// the BIG cap is >= every carry). For a, b >= 0, min(min(a, BIG) + b, BIG)
// = min(a + b, BIG): if a >= BIG both sides are BIG, else they are the same
// expression. So any grouping, and any order, of clamped partial sums gives
// min(total, BIG). This kernel therefore keeps the running sum in int16
// saturated at BIG: each pass reads its cells' sum, adds its path value in
// int32 (at most 2 * BIG, no overflow) and stores min(sum, BIG). That is
// the same value as an int32 accumulator clamped once, in half the bytes.
//
// What bounds it on an H100. One pass per direction, each a launch; the
// launches are ordered on the stream and every cell is on exactly one line
// of a direction, so no atomics are needed. The least work is one read of
// the int16 cost and one write of S: 4 bytes a cell, 78.6 MB for a 640x480
// frame at D = 64 (0.0235 ms at 3.35 TB/s). The operations are 11 integer
// operations a cell a path (the min into m, m + P2, the neighbours' min,
// + P1, the best, C + best - m, the clamp, the sum's add and clamp), 1.7e9
// for that frame at 8 paths, 0.103 ms at the card's 32-bit integer rate
// (64 adds or mins a clock an SM, 16.7e12 /s at 1980 MHz): the least time
// is set by operations, 4.4x the bytes' (chip_smoke.sgm_work counts
// both). This simple design moves more: each of the 8 passes reads the
// cost and reads and writes the running sum, 6 bytes a cell a pass.
//
// The design. Each direction's cells fall into independent lines: a line
// per column (vertical), per row (horizontal), per u - v or u + v
// (diagonal, H + W - 1 lines), because the carry starts afresh at the
// image edge. One warp walks one (frame, line); its lanes split d, K =
// ceil(D / 32) consecutive values a lane, so one step's cost and sum loads
// are D contiguous int16. m is one __reduce_min_sync; the d-1 / d+1
// neighbours across lanes come by one shuffle up and one down. The carry
// stays in registers, and the next cell's loads are started before the
// current cell's arithmetic. Lanes past D hold BIG, which changes neither
// m nor the d = D-1 neighbour (itself BIG).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 28000;
constexpr int kWarps = 4;  // lines a block
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void sgm_dir_kernel(const int16_t* __restrict__ cost,
                               int16_t* __restrict__ sum, int H, int W, int D,
                               int p1, int p2, int dv, int du, int n_lines,
                               int n_work, int first) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= n_work) return;  // the whole warp leaves together
  const int b = warp / n_lines, i = warp % n_lines;
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
  const int len = min(len_v, len_u);
  const long long step = static_cast<long long>(dv) * W + du;
  long long cell = (static_cast<long long>(b) * H + v) * W + u;
  const int d0 = lane * K;

  int prev[K], c[K], s[K], cn[K], sn[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    prev[j] = kBig;
    const bool live = d0 + j < D;
    c[j] = live ? cost[cell * D + d0 + j] : kBig;
    s[j] = live && !first ? sum[cell * D + d0 + j] : 0;
  }
  for (int t = 0; t < len; ++t) {
    const long long next = cell + step;
    if (t + 1 < len) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const bool live = d0 + j < D;
        cn[j] = live ? cost[next * D + d0 + j] : kBig;
        sn[j] = live && !first ? sum[next * D + d0 + j] : 0;
      }
    }
    int mloc = prev[0];
#pragma unroll
    for (int j = 1; j < K; ++j) mloc = min(mloc, prev[j]);
    const int m = __reduce_min_sync(kFull, mloc);
    int lo = __shfl_up_sync(kFull, prev[K - 1], 1);
    int hi = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 0) lo = kBig;
    if (lane == 31) hi = kBig;
    int out[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int up = j == 0 ? lo : prev[j - 1];
      const int dn = j == K - 1 ? hi : prev[j + 1];
      const int best = min(min(prev[j], m + p2), min(up, dn) + p1);
      out[j] = min(c[j] + best - m, kBig);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      prev[j] = out[j];
      if (d0 + j < D)
        sum[cell * D + d0 + j] =
            static_cast<int16_t>(min(s[j] + out[j], kBig));
      c[j] = cn[j];
      s[j] = sn[j];
    }
    cell = next;
  }
}

template <int K>
int launch_dirs(const int16_t* cost, int16_t* sum, int B, int H, int W,
                int D, int p1, int p2, int num_paths, cudaStream_t stream) {
  // (dv, du): vertical first, then the diagonals, then horizontal
  static const int kDirs[8][2] = {{1, 0},  {-1, 0}, {0, 1},  {0, -1},
                                  {1, 1},  {1, -1}, {-1, 1}, {-1, -1}};
  for (int k = 0; k < num_paths; ++k) {
    const int dv = kDirs[k][0], du = kDirs[k][1];
    const int n_lines = dv == 0 ? H : (du == 0 ? W : H + W - 1);
    const long long n_work = static_cast<long long>(B) * n_lines;
    if (n_work > INT_MAX / 32) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = static_cast<int>((n_work + kWarps - 1) / kWarps);
    sgm_dir_kernel<K><<<blocks, kWarps * 32, 0, stream>>>(
        cost, sum, H, W, D, p1, p2, dv, du, n_lines,
        static_cast<int>(n_work), k == 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// All the passes of one aggregation, in order on ``stream``; the first
// writes the running sum, the others add to it. num_paths is 8 or 4.
extern "C" int sgm_paths(const int16_t* cost, int16_t* sum, int B, int H,
                         int W, int D, int p1, int p2, int num_paths,
                         void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 2 || D > 256 ||
      (num_paths != 8 && num_paths != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return launch_dirs<1>(cost, sum, B, H, W, D, p1, p2, num_paths, s);
    case 2: return launch_dirs<2>(cost, sum, B, H, W, D, p1, p2, num_paths, s);
    case 3: return launch_dirs<3>(cost, sum, B, H, W, D, p1, p2, num_paths, s);
    case 4: return launch_dirs<4>(cost, sum, B, H, W, D, p1, p2, num_paths, s);
    case 5: return launch_dirs<5>(cost, sum, B, H, W, D, p1, p2, num_paths, s);
    case 6: return launch_dirs<6>(cost, sum, B, H, W, D, p1, p2, num_paths, s);
    case 7: return launch_dirs<7>(cost, sum, B, H, W, D, p1, p2, num_paths, s);
    default: return launch_dirs<8>(cost, sum, B, H, W, D, p1, p2, num_paths, s);
  }
}

// ELAS support-point matching: best-two keys of both views per grid row.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/support_kernel.py
// (_support_kernel l.61, pallas_call l.183, wrapper
// support_candidates_pallas l.148). The plain PyTorch version of the same
// function is support_keys_plain in matching/elas/support.py. The
// acceptance tests after the keys (texture, ratio, bounds, fwd-bwd: kernel
// Q's function, support_epilogue_plain) run as the epilogue of A's last
// launch when it is given a grid (see "Epilogue" below).
//
// What it computes. desc1 and desc2 are the descriptors [B, H, W, 16]
// uint8; grid row k (k < nv) is image row vs = (k + 1) * step, and its
// 32-byte tap Q(x) (T(x) of desc2) is the descriptors of rows vs - 2 and
// vs + 2 at column x side by side, the bias value 128 for a row outside
// the image (grid_row_blocks in matching/elas/support.py builds these
// blocks for the plain version). With S(x, d) = sum over 32 bytes
// |Q(x) - T(x-d)|:
//   left  key(c, d) = (S(c-2, d) + S(c+2, d)) * 512 + d,  live d+5 <= c <= W-6
//   right key(c, d) = (S(c+d-2, d) + S(c+d+2, d)) * 512 + d, live 5 <= c <= W-5-d
// for d in [disp_min, D), D <= 512. Per view the two smallest keys survive;
// dead keys are KBIG. The out array is int32 [4, B, nv, W]: l1, l2, r1, r2.
// A block reads its grid row's taps from the descriptors' rows itself, so
// no blocks are built on the card.
// Every live key's taps lie in [d+3, W-3], so no padding is needed.
//
// What bounds it on an H100: integer instructions. Each S(x, d) that a
// live key reads is 8 __vsadu4 (VABSDIFF4 with its accumulate) on 32
// bytes; each live (c, d, view) is 3 more: with the table below holding
// U = S * 1024 + d, the key doubled is U1 + U2 = 2 * key (order kept:
// 2d < 1024), and the best-two update is __viaddmax_s32 (max(U1 + U2, k1)),
// a min for k2, and __viaddmin_s32 for k1 (VIADDMNMX, VIMNMX). At 640x480
// (nv = 95), D = 256 that is 95 * (129,920 * 8 + 257,536 * 3) = 172.1e6
// instructions, 0.0103 ms at 64 a clock an SM (chip_smoke.support_work);
// the bytes (inputs read once, the maps written once, 4.86 MB) take less.
// A design that computes S per key computes each S(x, d) four times (the
// two taps of a left key, and the right view's keys are the left's
// shifted by d): 0.0236 ms at the measured byte SAD rate.
//
// The design. A block owns one (frame, grid row, range of d); the ranges
// split the chunks of [disp_min, D) into R (1 to 8, a power of two) so
// that B * nv * R blocks fill the card (support_keys_plan). A block walks
// its range in chunks of DC disparities: DC = 16, fewer where W is so wide
// that the table would not fit. Per chunk [da, db):
//  - table: for every x in [da+3, W-3] and every d of the chunk, U =
//    S(x, d) * 1024 + d is computed once into a shared table [DC][Wp]
//    int32, Wp = W rounded up to 4. The x come in slabs of 384: the block
//    copies the slab's Q taps and the T taps its d reach (384 + DC - 1)
//    from device memory with coalesced 16-byte loads into word planes
//    (word w of every tap side by side), then a thread takes 3
//    consecutive x (lanes 3 words apart: no bank conflicts), keeps their
//    Q in registers and slides over the chunk's d, reading one new T tap
//    (8 shared loads) a step for 3 SADs. A layout with a thread's taps
//    loaded from device memory (lanes 128 bytes apart) left the L1 at a
//    fraction of its rate: 0.098 ms against 0.050 at 640x480 on an H100
//    SXM at 700 W;
//  - walk: after a barrier, a thread takes columns c = tid + k * 128 and
//    walks the live d of the chunk ascending, both views in one loop,
//    two shared loads a key (lanes on neighbouring columns, no bank
//    conflicts). The best-two state of a column is kept across chunks in
//    the block's partial of the four maps in device memory, read and
//    written by the same thread.
// Shared memory a block: DC * Wp * 4 + 25,856 bytes (the planes): 66,816
// at W = 640 (DC = 16; 3 blocks an SM), 222,464 at W = 4096 (DC = 12);
// W up to 51,648 fits at DC = 1.
// Merge. With R > 1, support_merge_kernel folds the R partial pairs of a
// (frame, row, column, view) with
//   (a1, a2) + (b1, b2) = (min(a1, b1), min(max(a1, b1), min(a2, b2))),
// which is exact: keys are unique in d and the ranges are disjoint, so the
// two smallest of a union are the smaller first and the smaller of the
// other first and both seconds; a dead key is KBIG in every partial. It
// halves the doubled keys. With R = 1 the block writes the halved keys
// itself and there is no second launch. A merge block owns one (frame,
// key row) and every column of it.
// Epilogue. Given a grid (int16 [B, nv + 1, ncu]), A's last launch also
// writes the candidate grid, kernel Q's function: the block that holds a
// key row's final keys (the keys block at R = 1, after its last chunk; the
// merge block at R > 1) writes grid row k + 1 from them after a barrier,
// the right view's key at u - dL being another column of the same row; the
// row-0 blocks also write grid row 0 (zeros). The keys come from shared
// memory where the row's four maps fit (the staging planes at R = 1, W <=
// 1616; 16 W bytes of the merge block's at R > 1, W <= 3072), else from
// the out array the block has just written. One test of a grid column is
// support_epilogue_row's, which kernel Q's standalone entry at the end of
// this file runs too: it saves the launch that was Q's whole time (0.00345
// ms against a 0.000141 ms byte bound at 640x480 on an H100 SXM at 700 W).
// The bound with the epilogue is A's operations plus Q's bytes
// (chip_smoke.epilogue_work): a grid row's tests wait for its final keys.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kKBig2 = 2 << 24;  // KBIG, doubled
constexpr int kGap = 5;
constexpr int kThreads = 128;
constexpr int kXT = 3;                 // x a thread's table item
constexpr int kSlab = kXT * kThreads;  // x a slab of the table's fill
constexpr int kDCMax = 16;             // d a chunk
constexpr int kPlane = kSlab + kDCMax + 4;  // a plane's words, 4 mod 8
constexpr int kPlaneBytes = 2 * 8 * kPlane * 4;  // Q's and T's planes
constexpr int kRMax = 8;
constexpr uint32_t k128 = 0x80808080u;  // four bias bytes

static_assert(kPlane % 8 == 4, "the staging's two halves on other banks");

struct Tap {
  uint32_t w[8];  // 32 bytes
};

// The half of a grid row's taps that a thread stages: half k =
// threadIdx.x & 1 (0: row vs-2, 1: row vs+2; the staging loop steps by
// kThreads, an even number, so a thread always stages the same half) of
// tap y is the 16-byte word at p + stride * y: a row of the descriptors at
// stride 1, or for a row outside the image kBiasTap, the bias value 128,
// at stride 0.
struct Half {
  const uint4* p;
  int stride;
};

static_assert(kThreads % 2 == 0, "a thread stages one half of every tap");

__device__ const uint4 kBiasTap = {k128, k128, k128, k128};

// Taps [y0, y0 + n) of a row, y clamped to [0, W-1], into word planes:
// word w of tap y at P[w * kPlane + y - y0]. Lanes read 16 consecutive
// bytes each (coalesced: even lanes one half's row, odd lanes the
// other's); the two halves of a tap land 16 banks apart.
__device__ __forceinline__ void stage(uint32_t* P, Half h, int y0, int n,
                                      int W) {
  uint32_t* base = P + (threadIdx.x & 1) * 4 * kPlane;
  for (int i = threadIdx.x; i < 2 * n; i += kThreads) {
    const int y = min(max(y0 + (i >> 1), 0), W - 1);
    const uint4 v = __ldg(h.p + h.stride * y);
    uint32_t* p = base + (i >> 1);
    p[0] = v.x;
    p[kPlane] = v.y;
    p[2 * kPlane] = v.z;
    p[3 * kPlane] = v.w;
  }
}

__device__ __forceinline__ void read_tap(Tap& t, const uint32_t* P, int i) {
#pragma unroll
  for (int w = 0; w < 8; ++w) t.w[w] = P[w * kPlane + i];
}

__device__ __forceinline__ int sad32(const Tap& p, const Tap& q) {
  unsigned s = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) s = __vsadu4(p.w[w], q.w[w]) + s;
  return static_cast<int>(s);
}

__host__ __device__ __forceinline__ int padded(int W) { return (W + 3) & ~3; }

// U[d - da][x - (da + 3)] = S(x, d) * 1024 + d for the chunk [da, db) and
// every x in [da + 3, W - 3]. Slabs of kSlab x: the block stages the
// slab's Q taps and the T taps its d reach into word planes, then a thread
// takes 3 consecutive x (lanes 3 words apart: no bank conflicts), keeps
// their Q in registers and slides over the chunk's d, reading one new T
// tap a step for 3 SADs. A thread stops at the last d its x need
// (d <= x - 3); values at x > W-3 or x < d+3 are stored but never read.
__device__ __forceinline__ void fill_table(int* __restrict__ U,
                                           uint32_t* __restrict__ Qp,
                                           uint32_t* __restrict__ Tp,
                                           Half q, Half t, int W, int Wp,
                                           int da, int db) {
  const int xb = da + 3;
  for (int xs = xb; xs <= W - 3; xs += kSlab) {
    const int yb = xs - db + 1;  // T taps [yb, xs + kSlab - da)
    if (xs > xb) __syncthreads();  // the last slab's planes are read
    stage(Qp, q, xs, kSlab, W);
    stage(Tp, t, yb, kSlab + db - da - 1, W);
    __syncthreads();
    const int x0 = xs + kXT * threadIdx.x;
    const int de = min(db, min(x0 + kXT - 1, W - 3) - 2);
    if (x0 > W - 3 || da >= de) continue;
    Tap qx[kXT], w[kXT];
#pragma unroll
    for (int k = 0; k < kXT; ++k) {
      read_tap(qx[k], Qp, x0 - xs + k);
      read_tap(w[k], Tp, x0 + k - da - yb);
    }
    int* row = U + (x0 - xb);
#pragma unroll
    for (int j = 0; j < kDCMax; ++j) {
      const int d = da + j;
#pragma unroll
      for (int k = 0; k < kXT; ++k) row[k] = sad32(qx[k], w[k]) * 1024 + d;
      if (d + 1 >= de) break;
      row += Wp;
#pragma unroll
      for (int k = kXT - 1; k > 0; --k) w[k] = w[k - 1];
      read_tap(w[0], Tp, x0 - d - 1 - yb);
    }
  }
}

__device__ __forceinline__ void best_two(const int* p, int& k1, int& k2) {
  k2 = min(k2, __viaddmax_s32(p[0], p[4], k1));
  k1 = __viaddmin_s32(p[0], p[4], k1);
}

// This thread's half (Half) of a view's grid row `row` of frame b, src
// [B, H, W, 16]: the grid row is image row vs = (row + 1) * step, its
// halves rows vs - 2 and vs + 2.
__device__ __forceinline__ Half grid_half(const uint8_t* src, int b, int row,
                                          int H, int W, int step) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const int y = (row + 1) * step + ((threadIdx.x & 1) ? 2 : -2);
  if (y < 0 || y >= H) return Half{&kBiasTap, 0};
  return Half{s + (static_cast<size_t>(b) * H + y) * W, 1};
}

// ---- the epilogue: kernel Q's function on one grid row ---------------------

struct Epilogue {
  int16_t* grid;  // int16 [B, nv + 1, ncu], written whole; null: keys alone
  int ncu, disp_min, disp_max, texture, lr;
  float thr;
};

// a view's disparity at column x of a live grid row, or -1: k1p, k2p its
// best and second keys of the row (shared or global memory), desc the
// row's descriptors
__device__ __forceinline__ int accept(const int32_t* k1p, const int32_t* k2p,
                                      const uint4* desc, int x, int dmax,
                                      int W, const Epilogue& e) {
  if (x < kGap || x > W - kGap - 1 || dmax - e.disp_min < 10 ||
      max(dmax - e.disp_min + 1, 0) < 2)
    return -1;
  const int k1 = k1p[x];
  if (k1 >= (kKBig2 >> 1)) return -1;
  const uint4 d = __ldg(desc + x);
  const unsigned tex = __vsadu4(d.x, k128) + __vsadu4(d.y, k128) +
                       __vsadu4(d.z, k128) + __vsadu4(d.w, k128);
  if (static_cast<int>(tex) < e.texture) return -1;
  const float a = __int2float_rn(k1 >> 9);
  const float b = __fmul_rn(e.thr, __int2float_rn(k2p[x] >> 9));
  return a < b ? (k1 & 511) : -1;
}

// Grid row j (image row vs = j * step) of frame b, its columns shared by
// the block's threads: keys is key row j - 1's l1 map, l2, r1, r2 at
// 1, 2, 3 strides from it (unread at j = 0); desc1, desc2 the descriptors
// [B, H, W] (16 bytes a pixel). Row 0 and column 0 are 0; elsewhere the
// left view's disparity dL at u = i * step where it accepts, the right
// view's dR at u - dL accepts and |dL - dR| <= lr, else -1.
__device__ __forceinline__ void support_epilogue_row(
    const Epilogue& e, const int32_t* keys, size_t stride,
    const uint4* desc1, const uint4* desc2, int b, int j, int nrows, int H,
    int W, int step) {
  int16_t* g = e.grid + (static_cast<size_t>(b) * nrows + j) * e.ncu;
  const int vs = j * step;
  const bool live = j > 0 && vs >= kGap && vs <= H - kGap - 1;
  const size_t pix = (static_cast<size_t>(b) * H + vs) * W;
  for (int i = threadIdx.x; i < e.ncu; i += blockDim.x) {
    int out = (j > 0 && i > 0) ? -1 : 0;
    if (live && i > 0) {
      const int u = i * step;
      const int dl = accept(keys, keys + stride, desc1 + pix, u,
                            min(u - kGap, e.disp_max), W, e);
      if (dl >= 0) {
        const int back = min(max(u - dl, 0), W - 1);
        const int dr = accept(keys + 2 * stride, keys + 3 * stride,
                              desc2 + pix, back,
                              min(W - back - kGap, e.disp_max), W, e);
        if (dr >= 0 && abs(dl - dr) <= e.lr) out = dl;
      }
    }
    g[i] = static_cast<int16_t>(out);
  }
}

__global__ void __launch_bounds__(kThreads)
support_keys_kernel(const uint8_t* __restrict__ Q,
                    const uint8_t* __restrict__ T, int32_t* __restrict__ dst,
                    int nv, int W, int disp_min, int D, int chunk,
                    int ranges, int H, int step, Epilogue ep) {
  extern __shared__ int4 smem[];
  int* U = reinterpret_cast<int*>(smem);
  const int Wp = padded(W);
  uint32_t* Qp = reinterpret_cast<uint32_t*>(U + chunk * Wp);
  uint32_t* Tp = Qp + 8 * kPlane;
  const int r = blockIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.z) * nv + blockIdx.y;
  const size_t N = static_cast<size_t>(gridDim.z) * nv * W;
  const size_t base = row * W;
  const Half q = grid_half(Q, blockIdx.z, blockIdx.y, H, W, step);
  const Half t = grid_half(T, blockIdx.z, blockIdx.y, H, W, step);
  // with R = 1 dst is the out array, else this block's partial
  int32_t* out = dst + (ranges > 1 ? r * 4 * N : 0) + base;
  const int nchunks = (D - disp_min + chunk - 1) / chunk;
  const int k0 = r * nchunks / ranges, k1 = (r + 1) * nchunks / ranges;
  // at R = 1 with a grid: the final keys also go to the staging planes
  // (free during the walk) where the row's four maps fit there
  const bool epilogue = ep.grid != nullptr && ranges == 1;
  const bool in_smem = epilogue && 16 * W <= kPlaneBytes;
  int* ks = reinterpret_cast<int*>(Qp);
  for (int k = k0; k < k1; ++k) {
    const int da = disp_min + k * chunk, db = min(da + chunk, D);
    if (k > k0) __syncthreads();  // the last chunk's walk is done
    fill_table(U, Qp, Tp, q, t, W, Wp, da, db);
    __syncthreads();
    const int shift = (k == k1 - 1 && ranges == 1) ? 1 : 0;
    for (int c = threadIdx.x; c < W; c += kThreads) {
      int a1 = kKBig2, a2 = kKBig2, b1 = kKBig2, b2 = kKBig2;
      if (k > k0) {
        a1 = out[c];
        a2 = out[N + c];
        b1 = out[2 * N + c];
        b2 = out[3 * N + c];
      }
      // live d of the chunk: left d <= c - 5 (c <= W - 6), right
      // d <= W - 5 - c (c >= 5); both views in one loop where both live
      const int nl = c <= W - kGap - 1 ? min(db, c - kGap + 1) - da : 0;
      const int nr = c >= kGap ? min(db, W - kGap - c + 1) - da : 0;
      const int* pl = U + c - kGap - da;  // U[j][c - 2 - (da + 3)]
      const int* pr = U + c - kGap;       // U[j][c + d - 2 - (da + 3)]
      int j = 0;
#pragma unroll 4
      for (; j < min(nl, nr); ++j, pl += Wp, pr += Wp + 1) {
        best_two(pl, a1, a2);
        best_two(pr, b1, b2);
      }
      for (; j < nl; ++j, pl += Wp) best_two(pl, a1, a2);
      for (; j < nr; ++j, pr += Wp + 1) best_two(pr, b1, b2);
      out[c] = a1 >> shift;
      out[N + c] = a2 >> shift;
      out[2 * N + c] = b1 >> shift;
      out[3 * N + c] = b2 >> shift;
      if (in_smem && k == k1 - 1) {
        ks[c] = a1 >> 1;
        ks[W + c] = a2 >> 1;
        ks[2 * W + c] = b1 >> 1;
        ks[3 * W + c] = b2 >> 1;
      }
    }
  }
  if (!epilogue) return;
  __syncthreads();  // the row's final keys are all written
  const uint4* d1 = reinterpret_cast<const uint4*>(Q);
  const uint4* d2 = reinterpret_cast<const uint4*>(T);
  support_epilogue_row(ep, in_smem ? ks : out, in_smem ? W : N, d1, d2,
                       blockIdx.z, blockIdx.y + 1, nv + 1, H, W, step);
  if (blockIdx.y == 0)
    support_epilogue_row(ep, nullptr, 0, d1, d2, blockIdx.z, 0, nv + 1, H,
                         W, step);
}

constexpr int kMergeThreads = 1024;
constexpr int kMergeSmem = 48 * 1024;  // the row's four maps, 16 W bytes

// A block a (frame b, key row k): every column's R partial pairs of both
// views folded into out (halved), and, given a grid, grid row k + 1 (and
// row 0 from the k = 0 blocks) from them. smem_keys: the maps also go to
// shared memory (16 W bytes of it), read by the epilogue.
__global__ void __launch_bounds__(kMergeThreads)
support_merge_kernel(const int32_t* __restrict__ part,
                     int32_t* __restrict__ out, const uint8_t* __restrict__ Q,
                     const uint8_t* __restrict__ T, int nv, int W, int H,
                     int step, int ranges, int smem_keys, Epilogue ep) {
  extern __shared__ int32_t ks[];
  const int b = blockIdx.y;
  const size_t N = static_cast<size_t>(gridDim.y) * nv * W;
  const size_t base = (static_cast<size_t>(b) * nv + blockIdx.x) * W;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    const size_t n = base + c;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      int p1[kRMax], p2[kRMax];  // all R pairs in flight before the fold
#pragma unroll
      for (int r = 0; r < kRMax; ++r)
        if (r < ranges) {
          p1[r] = part[(4 * r + 2 * v) * N + n];
          p2[r] = part[(4 * r + 2 * v + 1) * N + n];
        }
      int k1 = p1[0], k2 = p2[0];
#pragma unroll
      for (int r = 1; r < kRMax; ++r)
        if (r < ranges) {
          k2 = min(max(k1, p1[r]), min(k2, p2[r]));
          k1 = min(k1, p1[r]);
        }
      out[2 * v * N + n] = k1 >> 1;
      out[(2 * v + 1) * N + n] = k2 >> 1;
      if (smem_keys) {
        ks[2 * v * W + c] = k1 >> 1;
        ks[(2 * v + 1) * W + c] = k2 >> 1;
      }
    }
  }
  if (ep.grid == nullptr) return;
  __syncthreads();  // the row's final keys are all written
  const uint4* d1 = reinterpret_cast<const uint4*>(Q);
  const uint4* d2 = reinterpret_cast<const uint4*>(T);
  support_epilogue_row(ep, smem_keys ? ks : out + base, smem_keys ? W : N,
                       d1, d2, b, blockIdx.x + 1, nv + 1, H, W, step);
  if (blockIdx.x == 0)
    support_epilogue_row(ep, nullptr, 0, d1, d2, b, 0, nv + 1, H, W, step);
}

}  // namespace

// The launch plan for a shape on a device: the d ranges a row (R) and the
// d a chunk (DC). Returns cudaErrorInvalidValue for a shape the kernel
// does not take (D > 512, disp_min >= D, or a W whose table does not fit
// in shared memory at DC = 1).
extern "C" int support_keys_plan(int B, int nv, int W, int disp_min, int D,
                                 int device, int* ranges, int* chunk) {
  if (B < 1 || nv < 1 || W < 1 || disp_min < 0 || disp_min >= D || D > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_bytes = 4LL * padded(W);
  const int n = D - disp_min;
  const int dc = static_cast<int>(std::min<long long>(
      std::min(kDCMax, n), (optin - kPlaneBytes) / row_bytes));
  if (dc < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = (n + dc - 1) / dc;
  int R = 1;
  while (R < kRMax && 2 * R <= nchunks &&
         static_cast<long long>(R) * B * nv < 4LL * sms)
    R *= 2;
  *ranges = R;
  *chunk = dc;
  return 0;
}

// desc1, desc2: u8 [B, H, W, 16] descriptors; the kernel reads grid row
// k's taps from image rows (k + 1) * step -+ 2 itself (128 past the
// image). out: int32 [4, B, nv, W]; part: int32 [R, 4, B, nv, W] when R > 1
// (unused at R = 1). grid: int16 [B, nv + 1, ceil(W / step)], the
// candidate grid, written whole by the last launch's epilogue (then nv + 1
// must be ceil(H / step)), or null for the keys alone; texture, lr, thr:
// support_texture, lr_threshold, support_threshold (disp_max is D - 1).
// One launch at R = 1, two (keys, merge) above.
extern "C" int support_keys(const uint8_t* desc1, const uint8_t* desc2,
                            int32_t* out, int32_t* part, int16_t* grid,
                            int B, int nv, int W, int H, int step,
                            int disp_min, int D, int ranges, int chunk,
                            int texture, int lr, float thr, void* stream) {
  if (B < 1 || B > 65535 || nv < 1 || W < 1 || step < 1 || H < 1 ||
      static_cast<long long>(nv) * step >= H ||
      (grid != nullptr && static_cast<long long>(nv + 1) * step < H) ||
      ranges < 1 || ranges > kRMax || chunk < 1 || chunk > kDCMax ||
      disp_min < 0 || disp_min >= D || D > 512 ||
      ranges > (D - disp_min + chunk - 1) / chunk)  // a range of no chunk
    return static_cast<int>(cudaErrorInvalidValue);
  const Epilogue ep{grid, (W + step - 1) / step, disp_min, D - 1, texture,
                    lr, thr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(chunk) * padded(W) * 4 + kPlaneBytes;
  // set on every launch: the attribute is the current card's, and a
  // process may launch on several cards
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        support_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid_k(ranges, nv, B);
  support_keys_kernel<<<grid_k, kThreads, smem, s>>>(
      desc1, desc2, ranges > 1 ? part : out, nv, W, disp_min, D, chunk,
      ranges, H, step, ep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return static_cast<int>(err);
  const int threads = std::min(kMergeThreads, (W + 31) / 32 * 32);
  const int keys_smem = 16LL * W <= kMergeSmem ? 16 * W : 0;
  support_merge_kernel<<<dim3(nv, B), threads, keys_smem, s>>>(
      part, out, desc1, desc2, nv, W, H, step, ranges, keys_smem > 0, ep);
  return static_cast<int>(cudaGetLastError());
}

// ---- kernel Q: the support epilogue alone ----------------------------------
//
// Replaces no Pallas kernel: the reference runs it inside one jitted
// program, jackal_tpu/matching/elas/support.py:76 support_candidates, after
// its cost scan (l.121-173): the texture sums, the acceptance test of both
// views (accL, accR), the forward-backward check on the grid columns and
// the calloc border. The plain PyTorch version is support_epilogue_plain in
// matching/elas/support.py. On every path it runs as kernel A's epilogue
// (above); this standalone entry takes key maps from anywhere (the card
// tests feed it keys built at the ratio test's edge), and runs the same
// support_epilogue_row.
//
// What it computes. keys: int32 [4, B, nv, W] (l1, l2, r1, r2 of the keys
// kernel above); desc1, desc2: u8 [B, H, W, 16]; grid: int16 [B, ncv, ncu],
// written whole. Grid row 0 and column 0 are 0. At grid row j >= 1
// (vs = j * step, key row j - 1) and column i >= 1 (u = i * step) a view's
// disparity at column x is k1 & 511 where it accepts, else -1:
//   5 <= x <= W-6, dmax - disp_min >= 10 (dmax = min(x - 5, disp_max)
//   left, min(W - x - 5, disp_max) right), 5 <= vs <= H-6,
//   tex(x) = sum over 16 bytes |desc(vs, x) - 128| >= support_texture,
//   k1 < KBIG and f32(k1 >> 9) < f32(thr) * f32(k2 >> 9), the product
//   rounded to f32 (__fmul_rn: no contraction);
// the entry is dL = the left view's at u where it accepts, the right
// view's dR at u - dL accepts and |dL - dR| <= lr_threshold, else -1.
//
// What bounds it on an H100: bytes, and a launch. A view's test at a
// column that passes its static gates needs its two keys (8 bytes) and
// its descriptor (16), less where one test already rejects: the left view
// at every grid point of a live row, the right view at u - dL where the
// left accepts; the grid is 2 bytes a point. At 640x480, step 5 that is
// at most 0.59 MB, some 0.00018 ms; the launch itself takes longer.
//
// The design. A block of 128 threads owns one (frame, grid row) and a
// thread one grid column at a time: the right view is accepted only at the
// one column the check reads (u - dL), so no row of dR is built. Loads are
// a thread's own: two key words and a 16-byte descriptor a view.
namespace {

constexpr int kEpThreads = 128;

__global__ void __launch_bounds__(kEpThreads)
support_epilogue_kernel(const int32_t* __restrict__ keys,
                        const uint4* __restrict__ desc1,
                        const uint4* __restrict__ desc2, Epilogue e, int H,
                        int W, int step, int nv) {
  const int j = blockIdx.x, b = blockIdx.y;
  const size_t N = static_cast<size_t>(gridDim.y) * nv * W;
  const int32_t* row =
      j > 0 ? keys + (static_cast<size_t>(b) * nv + j - 1) * W : nullptr;
  support_epilogue_row(e, row, N, desc1, desc2, b, j, nv + 1, H, W, step);
}

}  // namespace

// keys: int32 [4, B, nv, W], nv = ncv - 1 (unread when nv = 0); desc1,
// desc2: u8 [B, H, W, 16] (16-byte aligned); grid: int16 [B, ncv, ncu].
// One launch.
extern "C" int support_epilogue(const int32_t* keys, const uint8_t* desc1,
                                const uint8_t* desc2, int16_t* grid, int B,
                                int H, int W, int step, int disp_min,
                                int disp_max, int texture, int lr, float thr,
                                void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || step < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ncv = (H + step - 1) / step, ncu = (W + step - 1) / step;
  const Epilogue e{grid, ncu, disp_min, disp_max, texture, lr, thr};
  support_epilogue_kernel<<<dim3(ncv, B), kEpThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      keys, reinterpret_cast<const uint4*>(desc1),
      reinterpret_cast<const uint4*>(desc2), e, H, W, step, ncv - 1);
  return static_cast<int>(cudaGetLastError());
}

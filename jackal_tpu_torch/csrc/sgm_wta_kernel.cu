// SGM winner-take-all maps of both views in one read of the path sum.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/sgm_kernel.py
// (_wta_maps_kernel l.415, pallas_call in sgm_wta_maps_pallas l.506). The
// plain PyTorch version of the same function is sgm_wta_maps_plain in
// jackal_tpu_torch/ops/sgm_kernel.py (wta_maps of matching/sgm.py on the
// volume and on its right view); the wrapper is ops/sgm_kernel.sgm_wta_maps.
//
// What it computes. S is int16 [B, H, D, W], D >= 2, with values in
// [0, 28000] (the path sum's range, _CARRY_BIG). For each pixel (b, v, u)
// and each view, five statistics over d: the best (least) value, the FIRST
// d that has it, the least value outside best_d +- 1, and the values at
// best_d - 1 and best_d + 1 (30000 where the d does not exist or no d is
// left). The left view reads S[d, v, u]; the right view reads SR[d, v, u] =
// S[d, v, u + d], and 12000 (the cost volume's "no such pair" sentinel,
// not the carry clamp) where u + d >= W, as both reference engines do:
// at the right border that sentinel can win the right view's WTA, and it
// must. out is int16 [B, H, 10, W]: the left view's five rows, then the
// right view's.
//
// What bounds it on an H100. The least work is one read of S and the
// writes of the maps: 2 D + 20 bytes a pixel, 39.3 MB + 6.1 MB for a
// 640x480 frame at D = 64, 0.0136 ms at 3.35 TB/s; the arithmetic is
// below that at the card's 32-bit integer rate, so it is bound by bytes.
// What keeps a simple design from it is latency: a thread that walks its
// column's D values with scalar loads, or loads them a few d at a time,
// waits on device memory many times a view; and a walk over d is a chain
// of dependent minima.
//
// The design. A block takes one (frame, row) and 128 columns, a thread
// two neighbouring columns as one 16-bit pair:
//  - staging: the block copies the row's [D, 128 + halo] slab of S into
//    shared memory with 16-byte cp.async copies, all in flight at once,
//    one wait (the halo, at least D + 1 columns, holds the right view's
//    S[d, u + d]; columns past W read 12000). Where W is not a multiple of
//    8, a row does not start on 16 bytes and the block loads it by values;
//  - both views read that slab: the left view the aligned pair of its
//    columns, the right view the pair at column + d of row d (one 32-bit
//    load for even d, two and a byte permute for odd d);
//  - best and its first d: one 32-bit minimum of key = value << 8 | d
//    (the value fits 16 bits, d 8) a column, built by one byte permute;
//    four running minima over d break the dependency chain. Keys are
//    distinct, so the order of the minima does not matter;
//  - the second best: the values at best_d +- 1 are read, the slots best_d
//    - 1 .. best_d + 1 of the column are set to 0xffff, and one __vminu2
//    walk over all d (both columns an instruction) takes the least value
//    left; 0xffff left means no d was. A slab value is read by exactly one
//    left column and one right column, so the left view sets and then
//    restores its slots, and the right view, after a barrier, sets its own;
//  - the maps are stored as pairs.
// Device memory sees S about once (a halo is the next tile's columns, read
// from L2) and the maps once.
//
// D > 256: the slab (D rows of at least D + 136 columns) outgrows shared
// memory past D = 256 and d no longer fits the key's 8 bits, so the
// launcher takes a second, simple kernel there, sgm_wta_maps_wide_kernel:
// a thread a (frame, row, column) walks d in device memory (a warp's 32
// columns are one coalesced load a d), two walks a view: the least key
// value << 16 | d (values <= 30000 < 2^15, d < 2^16), then the least value
// outside best_d +- 1 (D <= 32767, best_d's int16). It reads S four
// times, mostly from L2. D <= 256 keeps the slab kernel above.
//
// F with O2 folded in (sgm_wta_epilogue_kernel, entry sgm_wta_epilogue):
// the same walks, then the SGM epilogue (csrc/sgm_epilogue.cuh, kernel
// O2's functions) in the same launch, so the ten maps never reach device
// memory: S in, dL, dR and the u8 map out, 2 D + 9 bytes a pixel (42.1 MB
// at 640x480, D = 64, 0.0126 ms at 3.35 TB/s). The left view's L/R check
// at column u reads dR at u - s, s in [0, D], up to D columns left of the
// tile, so a block's slab starts a halo of D columns (rounded up to 8)
// left of its kFoldTile columns, and the right view walks the halo and the
// tile: each of its pairs sets, walks and restores its own slots (no other
// right column reads them; the slab stays as it was for the left view),
// computes its two disparities from the statistics in registers and puts
// them in a float row of shared memory, and writes dR for the tile's
// columns. After a barrier the left view walks the tile, computes dL,
// looks dR up in that row, applies the check and writes dL and the u8 map.
// A block has a thread a right-view pair (rounded up to a warp). Where the
// slab and the row pass the card's 227 KB of shared memory a block (D past
// 183 at the 256-column tile) the launcher refuses. The wrapper takes the
// fold up to D = 64, where it was measured faster than F then O2 (past it
// the slab cuts the blocks an SM holds), and F then O2 elsewhere and for
// true_right (ops/sgm_kernel.sgm_tail_route). kFoldTile is 256 columns
// (at D = 64 the halo adds a quarter to the right view's walks; a
// 128-column tile was slower than F then O2).
#include <cstdint>
#include <cuda_runtime.h>

#include "sgm_epilogue.cuh"

namespace {

constexpr int kThreads = 64;            // a thread takes two columns
constexpr int kTile = 2 * kThreads;     // columns a block
constexpr uint32_t kWtaBig = 30000;     // a statistic with no d
constexpr uint16_t kInvalid = 12000;    // the right view past the border
constexpr uint32_t kOut = 0xffffu;      // a value out of the second walk

// columns of a slab row: the tile and a halo of at least D + 1 (the right
// view's odd-d pairs read one column past u + d), a multiple of 8
__host__ __device__ constexpr int row_len(int D) {
  return kTile + (D + 8) / 8 * 8;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ uint32_t half(uint32_t x, int h) {
  return h ? x >> 16 : x & 0xffffu;
}

// key = value << 8 | d of the low or high column of a pair; d < 256, so
// byte 1 of d is 0 and fills the key's top byte
__device__ __forceinline__ uint32_t key_lo(uint32_t w, uint32_t d) {
  return __byte_perm(w, d, 0x5104);
}
__device__ __forceinline__ uint32_t key_hi(uint32_t w, uint32_t d) {
  return __byte_perm(w, d, 0x5324);
}

// Stores a pair of int16 statistics at columns u, u + 1 of a map row.
__device__ __forceinline__ void store_pair(int16_t* row, int u, int W,
                                           uint32_t lo, uint32_t hi) {
  if (u >= W) return;
  if (u + 1 < W && (reinterpret_cast<uintptr_t>(row + u) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(row + u) = lo | (hi << 16);
    return;
  }
  row[u] = static_cast<int16_t>(lo);
  if (u + 1 < W) row[u + 1] = static_cast<int16_t>(hi);
}

// A view of the slab for the thread's columns c, c + 1 (c = 2 p):
// pair<kOdd>(d) is the view's two values at d (d odd iff kOdd), at(d, h)
// the address of column h's.
template <bool kRight>
struct View {
  const uint16_t* x;   // the slab, rows of L columns
  int L, c;
  template <bool kOdd>
  __device__ __forceinline__ uint32_t pair(int d) const {
    const uint16_t* r = x + d * L + c + (kRight ? d : 0);
    if (!kRight || !kOdd) return *reinterpret_cast<const uint32_t*>(r);
    return __byte_perm(*reinterpret_cast<const uint32_t*>(r - 1),
                       *reinterpret_cast<const uint32_t*>(r + 1), 0x5432);
  }
  __device__ __forceinline__ uint16_t* at(int d, int h) const {
    return const_cast<uint16_t*>(x) + d * L + c + (kRight ? d : 0) + h;
  }
};

struct Stats {
  uint32_t key[2], cm[2], cp[2];
};

// Pass 1: the least key of each column, and the values at best_d +- 1.
template <bool kRight>
__device__ __forceinline__ Stats best_of(const View<kRight>& v, int D) {
  uint32_t k0 = ~0u, k1 = ~0u, k2 = ~0u, k3 = ~0u;
  int d = 0;
#pragma unroll 4
  for (; d + 1 < D; d += 2) {
    const uint32_t a = v.template pair<false>(d);
    const uint32_t b = v.template pair<true>(d + 1);
    k0 = min(k0, key_lo(a, d));
    k1 = min(k1, key_hi(a, d));
    k2 = min(k2, key_lo(b, d + 1));
    k3 = min(k3, key_hi(b, d + 1));
  }
  if (d < D) {
    const uint32_t a = v.template pair<false>(d);
    k0 = min(k0, key_lo(a, d));
    k1 = min(k1, key_hi(a, d));
  }
  Stats st;
  st.key[0] = min(k0, k2);
  st.key[1] = min(k1, k3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bd = st.key[h] & 255u;
    st.cm[h] = bd > 0 ? *v.at(bd - 1, h) : kWtaBig;
    st.cp[h] = bd < D - 1 ? *v.at(bd + 1, h) : kWtaBig;
  }
  return st;
}

// Sets (or, with the values, restores) the slots best_d - 1 .. best_d + 1
// of each column.
template <bool kRight>
__device__ __forceinline__ void mark(const View<kRight>& v, const Stats& st,
                                     int D, bool restore) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bd = st.key[h] & 255u;
    if (bd > 0) *v.at(bd - 1, h) = restore ? st.cm[h] : kOut;
    *v.at(bd, h) = restore ? st.key[h] >> 8 : kOut;
    if (bd < D - 1) *v.at(bd + 1, h) = restore ? st.cp[h] : kOut;
  }
}

// Pass 2: the least value left in each column, as a pair.
template <bool kRight>
__device__ __forceinline__ uint32_t second_of(const View<kRight>& v, int D) {
  uint32_t m0 = ~0u, m1 = ~0u;
  int d = 0;
#pragma unroll 4
  for (; d + 1 < D; d += 2) {
    m0 = __vminu2(m0, v.template pair<false>(d));
    m1 = __vminu2(m1, v.template pair<true>(d + 1));
  }
  if (d < D) m0 = __vminu2(m0, v.template pair<false>(d));
  return __vminu2(m0, m1);
}

__device__ __forceinline__ void store(int16_t* o, int u, int W,
                                      const Stats& st, uint32_t m) {
  uint32_t second[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    second[h] = half(m, h) == kOut ? kWtaBig : half(m, h);
  store_pair(o, u, W, st.key[0] >> 8, st.key[1] >> 8);
  store_pair(o + W, u, W, st.key[0] & 255u, st.key[1] & 255u);
  store_pair(o + 2 * W, u, W, second[0], second[1]);
  store_pair(o + 3 * W, u, W, st.cm[0], st.cm[1]);
  store_pair(o + 4 * W, u, W, st.cp[0], st.cp[1]);
}

__global__ void __launch_bounds__(kThreads)
sgm_wta_maps_kernel(const uint16_t* __restrict__ S, int16_t* __restrict__ out,
                    int H, int D, int W) {
  extern __shared__ uint4 smem[];
  uint16_t* x = reinterpret_cast<uint16_t*>(smem);
  const int L = row_len(D);
  const int u0 = blockIdx.x * kTile, c = 2 * threadIdx.x, u = u0 + c;
  const size_t row = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const uint16_t* s = S + row * D * W;

  // stage [D, L] columns u0 .. u0 + L - 1 of the row, 12000 past W
  if (W % 8 == 0) {
    const int chunks = L / 8;
    for (int i = threadIdx.x; i < D * chunks; i += kThreads) {
      const int d = i / chunks, k = 8 * (i - d * chunks);
      uint16_t* dst = x + d * L + k;
      if (u0 + k < W) {
        cp_async16(dst, s + static_cast<size_t>(d) * W + u0 + k);
      } else {
        const uint32_t inv = kInvalid | (static_cast<uint32_t>(kInvalid) << 16);
        *reinterpret_cast<uint4*>(dst) = make_uint4(inv, inv, inv, inv);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
#pragma unroll 8
    for (int i = threadIdx.x; i < D * L; i += kThreads) {
      const int d = i / L, k = i - d * L;
      x[i] = u0 + k < W ? __ldg(s + static_cast<size_t>(d) * W + u0 + k)
                        : kInvalid;
    }
  }
  __syncthreads();

  const View<false> left{x, L, c};
  const View<true> right{x, L, c};
  const Stats sl = best_of(left, D);
  const Stats sr = best_of(right, D);
  __syncthreads();          // every right view has read its pass-1 values
  mark(left, sl, D, false);
  const uint32_t ml = second_of(left, D);
  mark(left, sl, D, true);
  __syncthreads();          // every left view is done with the slab
  mark(right, sr, D, false);
  const uint32_t mr = second_of(right, D);

  int16_t* o = out + row * 10 * W;
  store(o, u, W, sl, ml);
  store(o + 5 * W, u, W, sr, mr);
}

constexpr int kWideThreads = 128;       // columns a block, D > 256
constexpr int kSlabMaxD = 256;          // the slab kernel's largest D

// The D > 256 path: a thread a (frame, row, column), both views.
__global__ void __launch_bounds__(kWideThreads)
sgm_wta_maps_wide_kernel(const uint16_t* __restrict__ S,
                         int16_t* __restrict__ out, int H, int D, int W) {
  const int u = blockIdx.x * kWideThreads + threadIdx.x;
  if (u >= W) return;
  const size_t row = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const uint16_t* s = S + row * D * W;
  int16_t* o = out + row * 10 * W;
#pragma unroll 1
  for (int view = 0; view < 2; ++view) {
    // the view's value at d: S[d, u] or, right, S[d, u + d] (12000 past W)
    auto at = [&](int d) -> uint32_t {
      const int x = u + (view ? d : 0);
      return x < W ? s[static_cast<size_t>(d) * W + x] : kInvalid;
    };
    uint32_t key = ~0u;
    for (int d = 0; d < D; ++d) key = min(key, at(d) << 16 | d);
    const int bd = key & 0xffffu;
    uint32_t second = kWtaBig;
    for (int d = 0; d < bd - 1; ++d) second = min(second, at(d));
    for (int d = bd + 2; d < D; ++d) second = min(second, at(d));
    const uint32_t st[5] = {key >> 16, static_cast<uint32_t>(bd), second,
                            bd > 0 ? at(bd - 1) : kWtaBig,
                            bd < D - 1 ? at(bd + 1) : kWtaBig};
#pragma unroll
    for (int i = 0; i < 5; ++i)
      o[(5 * view + i) * W + u] = static_cast<int16_t>(st[i]);
  }
}

constexpr int kFoldTile = 256;             // columns a block of the fold
// a thread a right-view pair at the largest D
constexpr int kFoldMaxThreads = (kSlabMaxD + kFoldTile) / 2;
constexpr int kSmemMax = 227 * 1024;        // shared memory a block, H100

// the fold's left halo: the L/R check at column u reads dR at u - s, s <= D
__host__ __device__ constexpr int fold_halo(int D) { return (D + 7) / 8 * 8; }
// a slab row of the fold: the halo, the tile and the right view's reach
__host__ __device__ constexpr int fold_row_len(int D) {
  return fold_halo(D) + kFoldTile + (D + 8) / 8 * 8;
}
// the slab and the right view's float row
constexpr long long fold_smem(int D) {
  return 2LL * D * fold_row_len(D) + 4LL * (fold_halo(D) + kFoldTile);
}

// a view's disparity at column h of a pair from its statistics
__device__ __forceinline__ float disp_of(const Stats& st, uint32_t m, int h,
                                         int D, float ratio) {
  const uint32_t second = half(m, h);
  return sgm_wta_disp(static_cast<int>(st.key[h] >> 8),
                      static_cast<int>(st.key[h] & 255u),
                      static_cast<int>(second == kOut ? kWtaBig : second),
                      static_cast<int>(st.cm[h]), static_cast<int>(st.cp[h]),
                      D, ratio);
}

template <typename T>
__device__ __forceinline__ void store2(T* row, int u, int W, T a, T b) {
  if (u >= W) return;
  row[u] = a;
  if (u + 1 < W) row[u + 1] = b;
}

__global__ void __launch_bounds__(kFoldMaxThreads)
sgm_wta_epilogue_kernel(const uint16_t* __restrict__ S,
                        float* __restrict__ dl, float* __restrict__ dr,
                        uint8_t* __restrict__ u8, int H, int D, int W,
                        float ratio, float lr) {
  extern __shared__ uint4 smem[];
  uint16_t* x = reinterpret_cast<uint16_t*>(smem);
  const int halo = fold_halo(D), L = fold_row_len(D);
  float* rdisp = reinterpret_cast<float*>(x + D * L);   // [halo + tile]
  const int T = blockDim.x;
  const int u0 = blockIdx.x * kFoldTile;
  const int x0 = u0 - halo;               // the slab's first column
  const size_t row = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const uint16_t* s = S + row * D * W;

  // stage [D, L] columns x0 .. x0 + L - 1 of the row, 12000 outside [0, W)
  if (W % 8 == 0) {
    const int chunks = L / 8;
    for (int i = threadIdx.x; i < D * chunks; i += T) {
      const int d = i / chunks, k = 8 * (i - d * chunks);
      uint16_t* dst = x + d * L + k;
      const int col = x0 + k;             // a multiple of 8, as W is
      if (col >= 0 && col < W) {
        cp_async16(dst, s + static_cast<size_t>(d) * W + col);
      } else {
        const uint32_t inv = kInvalid | (static_cast<uint32_t>(kInvalid) << 16);
        *reinterpret_cast<uint4*>(dst) = make_uint4(inv, inv, inv, inv);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
#pragma unroll 8
    for (int i = threadIdx.x; i < D * L; i += T) {
      const int d = i / L, col = x0 + (i - d * L);
      x[i] = col >= 0 && col < W
                 ? __ldg(s + static_cast<size_t>(d) * W + col)
                 : kInvalid;
    }
  }
  __syncthreads();

  // the right view over the halo and the tile; pairs wholly outside [0, W)
  // are read by no lookup
  float* dr_row = dr + row * W;
  for (int p = threadIdx.x; p < (halo + kFoldTile) / 2; p += T) {
    const int c = 2 * p, u = x0 + c;
    if (u + 1 < 0 || u >= W) continue;
    const View<true> v{x, L, c};
    const Stats st = best_of(v, D);
    mark(v, st, D, false);
    const uint32_t m = second_of(v, D);
    mark(v, st, D, true);
    const float a = disp_of(st, m, 0, D, ratio);
    const float b = disp_of(st, m, 1, D, ratio);
    rdisp[c] = a;
    rdisp[c + 1] = b;
    if (u >= u0) store2(dr_row, u, W, a, b);
  }
  __syncthreads();              // the slab restored, the right row written

  // the left view over the tile, its L/R check and u8 map
  float* dl_row = dl + row * W;
  uint8_t* u8_row = u8 != nullptr ? u8 + row * W : nullptr;
  for (int p = threadIdx.x; p < kFoldTile / 2; p += T) {
    const int u = u0 + 2 * p;
    if (u >= W) break;
    const View<false> v{x, L, halo + 2 * p};
    const Stats st = best_of(v, D);
    mark(v, st, D, false);
    const uint32_t m = second_of(v, D);
    float out[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float dL = disp_of(st, m, h, D, ratio);
      const int j = sgm_lr_column(u + h, dL, W, D);
      const float other = j >= 0 && j < W ? rdisp[j - x0] : -1e9f;
      out[h] = sgm_lr_keep(dL, other, lr);
    }
    store2(dl_row, u, W, out[0], out[1]);
    if (u8_row != nullptr)
      store2(u8_row, u, W, sgm_u8(out[0]), sgm_u8(out[1]));
  }
}

}  // namespace

extern "C" int sgm_wta_maps(const int16_t* S, int16_t* out, int B, int H,
                            int D, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 2 || D > 32767 || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > kSlabMaxD) {
    const dim3 grid((W + kWideThreads - 1) / kWideThreads, H, B);
    sgm_wta_maps_wide_kernel<<<grid, kWideThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint16_t*>(S), out, H, D, W);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = D * row_len(D) * static_cast<int>(sizeof(uint16_t));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgm_wta_maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + kTile - 1) / kTile, H, B);
  sgm_wta_maps_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint16_t*>(S), out, H, D, W);
  return static_cast<int>(cudaGetLastError());
}

// F with O2 folded in: dl, dr float32 [B, H, W] and, where u8 is not null,
// the u8 map of dl, from S int16 [B, H, D, W] in one launch. Refuses D past
// 256 and a slab past the card's shared memory (fold_smem, D past 183);
// the wrapper routes such shapes to F then O2 before it launches.
extern "C" int sgm_wta_epilogue(const int16_t* S, float* dl, float* dr,
                                uint8_t* u8, int B, int H, int D, int W,
                                float ratio, float lr, void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 2 || D > kSlabMaxD || H > 65535 ||
      B > 65535 || fold_smem(D) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(fold_smem(D));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sgm_wta_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = ((fold_halo(D) + kFoldTile) / 2 + 31) / 32 * 32;
  const dim3 grid((W + kFoldTile - 1) / kFoldTile, H, B);
  sgm_wta_epilogue_kernel<<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint16_t*>(S), dl, dr, u8, H, D, W, ratio, lr);
  return static_cast<int>(cudaGetLastError());
}

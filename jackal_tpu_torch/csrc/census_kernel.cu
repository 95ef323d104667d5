// SGM census transform: 24-bit 5x5 census codes of a batch of images.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/sgm_kernel.py
// (_census_kernel, pallas_call in census5x5_pallas l.374). The plain
// PyTorch version of the same function is census5x5 in
// jackal_tpu_torch/matching/sgm.py; the wrapper is
// ops/sgm_kernel.census5x5_batch.
//
// What it computes. img is uint8 [N, H, W]; out[n, v, u] is int32 with bit
// k set where the k-th neighbour of the 5x5 window, visited dv-major then
// du (-2..2 each, the centre skipped), is darker than the centre.
// Coordinates are clamped into the image, which is the reference's
// edge-mode padding. The node launches it once for the left and right
// batches together (N = 2B): census5x5_pair reads the two batches where
// they lie (frames n < B from the left, the rest from the right), so no
// copy joins them first.
//
// What bounds it on an H100. Each pixel needs one byte read and four bytes
// written, 3.1 MB for a 640x480 pair (0.9 us at 3.35 TB/s), and 24
// compares whose bits make the code. The first design (one thread a
// pixel, 25 scalar byte loads each behind its own clamp, a compare and a
// bit insert each) issued ~200 instructions a pixel. This design:
// - a thread computes 4 adjacent pixels of kRows rows, in byte lanes of
//   32-bit words: a row of the window is three words (columns u-4..u+7),
//   loaded once (4-byte loads, coalesced across the warp) and reused by
//   the kRows + 4 output rows that read it; its five neighbour words
//   (du = -2..2) are byte permutes of those three;
// - a compare of 4 pixels at once: x = (N | 0x80) - (C & 0x7f) per byte
//   (no borrow crosses a byte) holds "low 7 bits of N >= those of C" in
//   each byte's bit 7, and one LOP3 of N, C and x gives N < C there;
// - the 8 compares of a code byte shift into one word ((T >> 1) | bit 7),
//   so the 24 compares cost 4 instructions per 4 pixels each; a 4x4 byte
//   transpose (8 PRMT) turns the three words into the 4 codes, written as
//   one 16-byte store;
// - kRows is 8, 4 or 2, the most that still leaves 2048 warps: more rows
//   share more row words, more warps hide the loads' latency at a small
//   batch (measured: 2 rows at the SGM node, 4 at its batch 2, 8 at
//   BASELINE config 3);
// - the column clamp is done once a row word, where a thread's words reach
//   past the image; the row clamp once a row. The rows stay in registers:
//   a shared-memory tile of rows and halo, clamped once at staging, was
//   measured 37-41 % slower (L1 already serves each word's three reads,
//   and the tile adds a staging pass and a barrier). Widths that are not a
//   multiple of 4 (or under 8) take a byte-wise staging of the same words
//   and scalar stores.
// The least count of this packing is 26 instructions a pixel (24 compares
// at 4 instructions per 4 pixels, 2 PRMT of the transpose; the row words'
// permutes are shared by kRows + 4 rows), against 48 as a compare and a
// bit insert each (chip_smoke.sgm_work).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroupsX = 32;      // 4-pixel groups a block row (one warp)
constexpr int kTilesY = 4;        // row tiles a block (warps)
constexpr uint32_t kHigh = 0x80808080u;

// A row of the window for 4 pixels u..u+3: its five neighbour words
// (du = -2..2) raw and with every byte's bit 7 set.
struct RowWords {
  uint32_t n[5], nh[5];
};

__device__ __forceinline__ RowWords row_words(uint32_t wm, uint32_t w0,
                                              uint32_t wp) {
  RowWords r;
  r.n[0] = __byte_perm(wm, w0, 0x5432);   // columns u-2 .. u+1
  r.n[1] = __byte_perm(wm, w0, 0x6543);   // u-1 .. u+2
  r.n[2] = w0;                            // u .. u+3
  r.n[3] = __byte_perm(w0, wp, 0x4321);   // u+1 .. u+4
  r.n[4] = __byte_perm(w0, wp, 0x5432);   // u+2 .. u+5
#pragma unroll
  for (int i = 0; i < 5; ++i) r.nh[i] = r.n[i] | kHigh;
  return r;
}

// the window row's three words, clamped into the image (any W)
template <bool kAligned>
__device__ __forceinline__ RowWords load_row(const uint8_t* __restrict__ row,
                                             int u, int W) {
  uint32_t wm, w0, wp;
  if (kAligned) {   // W % 4 == 0 and W >= 8: u % 4 == 0, u + 3 < W
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row) + (u >> 2);
    w0 = __ldg(p);
    wm = u > 0 ? __ldg(p - 1) : __byte_perm(w0, 0u, 0x0000);
    wp = u + 4 < W ? __ldg(p + 1) : __byte_perm(w0, 0u, 0x3333);
  } else {
    uint32_t w[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      uint32_t x = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x |= static_cast<uint32_t>(
                 __ldg(row + min(max(u - 4 + 4 * i + k, 0), W - 1)))
             << (8 * k);
      w[i] = x;
    }
    wm = w[0];
    w0 = w[1];
    wp = w[2];
  }
  return row_words(wm, w0, wp);
}

// The 4 codes of pixels u..u+3 from the five window rows R[0..4]
// (dv = -2..2).
__device__ __forceinline__ uint4 codes4(const RowWords* R) {
  const uint32_t c = R[2].n[2];
  const uint32_t clow = c & ~kHigh;
  uint32_t T[3] = {0u, 0u, 0u};
  int k = 0;
#pragma unroll
  for (int dv = 0; dv < 5; ++dv) {
#pragma unroll
    for (int du = 0; du < 5; ++du) {
      if (dv == 2 && du == 2) continue;
      const uint32_t n = R[dv].n[du];
      const uint32_t x = R[dv].nh[du] - clow;
      // bit 7 of each byte: n < c (byte-wise, unsigned)
      const uint32_t lt = ~((n & ~c) | (~(n ^ c) & x));
      T[k >> 3] = (T[k >> 3] >> 1) | (lt & kHigh);
      ++k;
    }
  }
  // byte i of T[g] holds bits 8g..8g+7 of pixel i's code: transpose
  const uint32_t a = __byte_perm(T[0], T[1], 0x5140);
  const uint32_t b = __byte_perm(T[0], T[1], 0x7362);
  const uint32_t e = __byte_perm(T[2], 0u, 0x5140);
  const uint32_t f = __byte_perm(T[2], 0u, 0x7362);
  return make_uint4(__byte_perm(a, e, 0x5410), __byte_perm(a, e, 0x7632),
                    __byte_perm(b, f, 0x5410), __byte_perm(b, f, 0x7632));
}

// kRows output rows a thread: more rows share more row words, fewer rows
// give more warps to hide the loads' latency at small batches
template <bool kAligned, int kRows>
__global__ void __launch_bounds__(kGroupsX* kTilesY)
    census5x5_kernel(const uint8_t* __restrict__ img,
                     const uint8_t* __restrict__ img2, int n1,
                     int32_t* __restrict__ out, int H, int W) {
  const int u = 4 * (blockIdx.x * kGroupsX + threadIdx.x);
  const int v0 = (blockIdx.y * kTilesY + threadIdx.y) * kRows;
  if (u >= W || v0 >= H) return;
  // frames n1.. lie in img2
  const int z = blockIdx.z;
  const uint8_t* p = z < n1 ? img + static_cast<size_t>(z) * H * W
                            : img2 + static_cast<size_t>(z - n1) * H * W;
  int32_t* o = out + static_cast<size_t>(blockIdx.z) * H * W;
  RowWords R[kRows + 4];
#pragma unroll
  for (int i = 0; i < kRows + 4; ++i)
    R[i] = load_row<kAligned>(
        p + static_cast<size_t>(min(max(v0 - 2 + i, 0), H - 1)) * W, u, W);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int v = v0 + j;
    if (v >= H) break;
    const uint4 c = codes4(R + j);
    int32_t* dst = o + static_cast<size_t>(v) * W + u;
    if (kAligned) {
      *reinterpret_cast<uint4*>(dst) = c;
    } else {
      const uint32_t cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (u + i < W) dst[i] = static_cast<int32_t>(cs[i]);
    }
  }
}

template <bool kAligned, int kRows>
int launch(const uint8_t* img, const uint8_t* img2, int n1, int32_t* out,
           int N, int H, int W, cudaStream_t stream) {
  const int rows_a_block = kRows * kTilesY;
  if ((H + rows_a_block - 1) / rows_a_block > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kGroupsX, kTilesY);
  const dim3 grid((W + 4 * kGroupsX - 1) / (4 * kGroupsX),
                  (H + rows_a_block - 1) / rows_a_block, N);
  census5x5_kernel<kAligned, kRows><<<grid, block, 0, stream>>>(
      img, img2, n1, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

// warps for a thread's rows, at kRows rows a thread
static long long warps_at(int N, int H, int W, int rows) {
  return 1LL * N * ((W + 4 * kGroupsX - 1) / (4 * kGroupsX)) * kTilesY *
         ((H + rows * kTilesY - 1) / (rows * kTilesY));
}

}  // namespace

// The rows a thread computes: the most of 8, 4, 2 that still leaves 2048
// warps (16 an SM of an H100) to hide the row loads' latency. Measured on
// the H100: 2 rows at the SGM node's 2 x 640x480, 4 at its batch 2
// (4 x 640x480; 2 rows there take 10 % longer), 8 at config 3's
// 8 x 1280x960.
static int census_frames(const uint8_t* img, const uint8_t* img2, int n1,
                         int32_t* out, int N, int H, int W, void* stream) {
  if (N < 1 || H < 1 || W < 1 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 != 0 || W < 8)
    return launch<false, 2>(img, img2, n1, out, N, H, W, s);
  if (warps_at(N, H, W, 8) >= 2048)
    return launch<true, 8>(img, img2, n1, out, N, H, W, s);
  if (warps_at(N, H, W, 4) >= 2048)
    return launch<true, 4>(img, img2, n1, out, N, H, W, s);
  return launch<true, 2>(img, img2, n1, out, N, H, W, s);
}

extern "C" int census5x5(const uint8_t* img, int32_t* out, int N, int H,
                         int W, void* stream) {
  return census_frames(img, img, N, out, N, H, W, stream);
}

// The codes of B left frames, then of B right frames, into out [2B, H, W]:
// one launch, each batch read where it lies.
extern "C" int census5x5_pair(const uint8_t* left, const uint8_t* right,
                              int32_t* out, int B, int H, int W,
                              void* stream) {
  if (B < 1 || B > 65535 / 2) return static_cast<int>(cudaErrorInvalidValue);
  return census_frames(left, right, B, out, 2 * B, H, W, stream);
}

// ELAS dense MAP matching of one view: a keyed minimum over candidates.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/elas_dense_kernel.py
// (_elas_dense_kernel, pallas_call at l.245, wrapper elas_dense_pallas
// l.146). The plain PyTorch version of the same function is
// dense_match_plain in matching/elas/dense.py.
//
// What it computes, per pixel (b, v, u), with q/t the query/target
// descriptors [B, H, W, 16] (left view: q = left, t = right, sign = -1;
// right view: swapped, sign = +1) and row v' = clamp(v, 2, H-3):
//   pixel_ok = covered && 2 <= u < W-2 && sum|q(v',u) - 128| >= match_texture
//   candidates d: bit d of the pixel's grid cell (v/gs, u/gs), or the plane
//     window max(dp-r, 0) <= d <= min(dp+r, D-1), with 2 <= u + sign*d < W-2
//   key = (SAD16(q(v',u), t(v',u+sign*d)) + [window] valid*P[|d-dp|] + 16)
//         * 512 + (window ? 256 + d : d)
//   out = !pixel_ok ? -10 : no candidate ? -1 : (min key % 512) % 256
// The rank makes every key unique, so the minimum is independent of the
// visit order; candidates are still visited in ascending d.
//
// What bounds it on an H100. ELAS evaluates only a few tens of candidates
// per pixel (the grid cell's set plus a 5-wide window), so per frame the
// work is H*W*(candidates per pixel)*16 byte-SADs, ~1e8-5e8 at 640x480,
// against ~6 MB of input: a small, data-dependent amount of integer work,
// bound by latency and divergence more than by bytes or operations. The
// design: one thread per pixel; the grid's candidate set arrives
// bit-packed (32 d per word, packed on the host by dense.pack_grid where
// the native prior makes the grid), so a thread reads ceil(D/32) words of
// its cell, ORs in its window bits, masks
// the warp-invalid d range, and walks only the set bits with __ffs; each
// candidate costs one 16-byte __ldg of the target and four __vsadu4. The
// TPU kernel instead swept all D per pixel with a live-chunk skip; the
// sparsity comes for free here.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxRadius = 7;

// P[|d - d_plane|] for |d - d_plane| <= plane radius, passed by value
struct PriorTable {
  int p[kMaxRadius + 1];
};

namespace {

constexpr int kBig = 1 << 30;
constexpr int kWindow = 2;
constexpr int kKeyBias = 16;

__device__ __forceinline__ int sad16(const uint4& a, const uint4& b) {
  return static_cast<int>(__vsadu4(a.x, b.x) + __vsadu4(a.y, b.y) +
                          __vsadu4(a.z, b.z) + __vsadu4(a.w, b.w));
}

// bits lo..hi (0 <= lo <= hi <= 31) set
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
  const uint32_t upto_hi = hi >= 31 ? 0xFFFFFFFFu : ((1u << (hi + 1)) - 1u);
  return upto_hi & ~((1u << lo) - 1u);
}

__global__ void elas_dense_kernel(
    const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
    const int32_t* __restrict__ d_plane, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ covered, const uint32_t* __restrict__ grid,
    float* __restrict__ out, int H, int W, int D, int gh, int gw, int nw,
    int gs, int radius, int sign, int match_texture, PriorTable P) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (u >= W || v >= H) return;
  const size_t pix = (static_cast<size_t>(b) * H + v) * W + u;
  const int vr = min(max(v, 2), H - 3);
  const size_t row = (static_cast<size_t>(b) * H + vr) * W;
  const uint4* qrow = reinterpret_cast<const uint4*>(q) + row;
  const uint4* trow = reinterpret_cast<const uint4*>(t) + row;

  const uint4 qq = __ldg(qrow + u);
  const int tex = sad16(qq, make_uint4(0x80808080u, 0x80808080u,
                                       0x80808080u, 0x80808080u));
  if (!covered[pix] || u < kWindow || u >= W - kWindow ||
      tex < match_texture) {
    out[pix] = -10.0f;
    return;
  }
  const int dp = d_plane[pix];
  const int prior = valid[pix] ? 1 : 0;
  const int wlo = max(dp - radius, 0);
  const int whi = min(dp + radius, D - 1);
  // largest d whose warped column u + sign*d stays in [2, W-3]
  const int dwarp = sign < 0 ? u - kWindow : W - kWindow - 1 - u;
  const uint32_t* cell =
      grid + ((static_cast<size_t>(b) * gh + v / gs) * gw + u / gs) * nw;

  int best = kBig;
  for (int w = 0; w < nw; ++w) {
    const int d0 = 32 * w;
    if (d0 > dwarp) break;
    uint32_t bits = __ldg(cell + w);
    const int lo = max(wlo, d0), hi = min(whi, d0 + 31);
    if (lo <= hi) bits |= bit_range(lo - d0, hi - d0);
    if (dwarp < d0 + 31) bits &= bit_range(0, dwarp - d0);
    while (bits) {
      const int d = d0 + __ffs(bits) - 1;
      bits &= bits - 1;
      const bool in_win = d >= wlo && d <= whi;
      int val = sad16(qq, __ldg(trow + u + sign * d));
      if (in_win) {
        const int dd = d > dp ? d - dp : dp - d;
        val += prior * P.p[dd];
      }
      const int key = (val + kKeyBias) * 512 + (in_win ? 256 + d : d);
      best = min(best, key);
    }
  }
  if (best < kBig) {
    int r = best % 512;  // floor modulo, as the plain version's
    if (r < 0) r += 512;
    out[pix] = static_cast<float>(r % 256);
  } else {
    out[pix] = -1.0f;
  }
}

}  // namespace

extern "C" int elas_dense(const uint8_t* q, const uint8_t* t,
                          const int32_t* d_plane, const uint8_t* valid,
                          const uint8_t* covered, const int32_t* grid,
                          float* out, int B, int H, int W, int D, int gh,
                          int gw, int nw, int gs, int radius, int sign,
                          int match_texture, PriorTable P, void* stream) {
  const dim3 block(32, 8);
  const dim3 blocks((W + block.x - 1) / block.x, (H + block.y - 1) / block.y,
                    B);
  elas_dense_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      q, t, d_plane, valid, covered, reinterpret_cast<const uint32_t*>(grid),
      out, H, W, D, gh, gw, nw, gs, radius, sign, match_texture, P);
  return static_cast<int>(cudaGetLastError());
}

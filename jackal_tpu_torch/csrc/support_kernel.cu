// ELAS support-point matching: best-two keys of both views per grid row.
//
// Replaces the TPU kernel jackal_tpu/ops/pallas/support_kernel.py
// (_support_kernel, pallas_call at l.183, wrapper
// support_candidates_pallas l.148). The plain PyTorch version of the same
// function is support_keys_plain in matching/elas/support.py; the wrapper
// there holds the acceptance tests (texture, ratio, bounds, fwd-bwd).
//
// What it computes. Q and T are [B, nv, W, 32] uint8: per support-grid row
// and column, the 16-byte descriptors of rows v-2 and v+2 side by side.
// With S(x, d) = sum over 32 bytes |Q(x) - T(x-d)|:
//   left  key(c, d) = (S(c-2, d) + S(c+2, d)) * 512 + d,  live d+5 <= c <= W-6
//   right key(c, d) = (S(c+d-2, d) + S(c+d+2, d)) * 512 + d, live 5 <= c <= W-5-d
// (cost_R(c, d) = cost_L(c+d, d)), d in [disp_min, D). Per view the kernel
// keeps the two smallest keys; dead keys are KBIG. Keys are unique in d, so
// the best-two set does not depend on the visit order; d still runs
// ascending, the reference's order. Every live key's taps lie inside
// [3, W-3], so no padding or wrap is needed (the TPU kernel rolled over a
// padded width and masked the wrapped columns).
//
// What bounds it on an H100. Per frame (640x480, D = 256, nv = 95) the
// work is ~95*640*256*2 views * 64 byte-SADs = 2.0e9 byte absolute
// differences, on 3.9 MB of input: it is bound by integer operations, not
// bytes. The design: one thread per (b, row, column) computes both views;
// __vsadu4 does four byte SADs and their sum in one instruction; the
// thread's fixed taps (Q(c+-2) for the left view, T(c+-2) for the right)
// stay in registers and the moving taps are 16-byte __ldg loads that
// neighbouring threads issue on neighbouring addresses, served by L1.
// Tiling the moving row through shared memory is left for a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kKBig = 1 << 24;
constexpr int kGap = 5;
constexpr int kThreads = 128;

struct Tap {
  uint4 a, b;  // 32 bytes
};

__device__ __forceinline__ Tap load_tap(const uint4* row, int x) {
  Tap t;
  t.a = __ldg(row + 2 * x);
  t.b = __ldg(row + 2 * x + 1);
  return t;
}

__device__ __forceinline__ int sad32(const Tap& p, const Tap& q) {
  unsigned s = __vsadu4(p.a.x, q.a.x);
  s += __vsadu4(p.a.y, q.a.y);
  s += __vsadu4(p.a.z, q.a.z);
  s += __vsadu4(p.a.w, q.a.w);
  s += __vsadu4(p.b.x, q.b.x);
  s += __vsadu4(p.b.y, q.b.y);
  s += __vsadu4(p.b.z, q.b.z);
  s += __vsadu4(p.b.w, q.b.w);
  return static_cast<int>(s);
}

__device__ __forceinline__ void best_two(int key, int& k1, int& k2) {
  k2 = min(k2, max(k1, key));
  k1 = min(k1, key);
}

__global__ void support_keys_kernel(const uint8_t* __restrict__ Q,
                                    const uint8_t* __restrict__ T,
                                    int32_t* __restrict__ l1,
                                    int32_t* __restrict__ l2,
                                    int32_t* __restrict__ r1,
                                    int32_t* __restrict__ r2,
                                    int nv, int W, int disp_min, int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.z * nv + blockIdx.y;  // b * nv + r
  if (c >= W) return;
  const size_t base = static_cast<size_t>(row) * W;
  const uint4* q = reinterpret_cast<const uint4*>(Q + base * 32);
  const uint4* t = reinterpret_cast<const uint4*>(T + base * 32);

  int a1 = kKBig, a2 = kKBig;  // left view
  if (c <= W - kGap - 1 && c >= kGap + disp_min) {
    const Tap qm = load_tap(q, c - 2);
    const Tap qp = load_tap(q, c + 2);
    const int dmax = min(D - 1, c - kGap);
    for (int d = disp_min; d <= dmax; ++d) {
      const int cost = sad32(qm, load_tap(t, c - 2 - d)) +
                       sad32(qp, load_tap(t, c + 2 - d));
      best_two(cost * 512 + d, a1, a2);
    }
  }
  int b1 = kKBig, b2 = kKBig;  // right view
  if (c >= kGap && c <= W - kGap - disp_min) {
    const Tap tm = load_tap(t, c - 2);
    const Tap tp = load_tap(t, c + 2);
    const int dmax = min(D - 1, W - kGap - c);
    for (int d = disp_min; d <= dmax; ++d) {
      const int cost = sad32(load_tap(q, c + d - 2), tm) +
                       sad32(load_tap(q, c + d + 2), tp);
      best_two(cost * 512 + d, b1, b2);
    }
  }
  l1[base + c] = a1;
  l2[base + c] = a2;
  r1[base + c] = b1;
  r2[base + c] = b2;
}

}  // namespace

extern "C" int support_keys(const uint8_t* Q, const uint8_t* T, int32_t* l1,
                            int32_t* l2, int32_t* r1, int32_t* r2, int B,
                            int nv, int W, int disp_min, int D,
                            void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, nv, B);
  support_keys_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      Q, T, l1, l2, r1, r2, nv, W, disp_min, D);
  return static_cast<int>(cudaGetLastError());
}

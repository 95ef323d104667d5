// Microbenchmark: the card's sustained rate of byte absolute differences
// summed with __vsadu4, the instruction in which both port kernels
// (support_kernel.cu, elas_dense_kernel.cu) spend their arithmetic.
// chip_smoke.py measures it and takes it as the peak operation rate of
// those kernels' roofline bound: no tensor-core instruction computes a sum
// of absolute differences, and the published peak table has no entry for
// it. It is not on the port's path.
//
// The kernels' s += __vsadu4(p, q) compiles to VABSDIFF4.U8.ACC, the add
// folded in. Written that way here, ptxas keeps the add apart (an
// IMAD.IADD beside each SAD), so the loop states the accumulating PTX
// instruction itself. Every thread runs kChains accumulations, each taking
// its operand from its neighbour so nothing can be hoisted out of the loop,
// with enough chains and warps that neither latency nor memory limits the
// rate; the results are stored so the compiler keeps the work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;
constexpr int kUnroll = 16;  // iters must be a multiple of this

// sum over the four bytes of |a - b|, plus c
__device__ __forceinline__ uint32_t sad4_acc(uint32_t a, uint32_t b,
                                             uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__global__ void sad_rate_kernel(uint32_t* __restrict__ out, int iters,
                                uint32_t seed) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc[kChains], y[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) {
    acc[i] = tid * 2654435761u + i;
    y[i] = seed ^ (tid + 0x9E3779B9u * (i + 1));
  }
  for (int k = 0; k < iters; k += kUnroll) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
      for (int i = 0; i < kChains; ++i)
        acc[i] = sad4_acc(acc[(i + 1) % kChains], y[i], acc[i]);
    }
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) s ^= acc[i];
  out[tid] = s;
}

}  // namespace

// byte SADs done by one launch: blocks * threads * iters * kChains * 4
extern "C" int sad_rate(uint32_t* out, int blocks, int threads, int iters,
                        uint32_t seed, void* stream) {
  if (iters % kUnroll) return static_cast<int>(cudaErrorInvalidValue);
  sad_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters, seed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sad_rate_chains() { return kChains; }

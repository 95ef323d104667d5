// The L/R consistency check of one pixel (elas.cpp:909-979), shared by
// kernel H (elas_post_kernel.cu, lr_check_kernel) and kernel B's L/R
// epilogue (elas_dense_kernel.cu). The plain version is
// left_right_consistency_check_plain in matching/elas/post.py; this
// equals it bit for bit: every add is __fadd_rn / __fsub_rn, so nvcc
// contracts nothing into an FFMA.
#pragma once

#include <cuda_runtime.h>

// Pixel u of view a, whose row is a_row, checked against the other view's
// row b_row (both W long): uw = u -/+ d (d/2 under subsampling) is kept
// where d >= 0, 0 <= uw < W and the other view at u -/+ clamp(trunc(uw) -
// u, 0, smax) agrees within thr (-1e9 outside the row), else -10.
__device__ __forceinline__ float lr_one(const float* a_row, const float* b_row,
                                        int u, int W, int sign, int smax,
                                        float thr, int sub) {
  const float da = a_row[u];
  const float wd = sub ? __fmul_rn(da, 0.5f) : da;
  const float uw = __fadd_rn(__int2float_rn(u), sign < 0 ? -wd : wd);
  if (!(da >= 0.f && uw >= 0.f && uw < __int2float_rn(W))) return -10.f;
  // in range here, so the truncation is exact (and saturates elsewhere,
  // as ops/convert.to_int32)
  const int s = min(max(sign * (__float2int_rz(uw) - u), 0), smax);
  const int idx = u + sign * s;
  const float other = (idx >= 0 && idx < W) ? b_row[idx] : -1e9f;
  return fabsf(__fsub_rn(other, da)) <= thr ? da : -10.f;
}

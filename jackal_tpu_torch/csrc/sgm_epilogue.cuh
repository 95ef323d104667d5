// The SGM float epilogue of one pixel, shared by kernel O2
// (sgm_tail_kernel.cu: from F's int16 maps in device memory) and by kernel
// F with O2 folded in (sgm_wta_kernel.cu: from its statistics in
// registers and the right view's disparities in shared memory). Both
// kernels compute it with these functions, so they agree bit for bit.
//
// As the plain version (ops/sgm_kernel.sgm_epilogue_plain) computes it in
// float32, from the reference's _wta_from_maps and _lr_tail
// (jackal_tpu/matching/sgm.py:183, :216) and the node's u8 conversion
// (jackal_tpu/pipeline/frame_pipeline.py:170):
//  - a view's disparity: unique = best < ratio * second (ratio the
//    uniqueness factor rounded to float32 on the host; 30000 where no
//    second exists); offs = (cm - cp) / (2 den), den = cm + cp - 2 best,
//    where 0 < best_d < D - 1 and den > 0, else 0; d = best_d + offs where
//    unique, else -1. Each product, sum and quotient is an __f*_rn, so
//    nothing is contracted; the quotient is IEEE division. No quotient is
//    subnormal: its least nonzero magnitude is 1 / (2 den) >= 2^-18, so no
//    flush rule (XLA:CPU's) can tell the two apart;
//  - the L/R check exactly as _lr_tail writes it: uw = clamp((int)(u -
//    dL), 0, W - 1) with u - dL a float32 difference truncated toward zero,
//    s = clamp(u - uw, 0, D), other = dR[u - s] (-1e9 where u - s leaves
//    the row); dL survives where dL >= 0, other >= 0 and |other - dL| <=
//    lr_threshold. Not dR[uw]: at dL = -1, uw = min(u + 1, W - 1) while
//    s = 0;
//  - the u8 map: clamp(rint(dL), 0, 255), rint rounding half to even as
//    torch.round and jnp.round do (a half occurs: with ties best_d is the
//    first minimum, so cp can equal best and offs be exactly 0.5).
#pragma once

#include <cstdint>

// a view's disparity from its five WTA statistics at one pixel
__device__ __forceinline__ float sgm_wta_disp(int best, int bd, int second,
                                              int cm, int cp, int D,
                                              float ratio) {
  const bool unique =
      __int2float_rn(best) < __fmul_rn(ratio, __int2float_rn(second));
  const int den = cm + cp - 2 * best;
  float offs = 0.0f;
  if (bd > 0 && bd < D - 1 && den > 0)
    offs = __fdiv_rn(__int2float_rn(cm - cp),
                     __fmul_rn(2.0f, __int2float_rn(den)));
  return unique ? __fadd_rn(__int2float_rn(bd), offs) : -1.0f;
}

// the column u - s whose right-view disparity the L/R check of column u
// reads (outside [0, W) where it leaves the row)
__device__ __forceinline__ int sgm_lr_column(int u, float dL, int W, int D) {
  const int uw = min(max(__float2int_rz(__fsub_rn(__int2float_rn(u), dL)), 0),
                     W - 1);
  return u - min(max(u - uw, 0), D);
}

// dL where the right view's disparity at the lookup column (-1e9 where it
// left the row) agrees, else -1
__device__ __forceinline__ float sgm_lr_keep(float dL, float other,
                                             float lr) {
  const bool ok = dL >= 0.0f && other >= 0.0f &&
                  fabsf(__fsub_rn(other, dL)) <= lr;
  return ok ? dL : -1.0f;
}

__device__ __forceinline__ uint8_t sgm_u8(float d) {
  return static_cast<uint8_t>(
      static_cast<int>(fminf(fmaxf(rintf(d), 0.0f), 255.0f)));
}

// The int8 codes' rounding shared by conv_int8.cu (the fused next-layer
// quantize) and quant_int8.cu: clip(rint(y / s), -127, 127) with rint's
// half-to-even of the correctly rounded f32 quotient RN(y / s), as
// odwscl_tpu/ops/quant.py computes it (a true division), bit for bit, but
// with no division: __fdiv_rn's branch to its slow path serialized the
// conv's epilogue, and any branch per value costs as much.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace int8_round {

// rint(RN(y / s)), branch-free. q = y * r (r ~ 1 / s, within a few ulps)
// refined once by its residual is within an ulp of y / s (faithful), so
// its remainder y - s q is exact in f32 and RN(y / s) is q or a neighbour
// of q (read off its bit pattern): the neighbour above when the remainder
// exceeds s times half the spacing up to it, the one below when it is
// under minus s times half the spacing down (both exact: s times a power
// of two), and at exactly that, whichever of the two has the even last
// bit. The first product is clamped to 2^24 in magnitude so that an
// overflowing quotient still saturates the code with its sign.
__device__ __forceinline__ float rint_quotient(float y, float s, float r) {
  const float q0 = fminf(fmaxf(y * r, -0x1p24f), 0x1p24f);
  const float q = fmaf(fmaf(-s, q0, y), r, q0);
  const float rem = fmaf(-s, q, y);
  const int bits = __float_as_int(q);
  const float away = __int_as_float(bits + 1);     // larger magnitude
  const float toward = __int_as_float(bits - 1);   // smaller magnitude
  const float up = bits < 0 ? toward : away, dn = bits < 0 ? away : toward;
  const float hs = 0.5f * s;
  const float t_up = hs * (up - q), t_dn = hs * (q - dn);
  const bool odd = bits & 1;
  float z = rem > t_up || (rem == t_up && odd) ? up : q;
  z = rem < -t_dn || (rem == -t_dn && odd) ? dn : z;
  return rintf(z);
}

__device__ __forceinline__ int8_t clip_code(float k) {
  return static_cast<int8_t>(
      __float2int_rn(fminf(fmaxf(k, -127.0f), 127.0f)));
}

}  // namespace int8_round

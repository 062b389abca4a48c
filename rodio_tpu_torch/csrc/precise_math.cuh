// Device-side arithmetic shared by the port's kernels.
//
// Every mul, add and sub is written with an explicit round-to-nearest
// intrinsic, so no FMA contraction can change a result (the library is
// also built with -fmad=false). exp2_precise/log2_precise carry the JAX
// package's range reduction and f32 Horner polynomials
// (rodio_tpu/core/math.py:58-103) with the same f32 constants as
// rodio_tpu_torch/core/math.py; no exp2f/__log2f/__expf intrinsic is used.
#pragma once

#include <cuda_runtime.h>

namespace rt {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// max that propagates NaN, as torch.maximum and jnp.maximum do
__device__ __forceinline__ float maxn(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// 2^r Taylor coefficients (ln2)^n / n!, rounded to f32
constexpr float EXP2_C0 = 0x1.000000p+0f, EXP2_C1 = 0x1.62e430p-1f,
                EXP2_C2 = 0x1.ebfbe0p-3f, EXP2_C3 = 0x1.c6b08ep-5f,
                EXP2_C4 = 0x1.3b2ab6p-7f, EXP2_C5 = 0x1.5d87fep-10f,
                EXP2_C6 = 0x1.430912p-13f, EXP2_C7 = 0x1.ffcbfcp-17f;
// log2 atanh-series coefficients 2 / ((2n+1) ln2), rounded to f32
constexpr float LOG2_K0 = 0x1.715476p+1f, LOG2_K1 = 0x1.ec709ep-1f,
                LOG2_K2 = 0x1.2776c6p-1f, LOG2_K3 = 0x1.a61762p-2f,
                LOG2_K4 = 0x1.484b14p-2f;
constexpr float SQRT2_F32 = 0x1.6a09e6p+0f;
constexpr float TINY = 0x1.0p-126f;  // Sample::MIN_POSITIVE

__device__ __forceinline__ float pow2i(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// f32 2^x within ~2 ulp
__device__ __forceinline__ float exp2_precise(float x) {
  const float k = rintf(x);  // half to even, as jnp.rint / torch.round
  const float r = sub(x, k);
  float p = add(mul(r, EXP2_C7), EXP2_C6);
  p = add(mul(p, r), EXP2_C5);
  p = add(mul(p, r), EXP2_C4);
  p = add(mul(p, r), EXP2_C3);
  p = add(mul(p, r), EXP2_C2);
  p = add(mul(p, r), EXP2_C1);
  p = add(mul(p, r), EXP2_C0);
  const int ki = (int)fminf(fmaxf(k, -300.0f), 300.0f);
  const int k1 = ki >> 1;  // floor division by 2
  const int k2 = ki - k1;
  return mul(mul(p, pow2i(k1)), pow2i(k2));
}

// f32 log2(x) within ~2 ulp for normal x > 0; -inf at x <= 0
__device__ __forceinline__ float log2_precise(float x) {
  const float xs = fmaxf(x, TINY);
  const int bits = __float_as_int(xs);
  int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  if (m >= SQRT2_F32) {
    m = mul(m, 0.5f);
    e += 1;
  }
  const float s = __fdiv_rn(sub(m, 1.0f), add(m, 1.0f));
  const float z = mul(s, s);
  float p = add(mul(z, LOG2_K4), LOG2_K3);
  p = add(mul(p, z), LOG2_K2);
  p = add(mul(p, z), LOG2_K1);
  p = add(mul(p, z), LOG2_K0);
  const float res = add((float)e, mul(s, p));
  return x > 0.0f ? res : __int_as_float(0xff800000);  // -inf
}

// the limiter's soft-knee gain computer in dB (src/source/limit.rs:854-873;
// ops/limiter_block.py limiter_gain_db's op order), for K3 and K5
__device__ __forceinline__ float soft_knee_db(float x, float threshold,
                                              float knee_width,
                                              float inv_knee_8,
                                              float log2_to_db) {
  const float bias =
      sub(mul(log2_precise(add(fabsf(x), TINY)), log2_to_db), threshold);
  const float kb = mul(bias, 2.0f);
  const float xk = add(kb, knee_width);
  const float quad = mul(mul(xk, xk), inv_knee_8);
  return kb < -knee_width ? 0.0f : (fabsf(kb) <= knee_width ? quad : bias);
}

struct BiquadCoef {
  float b0, b1, b2, a1, a2;
};

__device__ __forceinline__ BiquadCoef load_coef(const float* c) {
  return BiquadCoef{c[0], c[1], c[2], c[3], c[4]};
}

// DF-I step in the reference's operand order (src/source/blt.rs:556-561):
// ((((b0*x + b1*x1) + b2*x2) - a1*y1) - a2*y2), each op rounded alone
__device__ __forceinline__ float biquad_step(const BiquadCoef& k, float x,
                                             float x1, float x2, float y1,
                                             float y2) {
  float acc = add(mul(k.b0, x), mul(k.b1, x1));
  acc = add(acc, mul(k.b2, x2));
  acc = sub(acc, mul(k.a1, y1));
  return sub(acc, mul(k.a2, y2));
}

}  // namespace rt

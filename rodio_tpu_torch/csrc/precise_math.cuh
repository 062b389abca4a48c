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

// ---- f64: the instances of K3, K4, K7 and K8 that set_float64 runs ----
//
// Every mul, add and sub rounded alone in f64 (__dmul_rn, __dadd_rn,
// __dsub_rn; -fmad=false besides). exp2_precise/log2_precise keep the JAX
// package's contract under float64 as it is (rodio_tpu/core/math.py:58-103;
// rodio_tpu_torch/core/math.py): the Horner polynomials run in f64 on the
// unrounded coefficients, but 2^k is assembled from f32 exponent bits and
// log2 reads its exponent and mantissa from x rounded to f32, so its
// result carries an f32 mantissa.
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double maxn(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// 2^r Taylor coefficients (ln2)^n / n! and the log2 atanh-series
// coefficients 2 / ((2n+1) ln2), in f64
constexpr double EXP2_D0 = 0x1.0000000000000p+0, EXP2_D1 = 0x1.62e42fefa39efp-1,
                 EXP2_D2 = 0x1.ebfbdff82c58ep-3, EXP2_D3 = 0x1.c6b08d704a0bfp-5,
                 EXP2_D4 = 0x1.3b2ab6fba4e77p-7, EXP2_D5 = 0x1.5d87fe78a6730p-10,
                 EXP2_D6 = 0x1.430912f86c786p-13, EXP2_D7 = 0x1.ffcbfc588b0c5p-17;
constexpr double LOG2_KD0 = 0x1.71547652b82fep+1, LOG2_KD1 = 0x1.ec709dc3a03fep-1,
                 LOG2_KD2 = 0x1.2776c50ef9bfep-1, LOG2_KD3 = 0x1.a61762a7adedap-2,
                 LOG2_KD4 = 0x1.484b13d7c02a9p-2;
constexpr double SQRT2_F64 = 0x1.6a09e667f3bcdp+0;

__device__ __forceinline__ double exp2_precise(double x) {
  const double k = rint(x);  // half to even
  const double r = sub(x, k);
  double p = add(mul(r, EXP2_D7), EXP2_D6);
  p = add(mul(p, r), EXP2_D5);
  p = add(mul(p, r), EXP2_D4);
  p = add(mul(p, r), EXP2_D3);
  p = add(mul(p, r), EXP2_D2);
  p = add(mul(p, r), EXP2_D1);
  p = add(mul(p, r), EXP2_D0);
  const int ki = (int)fmin(fmax(k, -300.0), 300.0);
  const int k1 = ki >> 1;  // floor division by 2
  const int k2 = ki - k1;
  return mul(mul(p, (double)pow2i(k1)), (double)pow2i(k2));
}

__device__ __forceinline__ double log2_precise(double x) {
  const double xs = fmax(x, (double)TINY);
  const int bits = __float_as_int(__double2float_rn(xs));
  int e = ((bits >> 23) & 0xFF) - 127;
  double m = (double)__int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  if (m >= SQRT2_F64) {
    m = mul(m, 0.5);
    e += 1;
  }
  const double s = __ddiv_rn(sub(m, 1.0), add(m, 1.0));
  const double z = mul(s, s);
  double p = add(mul(z, LOG2_KD4), LOG2_KD3);
  p = add(mul(p, z), LOG2_KD2);
  p = add(mul(p, z), LOG2_KD1);
  p = add(mul(p, z), LOG2_KD0);
  const double res = add((double)e, mul(s, p));
  return x > 0.0 ? res : __longlong_as_double(0xfff0000000000000ULL);  // -inf
}

__device__ __forceinline__ double soft_knee_db(double x, double threshold,
                                               double knee_width,
                                               double inv_knee_8,
                                               double log2_to_db) {
  const double bias =
      sub(mul(log2_precise(add(fabs(x), (double)TINY)), log2_to_db), threshold);
  const double kb = mul(bias, 2.0);
  const double xk = add(kb, knee_width);
  const double quad = mul(mul(xk, xk), inv_knee_8);
  return kb < -knee_width ? 0.0 : (fabs(kb) <= knee_width ? quad : bias);
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

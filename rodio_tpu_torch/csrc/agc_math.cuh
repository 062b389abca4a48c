// Device-side AGC arithmetic shared by K2 (K2g, K2r, K2b), K6 and K7
// (src/source/agc.rs:397-496).
//
// Each function keeps the JAX kernels' operation order, each op rounded
// alone; the plain PyTorch versions (rodio_tpu_torch/ops/cuda_scan.py
// desired_gain / smooth_gain) write the same ops in the same order. The
// smoother and the peak detector are loop-carried chains, so they are
// written for a short dependent path: both candidates of a select are
// computed before the choice (the same ops on the same values, so the same
// result), and min / max are one instruction each.
#pragma once

#include "precise_math.cuh"

namespace rt {

// min and max that propagate NaN, as torch.minimum / torch.maximum do: one
// FMNMX each (PTX min.NaN / max.NaN, sm_80 and later)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// min(max(v, lo), hi), NaN in v or hi passed on (torch.clamp, then
// torch.minimum)
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
  return min_nan(max_nan(v, lo), hi);
}

// 1 / sqrt(x), both correctly rounded: the one rsqrt definition of the port
// (torch's and CUDA's rsqrtf are approximate to ~2 ulp)
__device__ __forceinline__ float rsqrt_rn(float x) {
  return __fdiv_rn(1.0f, __fsqrt_rn(x));
}

// The AGC's parameters, as the kernels take them (data, not constants)
struct AgcParams {
  float att, rel, target, max_gain, floor, inv_window;
};

__device__ __forceinline__ AgcParams load_agc_params(const float* p) {
  return AgcParams{p[0], p[1], p[2], p[3], p[4], p[5]};
}

// desired gain from the running window sum rs and the peak pk:
// max(min(rg, pg), floor) with rg = target * rsqrt(rs * (1/W)) where
// rs > 0 (else max_gain) and pg = min(target / pk, max_gain) where pk > 0
// (else max_gain)
__device__ __forceinline__ float desired_gain(float rs, float pk,
                                              const AgcParams& p) {
  const float rg =
      rs > 0.0f ? mul(p.target, rsqrt_rn(mul(rs, p.inv_window))) : p.max_gain;
  const float pg =
      pk > 0.0f ? min_nan(__fdiv_rn(p.target, pk), p.max_gain) : p.max_gain;
  return max_nan(min_nan(rg, pg), p.floor);
}

// the dual-rate gain smoother: speed = att while the desired gain is above
// the current one, else rel; g = clip(g*speed + des*(1-speed), 0.1, max).
// Both candidates are clipped before the choice, so the select is the
// chain's last op.
__device__ __forceinline__ float smooth_gain(float g, float des, float att,
                                             float rel, float max_gain) {
  const float up = clip_nan(add(mul(g, att), mul(des, sub(1.0f, att))), 0.1f,
                            max_gain);
  const float down = clip_nan(add(mul(g, rel), mul(des, sub(1.0f, rel))),
                              0.1f, max_gain);
  return des > g ? up : down;
}

// f64 (the f64 instances of K6, K7 and K5): NaN-propagating min and max as
// selects (PTX's min.NaN has no f64 form), the smoother with the f64 clip
// bound 0.1, and K6's peak detector and desired gain
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ double clip_nan(double v, double lo, double hi) {
  return min_nan(max_nan(v, lo), hi);
}
__device__ __forceinline__ double smooth_gain(double g, double des, double att,
                                              double rel, double max_gain) {
  const double up = clip_nan(add(mul(g, att), mul(des, sub(1.0, att))), 0.1,
                             max_gain);
  const double down = clip_nan(add(mul(g, rel), mul(des, sub(1.0, rel))), 0.1,
                               max_gain);
  return des > g ? up : down;
}

__device__ __forceinline__ double rsqrt_rn(double x) {
  return __ddiv_rn(1.0, __dsqrt_rn(x));
}

struct AgcParams64 {
  double att, rel, target, max_gain, floor, inv_window;
};

__device__ __forceinline__ AgcParams64 load_agc_params(const double* p) {
  return AgcParams64{p[0], p[1], p[2], p[3], p[4], p[5]};
}

__device__ __forceinline__ double desired_gain(double rs, double pk,
                                               const AgcParams64& p) {
  const double rg =
      rs > 0.0 ? mul(p.target, rsqrt_rn(mul(rs, p.inv_window))) : p.max_gain;
  const double pg =
      pk > 0.0 ? min_nan(__ddiv_rn(p.target, pk), p.max_gain) : p.max_gain;
  return max_nan(min_nan(rg, pg), p.floor);
}

__device__ __forceinline__ double peak_select(double peak, double x, double rel) {
  const double up = add(mul(peak, 0.0), mul(x, 1.0));
  const double down = add(mul(peak, rel), mul(x, sub(1.0, rel)));
  return x > peak ? up : down;
}

// The rel0 plans (release coefficient 0, rodio_tpu/ops/fused.py:810-1158).
// The smoother: max(0.1, min(des, att*g + (1-att)*des)); catt = 1 - att,
// rounded. Its chain through g is mul, add, min, max.
__device__ __forceinline__ float smooth_gain_rel0(float g, float des,
                                                  float att, float catt) {
  return max_nan(min_nan(des, add(mul(att, g), mul(catt, des))), 0.1f);
}

// rel0f's, rel0b's and rel0c's desired gain, the peak term folded into the
// rsqrt: q = max(rs*(1/W), y*y), q > 0 ? min(target*rsqrt(q), max_gain) :
// max_gain
__device__ __forceinline__ float desired_gain_folded(float rs, float y,
                                                     const AgcParams& p) {
  const float q = max_nan(mul(rs, p.inv_window), mul(y, y));
  return q > 0.0f ? min_nan(mul(p.target, rsqrt_rn(q)), p.max_gain)
                  : p.max_gain;
}

// x^k by repeated squaring in f32, in the order of the JAX package's _ipow
// (rodio_tpu/ops/fused.py:86)
__device__ __forceinline__ float ipow(float x, int k) {
  float r = 0.f, b = x;
  bool first = true;
  while (k) {
    if (k & 1) {
      r = first ? b : mul(r, b);
      first = false;
    }
    b = mul(b, b);
    k >>= 1;
  }
  return r;
}

// the peak detector's select form (src/source/agc.rs:397-407):
// coeff = x > peak ? 0 : rel; peak*coeff + x*(1 - coeff)
__device__ __forceinline__ float peak_select(float peak, float x, float rel) {
  const float up = add(mul(peak, 0.0f), mul(x, 1.0f));
  const float down = add(mul(peak, rel), mul(x, sub(1.0f, rel)));
  return x > peak ? up : down;
}

}  // namespace rt

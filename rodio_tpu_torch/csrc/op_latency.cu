// The latency of one dependent rounded f32 op on the card: one thread runs
// a chain of FMUL and FADD in turn, each waiting on the one before. A
// recurrence kernel (K1-K8) cannot finish sooner than its serial steps
// times the dependent ops of a step times this latency: its chain floor
// (benches/op_latency.py, chip_smoke.py).
//
// The loop's counter and branch do not depend on x, so they issue beside
// the chain; 32 ops per iteration.
//
// Beside it, the latency of one step of the AGC's gain smoother
// (agc_math.cuh smooth_gain: mul, add, max, min and a select through the
// gain), the chain that binds K6's and K7's smoother warps, on one thread,
// in SM cycles (clock64) and in time.
//
// And the latency of one dependent rounded f64 op (DMUL and DADD in turn):
// the chain floor of the f64 instances of K3, K4, K7 and K8.
#include <cuda_runtime.h>

#include "agc_math.cuh"

namespace {

constexpr int kOpsPerIter = 32;

__global__ void op_chain_kernel(const float* __restrict__ xab,
                                float* __restrict__ out, long long iters) {
  float x = xab[0];
  const float a = xab[1], b = xab[2];
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kOpsPerIter / 2; ++u) {
      x = __fmul_rn(x, a);
      x = __fadd_rn(x, b);
    }
  }
  out[0] = x;
}

__global__ void op_chain_f64_kernel(const double* __restrict__ xab,
                                    double* __restrict__ out, long long iters) {
  double x = xab[0];
  const double a = xab[1], b = xab[2];
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kOpsPerIter / 2; ++u) {
      x = __dmul_rn(x, a);
      x = __dadd_rn(x, b);
    }
  }
  out[0] = x;
}

// p: (g0, att, rel, max_gain, lo, hi); the desired gain alternates lo, hi
// (independent of g), 32 steps an iteration; out: (g, the loop's cycles)
__global__ void smooth_chain_kernel(const float* __restrict__ p,
                                    float* __restrict__ out, long long iters) {
  float g = p[0];
  const float att = p[1], rel = p[2], max_gain = p[3], lo = p[4], hi = p[5];
  const long long t0 = clock64();
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kOpsPerIter / 2; ++u) {
      g = rt::smooth_gain(g, lo, att, rel, max_gain);
      g = rt::smooth_gain(g, hi, att, rel, max_gain);
    }
  }
  const long long t1 = clock64();
  out[0] = g;
  out[1] = (float)(t1 - t0);
}

}  // namespace

// xab: (x0, a, b); out: x after iters x 16 rounds of x = x*a, x = x + b
extern "C" int rt_op_chain(const float* xab, float* out, long long iters,
                           void* stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
  op_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(xab, out, iters);
  return (int)cudaGetLastError();
}

// xab: (x0, a, b) f64; out: x after iters x 16 rounds of x = x*a, x = x + b
extern "C" int rt_op_chain_f64(const double* xab, double* out, long long iters,
                               void* stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
  op_chain_f64_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(xab, out, iters);
  return (int)cudaGetLastError();
}

// p: (g0, att, rel, max_gain, lo, hi); out: (g after iters x 32 smoother
// steps, the SM cycles they took)
extern "C" int rt_smooth_chain(const float* p, float* out, long long iters,
                               void* stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
  smooth_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(p, out, iters);
  return (int)cudaGetLastError();
}

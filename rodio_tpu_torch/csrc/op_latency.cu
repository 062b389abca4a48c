// The latency of one dependent rounded f32 op on the card: one thread runs
// a chain of FMUL and FADD in turn, each waiting on the one before. A
// recurrence kernel (K1-K8) cannot finish sooner than its serial steps
// times the dependent ops of a step times this latency: its chain floor
// (benches/op_latency.py, chip_smoke.py).
//
// The loop's counter and branch do not depend on x, so they issue beside
// the chain; 32 ops per iteration.
#include <cuda_runtime.h>

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

}  // namespace

// xab: (x0, a, b); out: x after iters x 16 rounds of x = x*a, x = x + b
extern "C" int rt_op_chain(const float* xab, float* out, long long iters,
                           void* stream) {
  if (iters < 0) return (int)cudaErrorInvalidValue;
  op_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(xab, out, iters);
  return (int)cudaGetLastError();
}

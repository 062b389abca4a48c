// The generator's per-sample phase accumulator, one thread a generator.
//
// Replaces the lax.scan of rodio_tpu/sources/generators.py
// SignalGenerator.emit (rodio_compat=True, generators.py:96-112), no Pallas
// kernel: the reference's f32 recurrence (src/source/signal_generator.rs:133)
//
//   out[k] = p;   s = p + step;   p = s - floor(s)
//
// every op rounded alone (__fadd_rn, floorf, __fsub_rn), so the phases equal
// the plain PyTorch loop's (ops/phase.py) and the JAX scan's bit for bit.
//
// What bounds it on the H100: the serial chain, three dependent ops a
// sample (FADD, FRND, FADD) on one thread: n x 3 x ~2 ns, 0.025 ms for a
// block of 4096. The n floats it stores take a few ns at 3.35 TB/s. A
// generator is a serial recurrence of one lane, so the design is the
// simplest: one thread walks its generator's n steps with the phase in a
// register and stores each step's phase (the stores do not wait); threads
// of a block take neighbouring generators.
#include <cuda_runtime.h>

namespace {

__global__ void phase_kernel(const float* __restrict__ phase0,
                             const float* __restrict__ step,
                             float* __restrict__ phases,
                             float* __restrict__ phase_out, int G,
                             long long n) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  float p = phase0[g];
  const float s = step[g];
  float* out = phases + (long long)g * n;
  for (long long k = 0; k < n; ++k) {
    out[k] = p;
    const float a = __fadd_rn(p, s);
    p = __fsub_rn(a, floorf(a));
  }
  phase_out[g] = p;
}

}  // namespace

extern "C" int rt_phase_accumulate(const float* phase0, const float* step,
                                   float* phases, float* phase_out, int G,
                                   long long n, void* stream) {
  if (G < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const int threads = G < 128 ? G : 128;
  phase_kernel<<<(G + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      phase0, step, phases, phase_out, G, n);
  return (int)cudaGetLastError();
}

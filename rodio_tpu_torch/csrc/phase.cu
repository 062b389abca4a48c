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
//
// The f64 instance (set_float64: JAX's step is dt(self._step32), the f32
// step widened, then an f64 add and pn - floor(pn), generators.py:98-110)
// is the same loop on doubles: __dadd_rn, floor, __dsub_rn; three dependent
// f64 ops a sample (DADD, FRND.F64, DADD).
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float floor_of(float a) { return floorf(a); }
__device__ __forceinline__ double floor_of(double a) { return floor(a); }

template <class T>
__global__ void phase_kernel(const T* __restrict__ phase0,
                             const T* __restrict__ step,
                             T* __restrict__ phases,
                             T* __restrict__ phase_out, int G,
                             long long n) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  T p = phase0[g];
  const T s = step[g];
  T* out = phases + (long long)g * n;
  for (long long k = 0; k < n; ++k) {
    out[k] = p;
    const T a = add_rn(p, s);
    p = sub_rn(a, floor_of(a));
  }
  phase_out[g] = p;
}

template <class T>
int launch(const T* phase0, const T* step, T* phases, T* phase_out, int G,
           long long n, void* stream) {
  if (G < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const int threads = G < 128 ? G : 128;
  phase_kernel<T><<<(G + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      phase0, step, phases, phase_out, G, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_phase_accumulate(const float* phase0, const float* step,
                                   float* phases, float* phase_out, int G,
                                   long long n, void* stream) {
  return launch(phase0, step, phases, phase_out, G, n, stream);
}

// the f64 instance: phases, steps and outputs f64
extern "C" int rt_phase_accumulate_f64(const double* phase0, const double* step,
                                       double* phases, double* phase_out, int G,
                                       long long n, void* stream) {
  return launch(phase0, step, phases, phase_out, G, n, stream);
}

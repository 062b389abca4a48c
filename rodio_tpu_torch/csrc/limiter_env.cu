// K5: the limiter's two envelope recurrences per lane, fused.
//
// Replaces rodio_tpu/ops/pallas_scan.py limiter_env_pallas /
// _limiter_env_kernel (src/source/limit.rs:909-913). Per step, in the TPU
// kernel's order, from the soft-knee gain db of each sample:
//
//   integ = max(db, rel*integ + (1-rel)*db)
//   peak  = att*peak + (1-att)*integ            -> the output
//
// The carries out are those of the last step, T-1: the port has no padded
// tail, so they are what the TPU kernel's saved pair holds.
//
// What bounds it on the H100: the serial chain, one thread per lane. The
// products (1-rel)*db do not depend on the carries, so they leave the chain
// (the compiler schedules them ahead); what stays is mul, add, max on the
// integrator and mul, add on the peak, 3 dependent ops a step (about 2 ns
// each, benches/op_latency.py). At the per-stream chain's shape ([1024,
// 12800], 512 stereo streams) that floor is ~0.08 ms, against 31 us for
// the 105 MB the kernel must read and write.
//
// Design: lane_pipeline.cuh, as K6 and K7. Warp 0 runs the recurrence on
// register tiles of 32 steps while warps 1-7 store the previous tile's
// peaks and load the next tile's db. Every op rounds alone, so the kernel
// equals its plain PyTorch version bit for bit.
#include "agc_math.cuh"
#include "lane_pipeline.cuh"

namespace {

using rt::kLanes;
using rt::kThreads;

__global__ void __launch_bounds__(kThreads, 1)
limiter_env_kernel(const float* __restrict__ db,
                   const float* __restrict__ integ0,
                   const float* __restrict__ peak0, float* __restrict__ peak_out,
                   float* __restrict__ carry_out, int L, long long T, float att,
                   float rel, float catt, float crel) {
  __shared__ rt::STile bufs[rt::kBufs][1];
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const bool mine = threadIdx.x < 32 && lane < L;
  float integ = 0.f, peak = 0.f;
  if (mine) {
    integ = integ0[lane];
    peak = peak0[lane];
  }
  auto run = [&](float (&v)[rt::kSteps][1], auto tt) {
    using namespace rt;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (t < tt) {
        const float d = v[t][0];
        integ = max_nan(d, add(mul(rel, integ), mul(crel, d)));
        peak = add(mul(att, peak), mul(catt, integ));
        v[t][0] = peak;
      }
    }
  };
  rt::lane_tiles<1>(bufs, rt::LaneInputs<1>{{db}}, peak_out, L, T, run);
  if (mine) {
    carry_out[lane] = integ;
    carry_out[L + lane] = peak;
  }
}

}  // namespace

extern "C" int rt_limiter_env(const float* db, const float* integ0,
                              const float* peak0, float* peak_out,
                              float* carry_out, int L, long long T, float att,
                              float rel, float catt, float crel, void* stream) {
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks == 0) return 0;
  limiter_env_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      db, integ0, peak0, peak_out, carry_out, L, T, att, rel, catt, crel);
  return (int)cudaGetLastError();
}

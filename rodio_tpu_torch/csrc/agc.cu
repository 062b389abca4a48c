// K6: the AGC's whole per-sample loop, one serial recurrence per lane.
//
// Replaces rodio_tpu/ops/pallas_scan.py agc_pallas / _agc_kernel
// (src/source/agc.rs:397-496). Per step, in the TPU kernel's order:
//
//   coeff = x > peak ? 0 : rel;  peak = peak*coeff + x*(1 - coeff)
//   rsum  = rsum + d                              (d = sq - old, given)
//   des   = desired_gain(rsum, peak)              (agc_math.cuh)
//   gain  = smooth_gain(gain, des)                -> the output
//
// What bounds it on the H100: one thread per lane runs every step, the
// desired gain (an IEEE sqrt and two divides, each with a slow-path branch
// that keeps neighbouring steps from overlapping) included: ~310 cycles a
// step, 4.0 ms at [512, 25600] on an H100 80GB HBM3 at 700 W, with 16
// blocks on 16 SMs. Splitting the loop into passes (the chains, then the
// desired gains, then the smoother) measured slower. A faster design moves
// the desired gains onto other warps, as K2 does (fused_agc.cu).
//
// Design: lane_pipeline.cuh. Warps 1-7 keep the |x| and d tiles of the
// next 32 steps loading and the gains of the previous ones storing while
// warp 0 runs the loop on registers. The parameters (att, rel, target,
// max_gain, floor, 1/window) are data, so a live knob rebuilds nothing.
// Every op rounds alone, so the kernel equals its plain PyTorch version bit
// for bit.
#include "agc_math.cuh"
#include "lane_pipeline.cuh"

namespace {

using rt::kLanes;
using rt::kThreads;

__global__ void __launch_bounds__(kThreads, 1)
agc_kernel(const float* __restrict__ xs, const float* __restrict__ d,
           const float* __restrict__ params, const float* __restrict__ peak0,
           const float* __restrict__ sum0, const float* __restrict__ gain0,
           float* __restrict__ gain_out, float* __restrict__ carry_out, int L,
           long long T) {
  __shared__ rt::STile bufs[rt::kBufs][2];
  const rt::AgcParams p = rt::load_agc_params(params);
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  const bool mine = threadIdx.x < 32 && lane < L;
  float peak = 0.f, rsum = 0.f, g = 0.f;
  if (mine) {
    peak = peak0[lane];
    rsum = sum0[lane];
    g = gain0[lane];
  }
  auto run = [&](float (&v)[rt::kSteps][2], auto tt) {
    using namespace rt;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (t < tt) {
        peak = peak_select(peak, v[t][0], p.rel);
        rsum = add(rsum, v[t][1]);
        g = smooth_gain(g, desired_gain(rsum, peak, p), p.att, p.rel,
                        p.max_gain);
        v[t][0] = g;
      }
    }
  };
  rt::lane_tiles<2>(bufs, rt::LaneInputs<2>{{xs, d}}, gain_out, L, T, run);
  if (mine) {
    carry_out[0 * L + lane] = peak;
    carry_out[1 * L + lane] = rsum;
    carry_out[2 * L + lane] = g;
  }
}

}  // namespace

extern "C" int rt_agc(const float* xs, const float* d, const float* params,
                      const float* peak0, const float* sum0,
                      const float* gain0, float* gain_out, float* carry_out,
                      int L, long long T, void* stream) {
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks == 0) return 0;
  agc_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      xs, d, params, peak0, sum0, gain0, gain_out, carry_out, L, T);
  return (int)cudaGetLastError();
}

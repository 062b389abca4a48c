// K7: a first-order recurrence per lane, three ops in one kernel.
//
// Replaces rodio_tpu/ops/pallas_scan.py first_order_pallas /
// _first_order_kernel. Per step, in the TPU kernel's order:
//
//   linear:      y = a*y' + b
//   max_affine:  y = max(a, b + c*y')
//   agc_gain:    y = smooth_gain(y', a) with (att, rel, max_gain) as data
//                (the AGC's dual-rate smoother, src/source/agc.rs:486-496)
//
// What bounds it on the H100: the serial chain, ~2 (linear) to ~6
// (agc_gain) dependent rounded ops per step on one thread per lane. The
// AGC's decomposed path calls it with one lane (a mono or stereo stream)
// over 2T interleaved samples: one thread, latency bound. Measured on an
// H100 80GB HBM3 at 700 W: 0.225 ms at [1, 8192] (agc_gain), ~54 cycles a
// step, of which the smoother's chain alone is 27; the rest is each
// 32-step tile's wait for its load (a deeper ring of tiles would hide it).
//
// Design: lane_pipeline.cuh, with only the inputs the op reads loaded
// (agc_gain: a alone). Every op rounds alone, so the kernel equals its
// plain PyTorch version bit for bit.
#include "agc_math.cuh"
#include "lane_pipeline.cuh"

namespace {

using rt::kLanes;
using rt::kThreads;

constexpr int kLinear = 0, kMaxAffine = 1, kAgcGain = 2;

// one tile of a lane's recurrence, in registers (rt::lane_tiles's run)
template <int OP, int NIN>
struct FirstOrderTile {
  float yc, att, rel, max_gain;

  template <class TT>
  __device__ __forceinline__ void operator()(float (&v)[rt::kSteps][NIN],
                                             TT tt) {
    using namespace rt;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (t < tt) {
        if constexpr (OP == kLinear) {
          yc = add(mul(v[t][0], yc), v[t][1]);
        } else if constexpr (OP == kMaxAffine) {
          yc = maxn(v[t][0], add(v[t][1], mul(v[t][2], yc)));
        } else {
          yc = smooth_gain(yc, v[t][0], att, rel, max_gain);
        }
        v[t][0] = yc;
      }
    }
  }
};

template <int OP>
__global__ void __launch_bounds__(kThreads, 1)
first_order_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c,
                   const float* __restrict__ init,
                   const float* __restrict__ params, float* __restrict__ y,
                   int L, long long T) {
  constexpr int NIN = OP == kLinear ? 2 : OP == kMaxAffine ? 3 : 1;
  __shared__ rt::STile bufs[rt::kBufs][NIN];
  const int lane = blockIdx.x * kLanes + threadIdx.x;
  FirstOrderTile<OP, NIN> run{0.f, 0.f, 0.f, 0.f};
  if (OP == kAgcGain) {
    run.att = params[0];
    run.rel = params[1];
    run.max_gain = params[2];
  }
  if (threadIdx.x < 32 && lane < L) run.yc = init[lane];
  rt::LaneInputs<NIN> in;
  in.p[0] = a;
  if constexpr (NIN > 1) in.p[1] = b;
  if constexpr (NIN > 2) in.p[2] = c;
  rt::lane_tiles<NIN>(bufs, in, y, L, T, run);
}

}  // namespace

extern "C" int rt_first_order(const float* a, const float* b, const float* c,
                              const float* init, const float* params,
                              float* y, int L, long long T, int op,
                              void* stream) {
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kLinear:
      first_order_kernel<kLinear><<<blocks, kThreads, 0, s>>>(
          a, b, c, init, params, y, L, T);
      break;
    case kMaxAffine:
      first_order_kernel<kMaxAffine><<<blocks, kThreads, 0, s>>>(
          a, b, c, init, params, y, L, T);
      break;
    case kAgcGain:
      first_order_kernel<kAgcGain><<<blocks, kThreads, 0, s>>>(
          a, b, c, init, params, y, L, T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

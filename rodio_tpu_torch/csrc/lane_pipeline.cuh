// The tiled, pipelined per-lane serial scan shared by K6 and K7.
//
// The biquad pipeline's scheme (biquad_pipeline.cuh) for kernels with
// several [L, T] inputs: a block owns 32 lanes and walks time in tiles of
// kSteps steps, each input's tile held in shared memory as [t][lane]. Warp
// 0 runs the recurrence, one thread per lane, its carries in registers:
// it loads its lane's whole tile of every input into registers, runs the
// steps on them (a whole tile with no per-step test: see Steps) and stores
// the outputs over input 0's tile. Warps 1-7 store the previous tile's
// outputs and load the next tile of every input meanwhile, in a ring of
// kBufs tiles per input. Tiles are shorter than the biquad's (32 steps) so
// that three inputs' rings fit the 48 KB of static shared memory.
#pragma once

#include "biquad_pipeline.cuh"

namespace rt {

// a tile length known at compile time: a loop bounded by it has no
// per-step test once unrolled (std::integral_constant's conversion is not
// callable from device code)
template <int N>
struct Steps {
  __host__ __device__ constexpr operator int() const { return N; }
};

constexpr int kSteps = 32;  // time steps per tile
typedef float STile[kSteps][kLanes + 1];

template <int NIN>
struct LaneInputs {
  const float* p[NIN];
};

// run(v, tt) takes v[t][k] = in[k][lane, t0 + t] for the tile's steps
// t < tt of this thread's lane, in registers, and writes each step's output
// to v[t][0]; it keeps its carries itself. tt is an int, or for a whole
// tile Steps<kSteps>.
template <int NIN, class Run>
__device__ __forceinline__ void lane_tiles(STile (*bufs)[NIN],
                                           const LaneInputs<NIN>& in,
                                           float* __restrict__ out, int L,
                                           long long T, Run& run) {
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, L - lane0);
  const int n_tiles = (int)((T + kSteps - 1) / kSteps);
  if (n_tiles == 0) return;
  auto tlen = [&](int i) {
    return (int)min((long long)kSteps, T - (long long)i * kSteps);
  };
  // element e of a tile: lane e / kSteps, step e % kSteps (runs along time)
  auto fill = [&](int i, int sub, int nsub) {
    const long long t0 = (long long)i * kSteps;
    const int tt = tlen(i);
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      STile& b = bufs[i % kBufs][k];
      const float* src = in.p[k];
      batched(
          sub, nsub, kLanes * kSteps,
          [&](int e) {
            const int l = min(e / kSteps, nl - 1), t = min(e % kSteps, tt - 1);
            return src[(long long)(lane0 + l) * T + t0 + t];
          },
          [&](int e, float v) {
            const int l = e / kSteps, t = e % kSteps;
            const bool ok = e < kLanes * kSteps && l < nl && t < tt;
            b[ok ? t : 0][ok ? l : kLanes] = v;
          });
    }
  };
  auto drain = [&](int i, int sub, int nsub) {
    const long long t0 = (long long)i * kSteps;
    const int tt = tlen(i);
    STile& b = bufs[i % kBufs][0];
    for (int e = sub; e < kLanes * kSteps; e += nsub) {
      const int l = e / kSteps, t = e % kSteps;
      if (l < nl && t < tt) out[(long long)(lane0 + l) * T + t0 + t] = b[t][l];
    }
  };
  fill(0, tid, kThreads);
  __syncthreads();
  for (int i = 0; i < n_tiles; ++i) {
    if (tid < 32) {
      if (tid < nl) {
        const int tt = tlen(i);
        STile(&b)[NIN] = bufs[i % kBufs];
        float v[kSteps][NIN];
#pragma unroll
        for (int t = 0; t < kSteps; ++t)
#pragma unroll
          for (int k = 0; k < NIN; ++k) v[t][k] = b[k][t][tid];
        // a whole tile runs with tt a compile-time kSteps, so that its copy
        // of run has no per-step test
        if (tt == kSteps)
          run(v, Steps<kSteps>{});
        else
          run(v, tt);
#pragma unroll
        for (int t = 0; t < kSteps; ++t)
          if (t < tt) b[0][t][tid] = v[t][0];
      }
    } else {
      if (i >= 1) drain(i - 1, tid - 32, kThreads - 32);
      if (i + 1 < n_tiles) fill(i + 1, tid - 32, kThreads - 32);
    }
    __syncthreads();
  }
  drain(n_tiles - 1, tid, kThreads);
}

}  // namespace rt

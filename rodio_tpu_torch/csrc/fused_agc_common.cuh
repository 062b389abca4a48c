// What K2's serial and rel0 plans (fused_agc.cu: K2, K2r) use: the block's
// shape, its 64-frame tiles, the warps' roles, the staged lerp rows, the
// ring's rounding (K2g's and K2b's too, fused_agc_group.cu and
// fused_agc_blocked.cu, which run on K1's front end), the biquad warp's
// column walk and the sum of the blocks' mix partials in order.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "agc_math.cuh"
#include "lane_pipeline.cuh"  // rt::Steps

namespace rt::fused_agc {

using U64 = unsigned long long;

constexpr int kTile = 64;    // frames a tile
constexpr int kBL = 8;       // lanes per block (whole stereo streams)
constexpr int kRing = 4096;  // frames of the RMS window: 8192 samples / 2 ch
constexpr int kBqCh = 16;    // frames per register chunk of warp 0
// warps 3, 4, 7 and 8 are the elementwise warps (SMSPs 3, 0, 3, 0, beside
// the light biquad warp); warps 5 and 6 stay idle
constexpr int kNWork = 4 * 32;
constexpr int kAgcThreads = 9 * 32;
static_assert(kBL % 2 == 0 && kBL <= 32, "whole streams, one warp of lanes");

typedef float Tile[kTile][kBL + 1];  // +1: no bank conflicts on columns

__device__ __forceinline__ int tile_len(long long T, int i) {
  return (int)min((long long)kTile, T - (long long)i * kTile);
}

// the elementwise slot of a warp, or -1
__device__ __forceinline__ int work_slot(int warp) {
  return warp == 3 || warp == 4 ? warp - 3 : warp == 7 || warp == 8 ? warp - 5
                                                                    : -1;
}

// a frame's left input row and lerp weights, staged in shared memory
struct Row {
  long long left;
  float2 w;
};

__device__ __forceinline__ float ring_f32(float v) { return v; }
__device__ __forceinline__ float ring_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename R>
__device__ __forceinline__ R ring_round(float v);
template <>
__device__ __forceinline__ float ring_round<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 ring_round<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a whole tile's tt is rt::Steps<kTile>, a tail tile's an int
template <class TT>
constexpr bool kWhole = !std::is_same<TT, int>::value;

// run(tt) for a tile of tt steps: a whole tile runs with tt a compile-time
// kTile, so its copy of run has no per-step test (a branch per step costs
// the serial warps more than the step)
template <class Run>
__device__ __forceinline__ void full_or_tail(int tt, Run run) {
  if (tt == kTile)
    run(rt::Steps<kTile>{});
  else
    run(tt);
}

// The biquad warp's walk down its lane's column of a tile (y over x in
// place), kBqCh frames at a time in registers so that no step waits on a
// load; the carries are this thread's lane's.
template <class TT>
__device__ __forceinline__ void biquad_column(Tile& b, int wl, TT tt,
                                              const rt::BiquadCoef& cf,
                                              float& x1, float& x2, float& y1,
                                              float& y2) {
#pragma unroll 1
  for (int t0 = 0; t0 < kTile; t0 += kBqCh) {
    float v[kBqCh];
#pragma unroll
    for (int u = 0; u < kBqCh; ++u) v[u] = b[t0 + u][wl];
#pragma unroll
    for (int u = 0; u < kBqCh; ++u) {
      if (kWhole<TT> || t0 + u < tt) {
        const float yt = rt::biquad_step(cf, v[u], x1, x2, y1, y2);
        x2 = x1;
        x1 = v[u];
        y2 = y1;
        y1 = yt;
        v[u] = yt;
      }
    }
#pragma unroll
    for (int u = 0; u < kBqCh; ++u)
      if (kWhole<TT> || t0 + u < tt) b[t0 + u][wl] = v[u];
  }
}

// out[c, t] = sum over blocks b (in order) of partial[b, c, t], c < 2,
// t < n, on stream s (defined in fused_agc.cu)
cudaError_t sum_partials(const float* partial, float* out, int nblk, int n,
                         cudaStream_t s);

}  // namespace rt::fused_agc

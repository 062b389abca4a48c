// K4: direct-form-I biquad over lanes, one serial recurrence per lane.
//
// Replaces rodio_tpu/ops/pallas_scan.py biquad_df1_pallas / _biquad_kernel.
//
// What bounds it on the H100: the recurrence y_t <- (y_{t-1}, y_{t-2}) is a
// chain of dependent rounded ops per sample, so a lane is latency bound;
// with 1024 lanes only 32 warps run it, one block per SM on 32 of the 132
// SMs. The data, 2 x 4 B per sample, is small beside that, if its latency
// is hidden.
//
// Design: a block owns 32 lanes (biquad_pipeline.cuh). Warps 1-7 load the
// next [64 t x 32 lane] tile of x into shared memory, each warp reading a
// run of one lane's row, and store the previous tile of y the same way,
// while warp 0 runs the recurrence on the current tile, one thread per
// lane. Every mul and add rounds alone (biquad_step), in the order of the
// sequential scan, so the kernel equals its plain PyTorch version bit for
// bit.
#include "biquad_pipeline.cuh"

namespace {

using rt::kLanes;
using rt::kThreads;
using rt::kTile;

__global__ void __launch_bounds__(kThreads, 1)
biquad_df1_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const float* __restrict__ coef,
                  const float* __restrict__ x1i, const float* __restrict__ x2i,
                  const float* __restrict__ y1i, const float* __restrict__ y2i,
                  float* __restrict__ x1o, float* __restrict__ x2o,
                  float* __restrict__ y1o, float* __restrict__ y2o,
                  int L, long long T) {
  __shared__ rt::Tile bufs[rt::kBufs];
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, L - lane0);
  const rt::BiquadCoef k = rt::load_coef(coef);
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  if (tid < nl) {
    carry[0] = x1i[lane0 + tid];
    carry[1] = x2i[lane0 + tid];
    carry[2] = y1i[lane0 + tid];
    carry[3] = y2i[lane0 + tid];
  }
  // element e of a tile: lane e / kTile, step e % kTile (runs along time)
  auto fill = [&](rt::Tile& b, int i, int sub, int nsub) {
    const long long t0 = (long long)i * kTile;
    const int tt = rt::tile_len(T, i);
    rt::batched(
        sub, nsub, kLanes * kTile,
        [&](int e) {
          const int l = min(e / kTile, nl - 1), t = min(e % kTile, tt - 1);
          return x[(long long)(lane0 + l) * T + t0 + t];
        },
        [&](int e, float v) {
          const int l = e / kTile, t = e % kTile;
          const bool ok = e < kLanes * kTile && l < nl && t < tt;
          b[ok ? t : 0][ok ? l : kLanes] = v;
        });
  };
  auto drain = [&](rt::Tile& b, int i, int sub, int nsub) {
    const long long t0 = (long long)i * kTile;
    const int tt = rt::tile_len(T, i);
    for (int e = sub; e < kLanes * kTile; e += nsub) {
      const int l = e / kTile, t = e % kTile;
      if (l < nl && t < tt) y[(long long)(lane0 + l) * T + t0 + t] = b[t][l];
    }
  };
  rt::biquad_tiles(bufs, T, nl, k, carry, fill, drain);
  if (tid < nl) {
    x1o[lane0 + tid] = carry[0];
    x2o[lane0 + tid] = carry[1];
    y1o[lane0 + tid] = carry[2];
    y2o[lane0 + tid] = carry[3];
  }
}

}  // namespace

extern "C" int rt_biquad_df1(const float* x, float* y, const float* coef,
                             const float* x1i, const float* x2i,
                             const float* y1i, const float* y2i, float* x1o,
                             float* x2o, float* y1o, float* y2o, int L,
                             long long T, void* stream) {
  const int blocks = (L + kLanes - 1) / kLanes;
  if (blocks == 0) return 0;
  biquad_df1_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, y, coef, x1i, x2i, y1i, y2i, x1o, x2o, y1o, y2o, L, T);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1: resample + per-lane gain + biquad + stream mix, one pass per block.
//
// Replaces rodio_tpu/ops/fused.py fused_resample_biquad_mix /
// _fused_kernel + _fused_body (the flagship's FusedWidePipeline). For each
// output frame o of lane l:
//
//   left = (o / to)*fr + (fr*(o % to)) / to,  j = o % to
//   v    = (w0[j]*x[left] + w1[j]*x[left+1]) * gain[l]
//   y    = DF-I biquad of v, carries (x1, x2, y1, y2) across blocks
//   mix[c, o] = sum over streams s of y[s*C + c, o]
//
// w0/w1 are the two nonzero f32 taps of the JAX lerp operator G0/g1
// (conversions/resample.py:125-133), built once on the host. The gain is
// applied after the lerp and before the biquad: the JAX package's
// "gain_post" order. PCM rows past the buffer read as zero, so the stream's
// last frame resamples against a zero right neighbour, as the JAX kernel
// does (the unfused chain emits that one drain frame raw instead).
//
// What bounds it on the H100: the biquad is a serial chain per lane, and
// with 1024 lanes only 32 warps run it (one block per SM, 32 of 132 SMs).
// The PCM read, 4 B per input frame per lane (about 48 MB per 12800-frame
// block at 1024 lanes), takes ~15 us at full bandwidth. A later PR can cut
// the serial depth (a blocked parallel-in-time biquad).
//
// Design: the caller passes each output frame's left input frame [n] and
// its two weights (w0[j], w1[j]) [n, 2], from conversions/resample.py
// output_positions, the one owner of the index rule (the caller needs the
// same rows for the drain bookkeeping), and lerp_weights.
// A block owns the 32 / C * C lanes of whole streams and runs the pipeline
// of biquad_pipeline.cuh: while warp 0 runs the biquad on a tile of 64
// frames, one thread per lane, warps 1-7 resample and gain the next tile (a
// warp reads one PCM row across its lanes, side by side) and mix the
// previous one: they sum the block's streams per channel and frame in
// stream order into per-block partials [nblk, C, n]. A second kernel sums
// the partials over blocks in block order: the mix is deterministic, with
// no float atomics. Every mul and add rounds alone.
#include "biquad_pipeline.cuh"

namespace {

using rt::kLanes;
using rt::kThreads;
using rt::kTile;
using U64 = unsigned long long;

// the raw loads of one tile element (see rt::batched)
struct Taps {
  long long left;
  float2 w;
  float g, xl, xr;
};

__global__ void __launch_bounds__(kThreads, 1)
fused_kernel(const float* __restrict__ pcm, long long F, int L,
             const long long* __restrict__ left,
             const float2* __restrict__ wts, const float* __restrict__ gains,
             const float* __restrict__ coef, const float* __restrict__ bq_in,
             float* __restrict__ bq_out, float* __restrict__ partial, int n,
             int C, int LB) {
  __shared__ rt::Tile bufs[rt::kBufs];
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * LB;
  const int nl = min(LB, L - lane0);
  const int ns = nl / C;  // whole streams in this block
  const rt::BiquadCoef k = rt::load_coef(coef);
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  if (tid < nl) {
    carry[0] = bq_in[0 * L + lane0 + tid];
    carry[1] = bq_in[1 * L + lane0 + tid];
    carry[2] = bq_in[2 * L + lane0 + tid];
    carry[3] = bq_in[3 * L + lane0 + tid];
  }
  // element e of a tile: step e / LB, lane e % LB (runs along a PCM row)
  auto fill = [&](rt::Tile& b, int i, int sub, int nsub) {
    const int t0 = i * kTile;
    const int tt = rt::tile_len(n, i);
    rt::batched(
        sub, nsub, kTile * LB,
        [&](int e) {
          const int t = e / LB, l = e - t * LB;
          const int tc = t0 + min(t, tt - 1);
          const int lane = lane0 + min(l, nl - 1);
          // clamped: every address is valid, so no load waits on a branch;
          // unsigned, so that a negative row clamps (and reads as zero) too
          Taps v;
          v.left = left[tc];
          v.w = wts[tc];
          v.g = gains[lane];
          v.xl = pcm[min((U64)v.left, (U64)F - 1) * L + lane];
          v.xr = pcm[min((U64)v.left + 1, (U64)F - 1) * L + lane];
          return v;
        },
        [&](int e, const Taps& v) {
          const int t = e / LB, l = e - t * LB;
          const bool ok = e < kTile * LB && t < tt && l < nl;
          const float xl = (U64)v.left < (U64)F ? v.xl : 0.f;
          const float xr = (U64)v.left + 1 < (U64)F ? v.xr : 0.f;
          b[ok ? t : 0][ok ? l : kLanes] =
              rt::mul(rt::add(rt::mul(xl, v.w.x), rt::mul(xr, v.w.y)), v.g);
        });
  };
  // this block's streams summed per (channel, frame), in stream order
  auto drain = [&](rt::Tile& b, int i, int sub, int nsub) {
    const int t0 = i * kTile;
    const int tt = rt::tile_len(n, i);
    for (int e = sub; e < C * kTile; e += nsub) {
      const int c = e / kTile, t = e % kTile;
      if (t < tt) {
        float acc = b[t][c];
        for (int s = 1; s < ns; ++s) acc = rt::add(acc, b[t][s * C + c]);
        partial[((long long)blockIdx.x * C + c) * n + t0 + t] = acc;
      }
    }
  };
  rt::biquad_tiles(bufs, n, nl, k, carry, fill, drain);
  if (tid < nl) {
    bq_out[0 * L + lane0 + tid] = carry[0];
    bq_out[1 * L + lane0 + tid] = carry[1];
    bq_out[2 * L + lane0 + tid] = carry[2];
    bq_out[3 * L + lane0 + tid] = carry[3];
  }
}

// out[c, t] = sum over blocks b (in order) of partial[b, c, t]
__global__ void mix_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int nblk,
                                    long long cn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cn) return;
  float acc = partial[i];
  for (int b = 1; b < nblk; ++b) acc = rt::add(acc, partial[b * cn + i]);
  out[i] = acc;
}

}  // namespace

extern "C" int rt_fused_resample_biquad_mix(
    const float* pcm, long long F, int L, const long long* left,
    const float* wts, const float* gains, const float* coef,
    const float* bq_in, float* bq_out, float* partial, float* out, int n,
    int C, void* stream) {
  if (C < 1 || C > kLanes || L % C || n < 1 || F < 1)
    return (int)cudaErrorInvalidValue;
  const int LB = kLanes / C * C;
  const int nblk = (L + LB - 1) / LB;
  if (nblk == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  fused_kernel<<<nblk, kThreads, 0, s>>>(
      pcm, F, L, left, reinterpret_cast<const float2*>(wts), gains, coef,
      bq_in, bq_out, partial, n, C, LB);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cn = (long long)C * n;
  mix_partials_kernel<<<(unsigned)((cn + 255) / 256), 256, 0, s>>>(
      partial, out, nblk, cn);
  return (int)cudaGetLastError();
}

// K1: resample + per-lane gain + biquad + stream mix, one pass per block.
//
// Replaces rodio_tpu/ops/fused.py fused_resample_biquad_mix /
// _fused_kernel + _fused_body (the flagship's FusedWidePipeline and, in
// ring mode, the farm's FusedFarmPipeline over a rolling ring whose row r
// holds input rows r, r + R, r + 2R, ...: ring_chunks > 0). For each
// output frame o of lane l:
//
//   left = (o / to)*fr + (fr*(o % to)) / to,  j = o % to
//   v    = (w0[j]*x[left] + w1[j]*x[left+1]) * gain[l]
//   u    = (b0*v + b1*v1) + b2*v2            (v1, v2: the lane's last two v)
//   y    = (u - a1*y1) - a2*y2               (y1, y2: its last two y)
//   mix[c, o] = sum over streams s of y[s*C + c, o]
//
// u then y is the DF-I step of the reference (src/source/blt.rs:556-561)
// in its own operand order, split where the chain begins, so y and the
// carries (x1, x2, y1, y2) equal the plain sequential scan's bit for bit:
// the JAX package's "ufir" split (rodio_tpu/ops/fused.py:444-452). w0/w1
// are the two nonzero f32 taps of the JAX lerp operator G0/g1
// (conversions/resample.py:125-133), built once on the host. The gain is
// applied after the lerp and before the biquad: the JAX package's
// "gain_post" order. PCM rows past the buffer read as zero, so the
// stream's last frame resamples against a zero right neighbour, as the JAX
// kernel does (the unfused chain emits that one drain frame raw instead).
//
// What bounds it on the H100: the IIR half, a chain of 3 dependent rounded
// ops a frame (mul a1*y1, sub, sub) on one thread per lane, 12800 frames a
// block at the main path's shape: ~0.079 ms at ~2.04 ns an op. The PCM
// read, 4 B per input frame per lane (~48 MB a block at 1024 lanes), takes
// ~15 us at full bandwidth.
//
// Design (fused_front.cuh, K2's block shape and warp roles): a block owns
// kBL = 8 lanes of whole streams and walks time in tiles of 128 frames
// through a three-stage pipeline, one __syncthreads a tile. The front end's
// fill warps run the gained lerp and the FIR half of tile i, its copy warps
// stage PCM rows two tiles ahead, warp 0 runs the IIR half of tile i-1,
// and the mix warps (14, 15) sum tile i-2's streams per (channel, frame)
// into per-block partials. A second kernel sums the partials over blocks
// in block order, in f64, a batch of loads in flight at a time: the mix is
// deterministic, with no float atomics. Every op rounds alone.
#include "fused_front.cuh"

namespace {

using namespace rt::front;

constexpr int kYBufs = 3;      // y tiles: i, i-1, i-2
constexpr int kDepth = 2;      // iterations from a tile's fill to its mix

template <bool kRing>
__global__ void __launch_bounds__(kThreads, 1)
fused_kernel(const float* __restrict__ pcm, long long F, int L,
             const long long* __restrict__ left,
             const float2* __restrict__ wts, const float* __restrict__ gains,
             const float* __restrict__ coef, const float* __restrict__ bq_in,
             float* __restrict__ bq_out, float* __restrict__ partial, int n,
             int C) {
  extern __shared__ float4 smem4[];
  const FrontT<kRing> fe(reinterpret_cast<float*>(smem4), pcm, F, L, left, wts,
                         n, block_lanes(C), kYBufs);
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int ns = fe.nl / C;
  const rt::BiquadCoef cf = rt::load_coef(coef);

  float y1 = 0.f, y2 = 0.f;
  if (warp == 0 && wl < fe.nl) {
    y1 = bq_in[2 * L + fe.lane0 + wl];
    y2 = bq_in[3 * L + fe.lane0 + wl];
  }
  int gsub = 0;  // the thread's index in its group
  const int group = work_group(warp, wl, gsub);
  const float gain0 =
      group == 0 ? gains[fe.lane0 + min(gsub % fe.LB, fe.nl - 1)] : 0.f;
  Row next[kStageRows];  // a copy thread's rows of the tile staged next
  fe.start(bq_in, group, gsub, next);

  for (int it = 0; it < fe.n_tiles + kDepth; ++it) {
    if (warp == 0) {
      fe.iir(it, wl, cf, y1, y2);
    } else if (group == 0) {
      fe.fill<true>(it, gsub, gains, gain0, cf);
    } else if (group == 1) {
      fe.copy_step(it, gsub, next, [] {});
    } else if (group == 2 && fe.live(it - 2)) {
      // this block's streams of tile it-2 summed per (channel, frame), in
      // stream order, four frames a thread (16-byte loads, and stores
      // where the partials' rows allow)
      const int j = it - 2, tt = tile_len(n, j);
      const float* y = fe.y_tile(j);
      for (int e = gsub; e < C * (kTile / 4); e += kMix) {
        const int c = e / (kTile / 4), t = e % (kTile / 4) * 4;
        if (t < tt) {
          float4 acc = *reinterpret_cast<const float4*>(y + c * kYLd + t);
          for (int s = 1; s < ns; ++s) {
            const float4 a = *reinterpret_cast<const float4*>(y + (s * C + c) * kYLd + t);
            acc = make_float4(rt::add(acc.x, a.x), rt::add(acc.y, a.y),
                              rt::add(acc.z, a.z), rt::add(acc.w, a.w));
          }
          float* out = partial + ((long long)blockIdx.x * C + c) * n + (long long)j * kTile + t;
          if (n % 4 == 0 && t + 4 <= tt) {
            *reinterpret_cast<float4*>(out) = acc;
          } else {
            const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
            for (int k = 0; k < 4 && t + k < tt; ++k) out[k] = a4[k];
          }
        }
      }
    }
    __syncthreads();
  }

  if (warp == 0) fe.finish(bq_out, wl, y1, y2);
}

// out[i] = sum over blocks b (in order) of partial[b * cn + i], kSumBatch
// loads in flight before their adds. The sum runs in f64 (29 bits more than
// f32) and rounds to f32 once, so its error stays about half an f32 ulp of
// the mix however many blocks there are, where an f32 sum would add a
// rounding per block.
constexpr int kSumBatch = 16;

__global__ void mix_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int nblk,
                                    long long cn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cn) return;
  double acc = partial[i];
  int b = 1;
  for (; b + kSumBatch <= nblk; b += kSumBatch) {
    float v[kSumBatch];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) v[u] = partial[(b + u) * cn + i];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u) acc = __dadd_rn(acc, (double)v[u]);
  }
  for (; b < nblk; ++b) acc = __dadd_rn(acc, (double)partial[b * cn + i]);
  out[i] = __double2float_rn(acc);
}

}  // namespace

cudaError_t rt::front::sum_partials(const float* partial, float* out, int nblk,
                                    long long cn, cudaStream_t s) {
  mix_partials_kernel<<<(unsigned)((cn + 255) / 256), 256, 0, s>>>(
      partial, out, nblk, cn);
  return cudaGetLastError();
}

// lanes per block for C channels: partial holds [ceil(L / this), C, n]
extern "C" int rt_fused_block_lanes(int C) { return block_lanes(C); }

namespace {

template <bool kRing>
int launch(const float* pcm, long long F, int L, const long long* left,
           const float* wts, const float* gains, const float* coef,
           const float* bq_in, float* bq_out, float* partial, float* out,
           int n, int C, void* stream) {
  if (C < 1 || C > kMaxLB || L % C || n < 1 || F < 1 || (kRing && F < kMaxRows))
    return (int)cudaErrorInvalidValue;
  const int LB = block_lanes(C);
  const int nblk = (L + LB - 1) / LB;
  if (nblk == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t shmem = layout(LB, kYBufs).bytes;
  if (shmem > 48 * 1024) {  // more than the default needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        fused_kernel<kRing>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_kernel<kRing><<<nblk, kThreads, shmem, s>>>(
      pcm, F, L, left, reinterpret_cast<const float2*>(wts), gains, coef,
      bq_in, bq_out, partial, n, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rt::front::sum_partials(partial, out, nblk, (long long)C * n, s);
}

}  // namespace

extern "C" int rt_fused_resample_biquad_mix(
    const float* pcm, long long F, int L, const long long* left,
    const float* wts, const float* gains, const float* coef,
    const float* bq_in, float* bq_out, float* partial, float* out, int n,
    int C, void* stream) {
  return launch<false>(pcm, F, L, left, wts, gains, coef, bq_in, bq_out,
                       partial, out, n, C, stream);
}

// K1's ring mode: pcm is a ring of R rows (R >= 192), input row r read at
// ring row r mod R (the farm's rolling ring, rodio_tpu/ops/fused.py:300-309)
extern "C" int rt_fused_resample_biquad_mix_ring(
    const float* pcm, long long R, int L, const long long* left,
    const float* wts, const float* gains, const float* coef,
    const float* bq_in, float* bq_out, float* partial, float* out, int n,
    int C, void* stream) {
  return launch<true>(pcm, R, L, left, wts, gains, coef, bq_in, bq_out,
                      partial, out, n, C, stream);
}

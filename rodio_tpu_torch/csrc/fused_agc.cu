// K2: resample + biquad + per-stream AGC + gain + stream mix, one pass; and
// K2r, the same under the serial rel0 plans; on K1's front end.
//
// Replaces rodio_tpu/ops/fused.py fused_resample_biquad_agc_mix /
// _fused_agc_kernel with its serial plan (agc_group = 0, no rel0 plan):
// FusedWidePipeline(with_agc=True); and (K2r) its rel0 and rel0f branches
// (:810-919), agc_plan="rel0" | "rel0f", for a release coefficient of
// exactly 0 (the default AgcSettings). Stereo streams, lane l = 2s + c. The
// lerp and the biquad are K1's (fused_front.cuh) without the gain, which K2
// applies after the AGC (the JAX package's order under AGC: gain_post is
// off). Then one AGC per stream over its interleaved samples (frame t:
// channel 0, then channel 1; src/source/agc.rs:397-496), in the TPU
// kernel's order (rodio_tpu/ops/fused.py:793-919), every op rounded alone:
//
//   q   = round(y*y) to the ring's type (bf16 RNE or f32); rel0f: the packed
//         basis, lane 2s round(sq0), lane 2s+1 round(sq0 + sq1) (f32 sum)
//   d   = q - old, old = q of the same lane 4096 frames earlier (the
//         8192-sample RMS window), read from the ring, zero at the start
//   serial: rs = rs + d;  pk = max(|y|, rel*pk + (1-rel)*|y|)   per sample
//           des = desired_gain(rs, pk);  g = smooth_gain(g, des)
//   rel0:   rs_lo = rs + d_lo, rs = rs + (d_lo + d_hi)           per frame
//           des = desired_gain(rs_c, |y_c|)  (the peak detector memoryless)
//   rel0f:  rs_lo = rs + d_lo, rs = rs + d_hi (the ring's packed delta)
//           des = desired_gain_folded(rs_c, y_c)
//   rel0*:  g = max(0.1, min(des, att*g + (1-att)*des))   (4 dependent ops)
//   mix[c, o] = sum over streams s of (y*g)*gain[2s + c]
//
// The ring holds 4096 frames x L lanes, row f % 4096 for global frame f; a
// block's tile reads its rows one iteration before it rewrites them, and a
// block longer than 4096 frames reads back rows it wrote 32 tiles earlier.
//
// What bounds it on the H100: the gain smoother, a chain of 5 dependent
// rounded ops a sample (4 under rel0*), 2n steps per stream: 24.3 SM cycles
// a step on one thread (benches/op_latency.py smooth_step), ~6200 cycles a
// 128-frame tile. Every other stage is elementwise or a shorter chain (the
// biquad's IIR half 3 ops a frame; the window sum 1 add a sample; the
// serial plan's peak 3 ops a sample) and has to fit under it.
//
// Design (fused_front.cuh: K1's block of 8 lanes, 4 stereo streams, so 128
// blocks for 1024 lanes; 128-frame tiles, one __syncthreads a tile; K1's
// fill, copy and IIR warps), as K2b's (fused_agc_blocked.cu): the AGC's
// elementwise stages where K1's warps wait or idle, its two serial chains
// one thread per stream on register pieces of a tile loaded at each
// piece's start, a whole tile's loop with a compile-time length and no
// per-step test. At iteration i:
//
//   fill warps:  tile i's lerp and FIR half; then tile i-4's desired gains
//                (an IEEE sqrt and divides a sample), 4 frames of one lane a
//                thread
//   copy warps:  the ring's words of tile i-1 (a frame's 8 lanes in one or
//                two 16-byte loads, 2 frames a thread), used an iteration
//                later; the PCM rows of tile i+2 and the row indices of
//                tiles i+3, i+4; while those copies fly, tile i-2's
//                squares, the ring's rounding and write, and d
//   warp 0:      the IIR half of tile i-1
//   warp 15:     the window sums (and the serial plan's peaks) of tile i-3
//   warp 8:      the gain smoother of tile i-5
//   warp 14:     y*g*gain and the mix of tile i-6, 4 frames of one channel
//                an item, into per-block partials
//
// Where the chains sit, measured (benches/warp_cycles.py, NVIDIA H100 80GB
// HBM3 at 700 W, 512 streams, n = 12800): with the window and the smoother
// both beside the IIR warp on SMSP 0 the smoother ran ~31.5 cycles a sample
// (serial plan); with the window on warp 15 (SMSP 3, where the elementwise
// warps finish in the first ~2800 cycles of an iteration) it runs ~27.5
// (rel0* ~20), and the window ~24. Both chains on one thread ran slower
// (53 cycles a sample): the warp issues in order and spilled registers. The
// pieces are loaded at their start, not one piece ahead: loads run ahead
// spilled registers at the 128 a thread that 512 threads leave, and lost
// more than the load latency they hid; the serial plan's smoother takes
// pieces of 16 frames (32 spilled), rel0*'s of 32. K2 takes ~7380 cycles a
// tile (0.42 ms in a CUDA graph with the ring's copy and the partials'
// sum), K2r ~5400 (0.315 ms).
//
// The partials are summed over blocks in block order, in f64, as K1's. The
// biquad carries, the AGC carries and the ring equal the plain version's
// bit for bit, and the mix differs only by the order of its sum over
// streams and blocks.
#include "fused_agc_common.cuh"  // the ring
#include "fused_front.cuh"

namespace {

using namespace rt::front;
using rt::fused_agc::kRing;
using rt::fused_agc::kWords;
using rt::fused_agc::ring_frame;
using rt::fused_agc::ring_load;

// the AGC plan a kernel instance runs
enum Plan : int { kSerial = 0, kRel0 = 1, kRel0f = 2 };

constexpr int kSB = kBL / 2;     // streams a block
// the window sums and peaks on a mix warp of the front end (SMSP 3), the
// gain smoother beside the IIR warp (SMSP 0), the mix on the other mix warp
// (14) alone
constexpr int kWinWarp = 15;
constexpr int kSmoothWarp = 8;
constexpr int kMixThreads = 32;
// y tiles; d tiles (d, then the window sums, the desired gains, the
// gains); the serial plan's peak tiles; iterations from a tile's fill to
// its mix
constexpr int kYBufs = 7, kDBufs = 5, kPBufs = 2;
constexpr int kDepth = 6;
// frames a serial thread holds at once: the window's, and the smoother's
// (the serial plan's smoother at 32 spills registers)
constexpr int kWinCh = 8;
template <int kPlan>
constexpr int kSmoothCh = kPlan == kSerial ? 16 : 32;
constexpr int kFrames = kTile / kCopy;  // frames of a tile a copy thread takes
static_assert(kFill == kBL * (kTile / 4), "4 frames of one lane a fill thread");
static_assert(block_lanes(2) == kBL, "blocks of kSB stereo streams");

// after the front end's buffers (float offsets): the d tiles and the peak
// tiles ([lane][kYLd] each) and the lanes' gains; the total bytes
struct ALayout {
  size_t d, pk, gain, bytes;
};

__host__ __device__ inline ALayout alayout() {
  ALayout a;
  a.d = layout(kBL, kYBufs).bytes / sizeof(float);
  a.pk = a.d + (size_t)kDBufs * kBL * kYLd;
  a.gain = a.pk + (size_t)kPBufs * kBL * kYLd;
  a.bytes = (a.gain + kBL) * sizeof(float);
  return a;
}

// frames t0 .. t0+N-1 of a stream's two lanes, rows r (lane 2s) and r +
// kYLd (lane 2s+1) of a tile, 16 bytes at a time: v[u][c]
template <int N>
__device__ __forceinline__ void load_chunk(const float* r, int t0, float (&v)[N][2]) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = *reinterpret_cast<const float4*>(r + c * kYLd + t0 + 4 * q);
      v[4 * q][c] = f.x, v[4 * q + 1][c] = f.y, v[4 * q + 2][c] = f.z, v[4 * q + 3][c] = f.w;
    }
}
template <int N>
__device__ __forceinline__ void store_chunk(float* r, int t0, const float (&v)[N][2]) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      *reinterpret_cast<float4*>(r + c * kYLd + t0 + 4 * q) =
          make_float4(v[4 * q][c], v[4 * q + 1][c], v[4 * q + 2][c], v[4 * q + 3][c]);
}

// A serial thread's walk over its stream's frames of a tile, N frames at a
// time in registers (loaded at the piece's start, as K6's chain_row): step(a,
// b) on each frame of the first tt, a and b the frame's two samples of rows
// A and B (B null: not read); step rewrites them in place, and a is stored
// back to A, b to B2 (null: not stored).
template <int N, class TT, class Step>
__device__ __forceinline__ void stream_chunks(float* A, const float* B, float* B2,
                                              TT tt, Step step) {
#pragma unroll 1
  for (int t0 = 0; t0 < kTile; t0 += N) {
    if (!kWhole<TT> && t0 >= tt) break;
    float a[N][2], b[N][2];
    load_chunk(A, t0, a);
    if (B) load_chunk(B, t0, b);
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (kWhole<TT> || t0 + u < tt) step(a[u], b[u]);
    store_chunk(A, t0, a);
    if (B2) store_chunk(B2, t0, b);
  }
}

template <typename R, int kPlan>
__global__ void __launch_bounds__(kThreads, 1)
fused_agc_kernel(const float* __restrict__ pcm, long long F, int L,
                 const long long* __restrict__ left,
                 const float2* __restrict__ wts,
                 const float* __restrict__ gains,
                 const float* __restrict__ coef,
                 const float* __restrict__ bq_in, float* __restrict__ bq_out,
                 const float* __restrict__ agc_in,
                 float* __restrict__ agc_out,
                 const float* __restrict__ params, R* ring, int ring_row,
                 float* __restrict__ partial, int n) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const Front fe(smem, pcm, F, L, left, wts, n, kBL, kYBufs);
  const ALayout al = alayout();
  constexpr int tsz = kBL * kYLd;
  auto dt = [&](int j) { return smem + al.d + (j % kDBufs) * tsz; };
  auto pkt = [&](int j) { return smem + al.pk + (j % kPBufs) * tsz; };
  float* const gain_sh = smem + al.gain;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int nl = fe.nl, ns = nl / 2;
  const int S = L / 2, s0 = fe.lane0 / 2;
  const rt::AgcParams p = rt::load_agc_params(params);
  const rt::BiquadCoef cf = rt::load_coef(coef);
  const float crel = rt::sub(1.0f, p.rel);
  const float catt = rt::sub(1.0f, p.att);
  // 16-byte ring pieces: whole blocks of lanes on aligned rows
  const bool rvec = nl == kBL && (L * sizeof(R)) % 16 == 0 && ((U64)ring & 15) == 0;

  // carries: the IIR half on warp 0 (per lane); the window sum and the
  // peak on the window warp, the gain on the smoother warp (per stream)
  float y1 = 0.f, y2 = 0.f;
  float rs = 0.f, pk = 0.f, g = 0.f;
  if (warp == 0 && wl < nl) {
    y1 = bq_in[2 * L + fe.lane0 + wl];
    y2 = bq_in[3 * L + fe.lane0 + wl];
  } else if (warp == kWinWarp && wl < ns) {
    rs = agc_in[0 * S + s0 + wl];
    pk = agc_in[1 * S + s0 + wl];
  } else if (warp == kSmoothWarp && wl < ns) {
    g = agc_in[2 * S + s0 + wl];
  }
  if (tid < kBL) gain_sh[tid] = tid < nl ? gains[fe.lane0 + tid] : 0.f;

  auto ring_at = [&](int j, int t) {
    return ring + (long long)((ring_row + j * kTile + t) & (kRing - 1)) * L + fe.lane0;
  };

  int gsub = 0;  // the thread's index in its group
  const int group = work_group(warp, wl, gsub);
  Row next[kStageRows];  // a copy thread's rows of the tile staged next
  unsigned cur[kFrames][kWords<R>];  // a copy thread's ring words of tile it-2
  fe.start(bq_in, group, gsub, next);

  for (int it = 0; it < fe.n_tiles + kDepth; ++it) {
    if (warp == 0) {
      fe.iir(it, wl, cf, y1, y2);
    } else if (warp == kWinWarp) {
      if (wl < ns && fe.live(it - 3)) {
        // tile it-3's window sums over d, in place (lane 2s the lo
        // sub-step's, lane 2s+1 the hi's); the serial plan's peaks over y
        // into the peak tile
        const int j = it - 3;
        const int o = 2 * wl * kYLd;
        if (kPlan == kSerial) {
          auto step = [&](float (&d)[2], float (&y)[2]) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              rs = rt::add(rs, d[c]);
              const float xs = fabsf(y[c]);
              pk = rt::max_nan(xs, rt::add(rt::mul(p.rel, pk), rt::mul(crel, xs)));
              d[c] = rs;
              y[c] = pk;
            }
          };
          full_or_tail(tile_len(n, j), [&](auto tt) {
            stream_chunks<kWinCh>(dt(j) + o, fe.y_tile(j) + o, pkt(j) + o, tt, step);
          });
        } else {
          auto step = [&](float (&d)[2], float (&)[2]) {
            // rel0: the hi sub-step's delta pre-added (the TPU kernel's
            // repack); rel0f: the ring's packed delta
            const float dh = kPlan == kRel0 ? rt::add(d[0], d[1]) : d[1];
            d[0] = rt::add(rs, d[0]);
            rs = rt::add(rs, dh);
            d[1] = rs;
          };
          full_or_tail(tile_len(n, j), [&](auto tt) {
            stream_chunks<kWinCh>(dt(j) + o, nullptr, nullptr, tt, step);
          });
        }
      }
    } else if (warp == kSmoothWarp) {
      if (wl < ns && fe.live(it - 5)) {
        // tile it-5's gains over its desired gains, in place
        const int j = it - 5;
        auto step = [&](float (&d)[2], float (&)[2]) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            g = kPlan == kSerial ? rt::smooth_gain(g, d[c], p.att, p.rel, p.max_gain)
                                 : rt::smooth_gain_rel0(g, d[c], p.att, catt);
            d[c] = g;
          }
        };
        full_or_tail(tile_len(n, j), [&](auto tt) {
          stream_chunks<kSmoothCh<kPlan>>(dt(j) + 2 * wl * kYLd, nullptr, nullptr, tt, step);
        });
      }
    } else if (group == 2) {
      if (fe.live(it - kDepth)) {
        // tile it-6: each y times its gain and its lane's, summed over this
        // block's streams in stream order, 4 frames of one channel an item
        const int j = it - kDepth, tt = tile_len(n, j);
        const float* const y = fe.y_tile(j);
        const float* const gv = dt(j);
        for (int e = gsub; e < 2 * (kTile / 4); e += kMixThreads) {
          const int c = e / (kTile / 4), t = e % (kTile / 4) * 4;
          if (t >= tt) continue;
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int s = 0; s < kSB; ++s) {
            if (s < ns) {
              const int o = (2 * s + c) * kYLd + t;
              const float4 a = *reinterpret_cast<const float4*>(y + o);
              const float4 b = *reinterpret_cast<const float4*>(gv + o);
              const float gl = gain_sh[2 * s + c];
              const float4 v = make_float4(
                  rt::mul(rt::mul(a.x, b.x), gl), rt::mul(rt::mul(a.y, b.y), gl),
                  rt::mul(rt::mul(a.z, b.z), gl), rt::mul(rt::mul(a.w, b.w), gl));
              acc = s ? make_float4(rt::add(acc.x, v.x), rt::add(acc.y, v.y),
                                    rt::add(acc.z, v.z), rt::add(acc.w, v.w))
                      : v;  // the first term alone
            }
          }
          float* out = partial + ((long long)blockIdx.x * 2 + c) * n + (long long)j * kTile + t;
          if (n % 4 == 0 && t + 4 <= tt) {
            *reinterpret_cast<float4*>(out) = acc;
          } else {
            const float a4[4] = {acc.x, acc.y, acc.z, acc.w};
            for (int k = 0; k < 4 && t + k < tt; ++k) out[k] = a4[k];
          }
        }
      }
    } else if (group == 0) {
      fe.fill<false>(it, gsub, nullptr, 0.f, cf);
      if (fe.live(it - 4)) {
        // tile it-4's desired gains over its window sums (d's tile), its
        // peaks (serial) or y (rel0*)
        const int j = it - 4, l = gsub / (kTile / 4), t0 = gsub % (kTile / 4) * 4;
        if (l < nl && t0 < tile_len(n, j)) {
          const int o = l * kYLd + t0;
          float4* const b4 = reinterpret_cast<float4*>(dt(j) + o);
          const float4 rv = *b4;
          const float4 yv = *reinterpret_cast<const float4*>(
              (kPlan == kSerial ? pkt(j) : fe.y_tile(j)) + o);
          const float r4[4] = {rv.x, rv.y, rv.z, rv.w}, y4[4] = {yv.x, yv.y, yv.z, yv.w};
          float d4[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            d4[k] = kPlan == kRel0f ? rt::desired_gain_folded(r4[k], y4[k], p)
                                    : rt::desired_gain(r4[k], kPlan == kRel0 ? fabsf(y4[k])
                                                                            : y4[k], p);
          *b4 = make_float4(d4[0], d4[1], d4[2], d4[3]);
        }
      }
    } else if (group == 1) {
      // the ring's values leaving the window for tile it-1's frames, loaded
      // an iteration before their use (cur holds tile it-2's)
      const int jr = it - 2;
      const int ttr = fe.live(jr) ? tile_len(n, jr) : 0;
      const int ttn = fe.live(it - 1) ? tile_len(n, it - 1) : 0;
      unsigned nxt[kFrames][kWords<R>];
#pragma unroll
      for (int k = 0; k < kFrames; ++k) {
        const int t = gsub + k * kCopy;
        if (t < ttn) ring_load(ring_at(it - 1, t), rvec, nl, nxt[k]);
      }
      // the front end's copies; while they fly, tile it-2's squares, the
      // ring's rounding and write, and d = q - old
      fe.copy_step(it, gsub, next, [&] {
        const float* const yb = fe.y_tile(jr);
#pragma unroll
        for (int k = 0; k < kFrames; ++k) {
          const int t = gsub + k * kCopy;
          if (t < ttr) ring_frame<kPlan == kRel0f>(yb, t, ring_at(jr, t), rvec, nl, cur[k], dt(jr));
        }
      });
#pragma unroll
      for (int k = 0; k < kFrames; ++k)
#pragma unroll
        for (int w = 0; w < kWords<R>; ++w) cur[k][w] = nxt[k][w];
    }
    __syncthreads();
  }

  if (warp == 0) {
    fe.finish(bq_out, wl, y1, y2);
  } else if (warp == kWinWarp && wl < ns) {
    agc_out[0 * S + s0 + wl] = rs;
    agc_out[1 * S + s0 + wl] = pk;  // rel0*: memoryless, the carry as it was
  } else if (warp == kSmoothWarp && wl < ns) {
    agc_out[2 * S + s0 + wl] = g;
  }
}

template <typename R, int kPlan>
cudaError_t launch(const float* pcm, long long F, int L, const long long* left,
                   const float* wts, const float* gains, const float* coef,
                   const float* bq_in, float* bq_out, const float* agc_in,
                   float* agc_out, const float* params, void* ring,
                   int ring_row, float* partial, int n, int nblk,
                   cudaStream_t s) {
  const size_t shmem = alayout().bytes;
  auto kernel = fused_agc_kernel<R, kPlan>;
  if (shmem > 48 * 1024) {  // more than the default needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<nblk, kThreads, shmem, s>>>(
      pcm, F, L, left, reinterpret_cast<const float2*>(wts), gains, coef,
      bq_in, bq_out, agc_in, agc_out, params, static_cast<R*>(ring),
      ring_row, partial, n);
  return cudaGetLastError();
}

// checks the shape, launches the plan's kernel for the ring's type, then
// sums the blocks' partials
template <int kPlan>
int launch_plan(const float* pcm, long long F, int L, const long long* left,
                const float* wts, const float* gains, const float* coef,
                const float* bq_in, float* bq_out, const float* agc_in,
                float* agc_out, const float* params, void* ring, int ring_bf16,
                int ring_row, float* partial, float* out, int n,
                void* stream) {
  if (L < 2 || L % 2 || n < 1 || F < 1 || ring_row < 0 || ring_row >= kRing)
    return (int)cudaErrorInvalidValue;
  const int nblk = (L + kBL - 1) / kBL;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = ring_bf16 ? launch<__nv_bfloat16, kPlan> : launch<float, kPlan>;
  const cudaError_t err = run(pcm, F, L, left, wts, gains, coef, bq_in, bq_out,
                              agc_in, agc_out, params, ring, ring_row, partial,
                              n, nblk, s);
  if (err != cudaSuccess) return (int)err;
  return (int)rt::front::sum_partials(partial, out, nblk, 2LL * n, s);
}

}  // namespace

// lanes per block of K2, K2r, K2b and K2g: partial holds [ceil(L / this),
// 2, n] floats
extern "C" int rt_fused_agc_block_lanes() { return kBL; }

extern "C" int rt_fused_resample_biquad_agc_mix(
    const float* pcm, long long F, int L, const long long* left,
    const float* wts, const float* gains, const float* coef,
    const float* bq_in, float* bq_out, const float* agc_in, float* agc_out,
    const float* params, void* ring, int ring_bf16, int ring_row,
    float* partial, float* out, int n, void* stream) {
  return launch_plan<kSerial>(pcm, F, L, left, wts, gains, coef, bq_in,
                              bq_out, agc_in, agc_out, params, ring, ring_bf16,
                              ring_row, partial, out, n, stream);
}

// K2r: the same with a rel0 plan, rel0 (packed = 0: the ring holds each
// lane's square) or rel0f (packed = 1: the ring in the packed basis)
extern "C" int rt_fused_resample_biquad_agc_rel0_mix(
    const float* pcm, long long F, int L, const long long* left,
    const float* wts, const float* gains, const float* coef,
    const float* bq_in, float* bq_out, const float* agc_in, float* agc_out,
    const float* params, void* ring, int ring_bf16, int ring_row, int packed,
    float* partial, float* out, int n, void* stream) {
  auto run = packed ? launch_plan<kRel0f> : launch_plan<kRel0>;
  return run(pcm, F, L, left, wts, gains, coef, bq_in, bq_out, agc_in,
             agc_out, params, ring, ring_bf16, ring_row, partial, out, n,
             stream);
}

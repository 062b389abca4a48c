// K2g: K2 with its group branch, the group-rate AGC (agc_group = AG), on
// K1's pipeline.
//
// Replaces the group branch of rodio_tpu/ops/fused.py
// fused_resample_biquad_agc_mix / _fused_agc_kernel (:652-764):
// FusedWidePipeline(with_agc=True, agc_group=AG), the JAX package's opt-in
// that changes results (its AgcGroup contract, rodio_tpu/effects/agc.py).
// Stereo streams, lane l = 2s + c. The lerp and the biquad are K1's
// (fused_front.cuh) without the gain, which K2 applies after the AGC; the
// AGC then advances once per group of AG frames, the groups placed at
// multiples of AG from the stream's first frame, in the TPU kernel's
// order:
//
//   cur_c = sq[0] + sq[1] + ... + sq[AG-1]   per channel, sq = y*y, in
//           frame order; cur = cur_0 + cur_1
//   ym    = max over the group's frames and channels of |y|
//   q     = round(cur) to the ring's type (bf16 RNE or f32)
//   d     = q - old, old = q of the same stream's group 4096 frames earlier
//           (ring row (first frame / AG) mod 4096/AG), zero at the start
//   rs    = rs + d;  pk = max(ym, relG*pk + (1-relG)*ym)
//   g     = smooth_gain(g, desired_gain(rs, pk)) with attG and relG
//   mix[c, o] = sum over streams s of (y*g)*gain[2s + c]   (g of o's group)
//
// with attG = att^(2 AG) and relG = rel^(2 AG) by repeated squaring in f32
// (the JAX package's _ipow), computed here from the parameters, which stay
// data. The ring holds 4096/AG rows of S streams, one rounded group sum
// each; each element is read, then overwritten, by one thread.
//
// What bounds it on the H100: the biquad, as in K1: 3 dependent rounded ops
// per frame on the IIR half, one thread per lane (~0.079 ms at 12800
// frames). The rs/pk and smoother chains step once per group, AG times less
// often. AG is a power of two up to the RMS lag (it divides 4096), and
// blocks are whole groups.
//
// Design (fused_front.cuh: K1's block of 8 lanes, 4 stereo streams, so 128
// blocks for 1024 lanes; 128-frame tiles; K1's fill, copy, IIR and mix
// warps): the group AGC's elementwise stages go where K1's warps wait or
// idle, its serial chains on a warp of their own; SMSP 0 stays the IIR
// warp's (work beside it there slowed the IIR half by a quarter). At
// iteration i:
//
//   fill warps:  tile i's lerp and FIR half
//   copy warps:  first every ring load of tile i-2's groups; then the PCM
//                rows of tile i+2 and the row indices of tiles i+3, i+4;
//                while those copies fly, tile i-2's groups (one channel of
//                one a thread, the channel pair on neighbouring lanes: the
//                sums and the peak in frame order, then the ring's rounding
//                and write, d)
//   warp 0:      the IIR half of tile i-1
//   warp 4:      the rs/pk chains over tile i-3's groups, then the smoother
//                over tile i-5's, one thread per stream (8 steps each a
//                tile at AG = 16)
//   mix warps:   tile i-6's mix, the staircase gain applied (one channel's
//                4 frames a thread); then tile i-4's desired gains (one
//                (group, stream) a thread)
//
// A group longer than a tile (AG > 128) spans E = AG/128 - 1 more tiles:
// its thread carries the partial sums and the peak from tile to tile, the
// group's values land in its last tile's per-group tile, and the mix waits
// E more iterations for the gain, so E more y tiles and per-group tiles are
// kept in shared memory (188 KB at AG = 4096, 58 KB at AG = 16). The mix
// partials are summed over blocks in block order, in f64, as K1's. Every op
// rounds alone, so the biquad carries, the AGC carries and the ring equal
// the plain version's bit for bit, and the mix differs only by the order of
// its sum over streams.
#include "fused_agc_common.cuh"  // the ring's rounding
#include "fused_front.cuh"

namespace {

using namespace rt::front;
using rt::fused_agc::kRing;
using rt::fused_agc::ring_f32;
using rt::fused_agc::ring_round;

constexpr int kSB = kBL / 2;      // streams per block
constexpr int kGMax = kTile / 2;  // groups a tile holds at AG = 2
constexpr int kGLd = kSB + 1;     // a per-group row: the block's streams
constexpr int kAgcWarp = 4;       // the serial warp: rs/pk, then the smoother
// y tiles, per-group tiles and iterations from a tile's fill to its mix at
// AG <= 128; a longer group adds E to each but the GM tiles
constexpr int kYBufs = 7, kGDBufs = 5, kGMBufs = 3;
constexpr int kDepth = 6;
constexpr int kItems = kGMax * kSB / kMix;  // group items a mix thread takes at most
constexpr int kParts = 2 * kItems;          // ... and channels of group items
static_assert(kItems * kMix == kGMax * kSB, "whole items per thread");
static_assert(kCopy == kMix && kMix % 32 == 0,
              "the copy and mix groups take the same items; a channel pair in one warp");
static_assert(2 * (kTile / 4) == kMix, "4 frames of one channel a mix thread");
static_assert(block_lanes(2) == kBL, "blocks of kSB stereo streams");

// tiles a group spans beyond its first: 0 for AG <= 128
__host__ __device__ constexpr int extra_tiles(int ag) {
  return ag > kTile ? ag / kTile - 1 : 0;
}

// per-group rows of a tile: the groups a whole tile holds, or the one a
// longer group puts in each of its tiles
__host__ __device__ constexpr int group_rows(int ag) {
  return ag >= kTile ? 1 : kTile / ag;
}

// after the front end's buffers (float offsets): the per-group tiles GD (d,
// then rs, the desired gain and g) and GM (ym, then pk), each of
// group_rows(ag) rows of kGLd, and the lanes' gains; the total bytes
struct GLayout {
  size_t gd, gm, gain, bytes;
};

__host__ __device__ inline GLayout glayout(int ag) {
  const int E = extra_tiles(ag);
  const size_t gt = (size_t)group_rows(ag) * kGLd;
  GLayout g;
  g.gd = layout(kBL, kYBufs + E).bytes / sizeof(float);
  g.gm = g.gd + (kGDBufs + E) * gt;
  g.gain = g.gm + kGMBufs * gt;
  g.bytes = (g.gain + kBL) * sizeof(float);
  return g;
}

// kLong: AG > 128 (E > 0); otherwise E is the constant 0, so that the
// buffer indices of the common case stay constant divisions
template <typename R, bool kLong>
__global__ void __launch_bounds__(kThreads, 1)
fused_agc_group_kernel(const float* __restrict__ pcm, long long F, int L,
                       const long long* __restrict__ left,
                       const float2* __restrict__ wts,
                       const float* __restrict__ gains,
                       const float* __restrict__ coef,
                       const float* __restrict__ bq_in,
                       float* __restrict__ bq_out,
                       const float* __restrict__ agc_in,
                       float* __restrict__ agc_out,
                       const float* __restrict__ params, R* ring,
                       int ring_row, int ag, float* __restrict__ partial,
                       int n) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int E = kLong ? extra_tiles(ag) : 0, tpg = E + 1;  // tiles per group
  const int nGD = kGDBufs + E;
  const Front fe(smem, pcm, F, L, left, wts, n, kBL, kYBufs + E);
  const GLayout gl = glayout(ag);
  const int gpt = kLong ? 1 : kTile / ag;  // per-group rows of a tile
  float* const GD = smem + gl.gd;
  float* const GM = smem + gl.gm;
  float* const gain_sh = smem + gl.gain;
  auto gd = [&](int j, int k) { return GD + ((j % nGD) * gpt + k) * kGLd; };
  auto gm = [&](int j, int k) { return GM + ((j % kGMBufs) * gpt + k) * kGLd; };
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int ns = fe.nl / 2;
  const int S = L / 2, s0 = fe.lane0 / 2;
  const int ring_mask = kRing / ag - 1;  // ring rows: a power of two
  const int lg = 31 - __clz(ag);         // AG = 2^lg
  const rt::AgcParams p = rt::load_agc_params(params);
  const rt::BiquadCoef cf = rt::load_coef(coef);

  // carries: the IIR half on warp 0 (per lane), rs/pk and the gain on the
  // serial warp (per stream)
  float y1 = 0.f, y2 = 0.f;
  float rs = 0.f, pk = 0.f, g = 0.f, attG = 0.f, relG = 0.f, crelG = 0.f;
  if (warp == 0 && wl < fe.nl) {
    y1 = bq_in[2 * L + fe.lane0 + wl];
    y2 = bq_in[3 * L + fe.lane0 + wl];
  } else if (warp == kAgcWarp) {
    attG = rt::ipow(p.att, 2 * ag);
    relG = rt::ipow(p.rel, 2 * ag);
    crelG = rt::sub(1.0f, relG);
    if (wl < ns) {
      rs = agc_in[0 * S + s0 + wl];
      pk = agc_in[1 * S + s0 + wl];
      g = agc_in[2 * S + s0 + wl];
    }
  }
  if (tid < kBL) gain_sh[tid] = tid < fe.nl ? gains[fe.lane0 + tid] : 0.f;

  // ring element of stream s for the block's group kb
  auto ring_at = [&](int kb, int s) {
    return (long long)((ring_row + kb) & ring_mask) * S + s0 + s;
  };
  // the groups that end in tile i; the group items (whole groups, or a
  // part of one) in it; the block's index of its first group
  auto groups = [&](int i) {
    return E ? (int)((i + 1) % tpg == 0) : tile_len(n, i) >> lg;
  };
  auto items = [&](int i) { return E ? 1 : groups(i); };
  auto first_group = [&](int i) { return E ? i / tpg : i * gpt; };

  int gsub = 0;  // the thread's index in its group
  const int group = work_group(warp, wl, gsub);
  Row next[kStageRows];  // a copy thread's rows of the tile staged next
  fe.start(bq_in, group, gsub, next);

  // a group's partial sum of squares and peak of one channel, carried
  // across its tiles (AG > 128: copy thread gsub < 8 holds stream gsub / 2's
  // channel gsub % 2)
  float cur = 0.f, mx = 0.f;
  for (int it = 0; it < fe.n_tiles + kDepth + E; ++it) {
    if (warp == 0) {
      fe.iir(it, wl, cf, y1, y2);
    } else if (warp == kAgcWarp) {
      if (wl < ns && fe.live(it - 3)) {
        // in: d (GD) and ym (GM); out: rs (GD) and pk (GM)
        const int j = it - 3, G = groups(j);
#pragma unroll 4
        for (int k = 0; k < G; ++k) {
          float* d = gd(j, k) + wl;
          float* m = gm(j, k) + wl;
          rs = rt::add(rs, *d);
          const float ym = *m;
          pk = rt::max_nan(ym, rt::add(rt::mul(relG, pk), rt::mul(crelG, ym)));
          *d = rs;
          *m = pk;
        }
      }
      if (wl < ns && fe.live(it - 5)) {
        // in: the desired gains (GD); out: the group gains (GD)
        const int j = it - 5, G = groups(j);
#pragma unroll 4
        for (int k = 0; k < G; ++k) {
          float* d = gd(j, k) + wl;
          g = rt::smooth_gain(g, *d, attG, relG, p.max_gain);
          *d = g;
        }
      }
    } else if (group == 0) {
      fe.fill<false>(it, gsub, nullptr, 0.f, cf);
    } else if (group == 1) {
      // the ring's values leaving the window for the groups that end in
      // tile it-2, loaded first (clamped, always-valid addresses)
      const int jr = it - 2;
      const int gr = fe.live(jr) ? groups(jr) : 0;
      R old[kParts];
#pragma unroll
      for (int r = 0; r < kParts; ++r) {
        if (r * kMix >= 2 * kSB * gr) break;
        const int i = (gsub + r * kMix) >> 1;
        old[r] = ring[ring_at(first_group(jr) + min(i / kSB, gr - 1),
                              min(i % kSB, ns - 1))];
      }
      // the front end's copies; while they fly, tile it-2's group items
      fe.copy_step(it, gsub, next, [&] {
        // tile it-2's group items, one channel of one a thread: its
        // squares' sum and its peak in frame order, from the group's first
        // frame (its first tile) on, 16 bytes of frames at a time; the
        // channel-0 thread takes its partner's (lane ^ 1) channel 1 and,
        // where the group ends in the tile, writes the ring's rounded sum, d
        // and ym
        if (fe.live(jr)) {
          const int j = jr, gi = items(j);
          const float* yb = fe.y_tile(j);
          const bool first = j % tpg == 0;
          const int len = E ? kTile : ag;
#pragma unroll
          for (int r = 0; r < kParts; ++r) {
            if (r * kMix >= 2 * kSB * gi) break;  // alike for the whole warp
            const int i = gsub + r * kMix, c = i & 1, gk = (i >> 1) / kSB,
                      gs = (i >> 1) % kSB;
            const bool mine = gk < gi && gs < ns;
            if (mine) {
              const float* row = yb + (2 * gs + c) * kYLd + (E ? 0 : gk * ag);
              if (len >= 4) {
                const float4* r4 = reinterpret_cast<const float4*>(row);
                int q = 0;
                if (first) {
                  const float4 v = r4[0];
                  cur = rt::mul(v.x, v.x);
                  mx = fabsf(v.x);
                  cur = rt::add(cur, rt::mul(v.y, v.y));
                  mx = rt::max_nan(mx, fabsf(v.y));
                  cur = rt::add(cur, rt::mul(v.z, v.z));
                  mx = rt::max_nan(mx, fabsf(v.z));
                  cur = rt::add(cur, rt::mul(v.w, v.w));
                  mx = rt::max_nan(mx, fabsf(v.w));
                  q = 1;
                }
#pragma unroll 4
                for (; q < len / 4; ++q) {
                  const float4 v = r4[q];
                  cur = rt::add(cur, rt::mul(v.x, v.x));
                  mx = rt::max_nan(mx, fabsf(v.x));
                  cur = rt::add(cur, rt::mul(v.y, v.y));
                  mx = rt::max_nan(mx, fabsf(v.y));
                  cur = rt::add(cur, rt::mul(v.z, v.z));
                  mx = rt::max_nan(mx, fabsf(v.z));
                  cur = rt::add(cur, rt::mul(v.w, v.w));
                  mx = rt::max_nan(mx, fabsf(v.w));
                }
              } else {  // AG = 2
                const float v0 = row[0], v1 = row[1];
                cur = rt::add(rt::mul(v0, v0), rt::mul(v1, v1));
                mx = rt::max_nan(fabsf(v0), fabsf(v1));
              }
            }
            const float cur1 = __shfl_xor_sync(0xffffffffu, cur, 1);
            const float mx1 = __shfl_xor_sync(0xffffffffu, mx, 1);
            if (mine && c == 0 && gr) {  // the group ends in tile j
              const R q = ring_round<R>(rt::add(cur, cur1));
              ring[ring_at(first_group(j) + gk, gs)] = q;
              gd(j, gk)[gs] = rt::sub(ring_f32(q), ring_f32(old[r]));
              gm(j, gk)[gs] = rt::max_nan(mx, mx1);
            }
          }
        }
      });
    } else if (group == 2) {
      // tile it-6-E's mix: this block's streams per (channel, frame), in
      // stream order, each y times its group's gain and its lane's
      if (fe.live(it - kDepth - E)) {
        const int j = it - kDepth - E, tt = tile_len(n, j);
        const int c = gsub / (kTile / 4), t0 = gsub % (kTile / 4) * 4;
        if (t0 < tt) {
          const float* y = fe.y_tile(j);
          // the gains of each frame's group, in the tile where it ends
          const float* gg[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            gg[k] = E ? gd(j - j % tpg + E, 0) : gd(j, (t0 + k) >> lg);
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int s = 0; s < ns; ++s) {
            const float4 v = *reinterpret_cast<const float4*>(y + (2 * s + c) * kYLd + t0);
            const float vs[4] = {v.x, v.y, v.z, v.w};
            const float gain = gain_sh[2 * s + c];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float a = rt::mul(rt::mul(vs[k], gg[k][s]), gain);
              acc[k] = s ? rt::add(acc[k], a) : a;  // the first term alone
            }
          }
          float* out = partial + ((long long)blockIdx.x * 2 + c) * n + (long long)j * kTile + t0;
          if (n % 4 == 0 && t0 + 4 <= tt) {
            *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
          } else {
            for (int k = 0; k < 4 && t0 + k < tt; ++k) out[k] = acc[k];
          }
        }
      }
      // tile it-4's desired gains, over its rs (GD) and pk (GM), the
      // second warp's threads first
      if (fe.live(it - 4)) {
        const int j = it - 4, G = groups(j);
#pragma unroll
        for (int r = 0; r < kItems; ++r) {
          const int i = (gsub ^ 32) + r * kMix, gk = i / kSB, gs = i % kSB;
          if (gk < G && gs < ns) {
            float* v = gd(j, gk) + gs;
            *v = rt::desired_gain(*v, gm(j, gk)[gs], p);
          }
        }
      }
    }
    __syncthreads();
  }

  if (warp == 0) {
    fe.finish(bq_out, wl, y1, y2);
  } else if (warp == kAgcWarp && wl < ns) {
    agc_out[0 * S + s0 + wl] = rs;
    agc_out[1 * S + s0 + wl] = pk;
    agc_out[2 * S + s0 + wl] = g;
  }
}

template <typename R>
cudaError_t launch(const float* pcm, long long F, int L, const long long* left,
                   const float* wts, const float* gains, const float* coef,
                   const float* bq_in, float* bq_out, const float* agc_in,
                   float* agc_out, const float* params, void* ring,
                   int ring_row, int ag, float* partial, int n, int nblk,
                   cudaStream_t s) {
  const size_t shmem = glayout(ag).bytes;
  auto kernel = ag > kTile ? fused_agc_group_kernel<R, true>
                           : fused_agc_group_kernel<R, false>;
  if (shmem > 48 * 1024) {  // more than the default needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<nblk, kThreads, shmem, s>>>(
      pcm, F, L, left, reinterpret_cast<const float2*>(wts), gains, coef,
      bq_in, bq_out, agc_in, agc_out, params, static_cast<R*>(ring),
      ring_row, ag, partial, n);
  return cudaGetLastError();
}

}  // namespace

// partial holds [ceil(L / rt_fused_agc_block_lanes()), 2, n] floats; ring
// [4096 / agc_group, L / 2] of the ring's type, ring_row its row of the
// block's first group; agc_group a power of two from 2 to 4096 dividing n
extern "C" int rt_fused_resample_biquad_agc_group_mix(
    const float* pcm, long long F, int L, const long long* left,
    const float* wts, const float* gains, const float* coef,
    const float* bq_in, float* bq_out, const float* agc_in, float* agc_out,
    const float* params, void* ring, int ring_bf16, int ring_row,
    int agc_group, float* partial, float* out, int n, void* stream) {
  const int ag = agc_group;
  if (L < 2 || L % 2 || n < 1 || F < 1 || ag < 2 || ag > kRing ||
      kRing % ag || n % ag || ring_row < 0 || ring_row >= kRing / ag)
    return (int)cudaErrorInvalidValue;
  const int nblk = (L + kBL - 1) / kBL;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      ring_bf16
          ? launch<__nv_bfloat16>(pcm, F, L, left, wts, gains, coef, bq_in,
                                  bq_out, agc_in, agc_out, params, ring,
                                  ring_row, ag, partial, n, nblk, s)
          : launch<float>(pcm, F, L, left, wts, gains, coef, bq_in, bq_out,
                          agc_in, agc_out, params, ring, ring_row, ag,
                          partial, n, nblk, s);
  if (err != cudaSuccess) return (int)err;
  return (int)rt::front::sum_partials(partial, out, nblk, 2LL * n, s);
}

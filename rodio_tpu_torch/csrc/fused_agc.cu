// K2: resample + biquad + per-stream AGC + gain + stream mix, one pass; and
// K2r, the same pipeline under the serial rel0 plans.
//
// Replaces rodio_tpu/ops/fused.py fused_resample_biquad_agc_mix /
// _fused_agc_kernel with its serial plan (agc_group = 0, no rel0 plan):
// FusedWidePipeline(with_agc=True). Stereo streams, lane l = 2s + c. For
// each output frame o of each lane, as K1 (fused.cu) but with no gain
// before the biquad:
//
//   v = w0[j]*x[left] + w1[j]*x[left+1];  y = DF-I biquad of v
//
// then one AGC per stream over its interleaved samples (frame t: channel 0,
// then channel 1; src/source/agc.rs:397-496), in the TPU kernel's order
// (rodio_tpu/ops/fused.py:793-808 and :1160-1214):
//
//   q   = round(y*y) to the ring's type (bf16 RNE or f32)
//   d   = q - old, old = q of the same lane 4096 frames earlier (the
//         8192-sample RMS window), read from the ring, zero at the start
//   rs  = rs + d;  pk = max(|y|, rel*pk + (1-rel)*|y|)
//   g   = smooth_gain(g, desired_gain(rs, pk))          (agc_math.cuh)
//   mix[c, o] = sum over streams s of (y*g)*gain[2s + c]
//
// The gain is applied after the AGC, in the mix: the JAX package's order
// under AGC (gain_post is off). The ring holds 4096 frames x L lanes, row
// f % 4096 for global frame f; each element is read, then overwritten, by
// one thread, so it needs no slot arithmetic.
//
// What bounds it on the H100: four serial chains per stream, of which the
// gain smoother (~5 dependent rounded ops per interleaved sample, 2n per
// block) is the longest; the biquad (~3 per frame) and the rs/pk chains
// (~3 per sample) are shorter. The desired gain (an IEEE sqrt and two
// divides, three slow-path branches) depends only on rs and pk, so it is
// taken off the serial warps. Measured on an H100 80GB HBM3 at 700 W
// (512 streams, n = 12800): 0.55 ms, the smoother warp taking ~40 cycles
// per sample against 27 for its chain alone.
//
// Design: a block owns kBL = 8 lanes (4 streams; 128 blocks for 512
// streams) and walks time in tiles of 64 frames through a seven-stage
// pipeline, one __syncthreads per tile. At iteration i:
//
//   elementwise warps: fill tile i (the lerp), prep tile i-2 (q, the ring
//                      read and write, d), desired gain of tile i-4, mix of
//                      tile i-6 into per-block partials
//   warp 0: biquad of tile i-1, one thread per lane
//   warp 1: rs and pk chains of tile i-3, one thread per stream
//   warp 2: gain smoother of tile i-5 and y*g*gain, one thread per stream
//
// What keeps the serial warps fast, each found by measurement:
// - a warp issues on SMSP (warp % 4), and the scheduler does not favour a
//   serial warp, so no elementwise warp shares warp 1's or warp 2's SMSP
//   (warps 5 and 6 idle);
// - a serial warp runs its chain on registers, a chunk of its tile loaded
//   ahead and stored after, and a whole tile's copy of the chunk loop has
//   no per-step test (tt is the compile-time rt::Steps<kTile>): a branch
//   per step cost more than the step;
// - the chunk loops are not unrolled: unrolled, the serial warps' code
//   (~128 KB) cost more in instruction fetch than it saved.
// The elementwise warps keep the serial ones fed only if their global
// loads do not wait one after another: each thread issues all of an
// iteration's loads first (its elements' two PCM rows and ring value, and
// the next tile's row indices and weights, staged in shared memory one
// iteration ahead so that no load waits on another), then computes the
// desired gains and the mix out of shared memory, and only then uses the
// loaded values. Tiles live in dynamic shared memory: 7 of y, 4 of d / rs /
// desired gain and 2 of pk, with the staged rows. A second kernel sums the
// per-block partials in block order, so the mix is deterministic. Every op
// rounds alone.
//
// K2r replaces the rel0 and rel0f branches of the same TPU kernel
// (rodio_tpu/ops/fused.py:810-919): agc_plan="rel0" | "rel0f", for a
// release coefficient of exactly 0 (the default AgcSettings). The peak
// detector is then memoryless (its carry is left as it was) and the
// smoother a clamp of an affine map, g = max(0.1, min(d, att*g +
// (1-att)*d)), 4 dependent ops a sample instead of 5. The same pipeline,
// with these stages changed:
//
//   prep:    rel0f's ring holds the packed basis: lane 2s the rounded sq0,
//            lane 2s+1 the rounded f32 sq0 + sq1 of stream s;
//   warp 1:  only the window sum: per frame rs_lo = rs + d_lo, then rs =
//            rs + d_hi, one dependent add; in rel0 d_hi = d_0 + d_1 (the TPU
//            kernel's repack), in rel0f the ring's packed delta;
//   desired: rel0 the serial plan's form with the peak |y|; rel0f
//            min(target*rsqrt(max(rs/W, y*y)), max_gain) (max_gain at q = 0);
//   warp 2:  the 4-op smoother above.
//
// Its chain floor is 25600 x 4 dependent ops at n = 12800. Measured
// (benches/warp_cycles.py, H100 80GB HBM3 at 700 W, 512 streams, rel0f): the
// smoother warp ~4080 cycles a 64-frame tile (K2's ~4980), so the four
// elementwise warps (up to ~4440) now bind it: 0.49 ms against K2's 0.55.
#include "fused_agc_common.cuh"

namespace {

using namespace rt::fused_agc;

// the AGC plan a kernel instance runs
enum Plan : int { kSerial = 0, kRel0 = 1, kRel0f = 2 };

constexpr int kYBufs = 7, kDBufs = 4, kPBufs = 2;
constexpr int kDepth = 6;    // iterations from a tile's fill to its mix
constexpr int kCh = 8;       // frames per register chunk of warps 1 and 2
constexpr int kPer = kTile * kBL / kNWork;  // tile elements per thread
static_assert(kPer * kNWork == kTile * kBL, "whole tiles per thread");

constexpr size_t kTiles = sizeof(Tile) * (kYBufs + kDBufs + kPBufs);
constexpr size_t kShmem = kTiles + sizeof(Row) * 2 * kTile;
static_assert(kTiles % alignof(Row) == 0, "staged rows aligned");
static_assert(kShmem <= 48 * 1024, "more shared memory needs opting in");

// frames t0 .. t0+kCh-1 of a stream's two lanes (l0, l0 + 1) of a tile
__device__ __forceinline__ void load_chunk(const Tile& b, int t0, int l0,
                                           float (&v)[kCh][2]) {
#pragma unroll
  for (int u = 0; u < kCh; ++u) {
    v[u][0] = b[t0 + u][l0];
    v[u][1] = b[t0 + u][l0 + 1];
  }
}

template <class TT>
__device__ __forceinline__ void store_chunk(Tile& b, int t0, int l0, TT tt,
                                            const float (&v)[kCh][2]) {
#pragma unroll
  for (int u = 0; u < kCh; ++u) {
    if (kWhole<TT> || t0 + u < tt) {
      b[t0 + u][l0] = v[u][0];
      b[t0 + u][l0 + 1] = v[u][1];
    }
  }
}

// Runs step(a, b) over a stream's frames of a tile, kCh frames at a time:
// a and b are a frame's two samples of tiles A and B, in registers, loaded
// one chunk ahead; step rewrites them in place, and they are stored to
// tiles A2 and B2 (frames t < tt only; a null tile is not stored).
template <class TT, class Step>
__device__ __forceinline__ void stream_chunks(const Tile& A, const Tile& B,
                                              Tile* A2, Tile* B2, int l0,
                                              TT tt, Step step) {
  float a[kCh][2], b[kCh][2];
  load_chunk(A, 0, l0, a);
  load_chunk(B, 0, l0, b);
  // not unrolled: the serial warps' code stays small (unrolled, K2 spent
  // more time fetching instructions than it saved)
#pragma unroll 1
  for (int t0 = 0; t0 < kTile; t0 += kCh) {
    float an[kCh][2], bn[kCh][2];
    if (t0 + kCh < kTile) {
      load_chunk(A, t0 + kCh, l0, an);
      load_chunk(B, t0 + kCh, l0, bn);
    }
#pragma unroll
    for (int u = 0; u < kCh; ++u)
      if (kWhole<TT> || t0 + u < tt) step(a[u], b[u]);
    if (A2) store_chunk(*A2, t0, l0, tt, a);
    if (B2) store_chunk(*B2, t0, l0, tt, b);
    if (t0 + kCh < kTile) {
#pragma unroll
      for (int u = 0; u < kCh; ++u) {
        a[u][0] = an[u][0];
        a[u][1] = an[u][1];
        b[u][0] = bn[u][0];
        b[u][1] = bn[u][1];
      }
    }
  }
}

template <typename R, int kPlan>
__global__ void __launch_bounds__(kAgcThreads, 1)
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
  extern __shared__ float smem[];
  Tile* Y = reinterpret_cast<Tile*>(smem);
  Tile* D = Y + kYBufs;
  Tile* PK = D + kDBufs;
  Row* rows = reinterpret_cast<Row*>(reinterpret_cast<char*>(smem) + kTiles);
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int lane0 = blockIdx.x * kBL;
  const int nl = min(kBL, L - lane0);  // even: L is, and lane0 too
  const int ns = nl / 2;
  const int S = L / 2, s0 = lane0 / 2;
  const int n_tiles = (n + kTile - 1) / kTile;
  const rt::AgcParams p = rt::load_agc_params(params);
  const rt::BiquadCoef cf = rt::load_coef(coef);
  const float crel = rt::sub(1.0f, p.rel);
  const float catt = rt::sub(1.0f, p.att);

  // carries: biquad on warp 0 (per lane), rs/pk on warp 1 and the gain on
  // warp 2 (per stream)
  float x1 = 0.f, x2 = 0.f, y1 = 0.f, y2 = 0.f;
  float rs = 0.f, pk = 0.f, g = 0.f, gain0 = 0.f, gain1 = 0.f;
  if (warp == 0 && wl < nl) {
    x1 = bq_in[0 * L + lane0 + wl];
    x2 = bq_in[1 * L + lane0 + wl];
    y1 = bq_in[2 * L + lane0 + wl];
    y2 = bq_in[3 * L + lane0 + wl];
  } else if (warp == 1 && wl < ns) {
    rs = agc_in[0 * S + s0 + wl];
    pk = agc_in[1 * S + s0 + wl];
  } else if (warp == 2 && wl < ns) {
    g = agc_in[2 * S + s0 + wl];
    gain0 = gains[lane0 + 2 * wl];
    gain1 = gains[lane0 + 2 * wl + 1];
  }

  // element e of a tile: frame e / kBL, lane e % kBL (along a row); an
  // elementwise thread takes e = sub + k * kNWork, k < kPer
  auto stage_rows = [&](int i, int sub, Row& r) {  // tile i's frame `sub`
    const int tc = i * kTile + min(sub, tile_len(n, i) - 1);
    r.left = left[tc];
    r.w = wts[tc];
  };
  auto ring_at = [&](int i, int t, int l) {
    const int row = (ring_row + i * kTile + t) & (kRing - 1);
    return (long long)row * L + lane0 + l;
  };
  auto desired = [&](int i, int sub) {
    const int tt = tile_len(n, i);
    Tile& db = D[i % kDBufs];
    const Tile& pb = PK[i % kPBufs];
    const Tile& yb = Y[i % kYBufs];
#pragma unroll 1
    for (int u = 0; u < kPer; ++u) {
      const int e = sub + u * kNWork, t = e / kBL, l = e % kBL;
      if (t < tt && l < nl) {
        // the rel0 plans' peak is the current |y| (the detector is
        // memoryless at release 0)
        if (kPlan == kRel0f)
          db[t][l] = rt::desired_gain_folded(db[t][l], yb[t][l], p);
        else
          db[t][l] = rt::desired_gain(
              db[t][l], kPlan == kRel0 ? fabsf(yb[t][l]) : pb[t][l], p);
      }
    }
  };
  // this block's streams summed per (channel, frame), in stream order
  auto mix = [&](int i, int sub) {
    const int t0 = i * kTile, tt = tile_len(n, i);
    Tile& yb = Y[i % kYBufs];
    for (int e = sub; e < 2 * kTile; e += kNWork) {
      const int c = e / kTile, t = e % kTile;
      if (t < tt) {
        float acc = yb[t][c];
        for (int s = 1; s < ns; ++s) acc = rt::add(acc, yb[t][2 * s + c]);
        partial[((long long)blockIdx.x * 2 + c) * n + t0 + t] = acc;
      }
    }
  };
  auto live = [&](int j) { return j >= 0 && j < n_tiles; };

  if (tid < kTile) {
    Row r;
    stage_rows(0, tid, r);
    rows[tid] = r;
  }
  __syncthreads();
  for (int it = 0; it < n_tiles + kDepth; ++it) {
    if (warp == 0) {
      const int j = it - 1;
      if (live(j) && wl < nl) {
        Tile& b = Y[j % kYBufs];
        auto run = [&](auto tt) {
          biquad_column(b, wl, tt, cf, x1, x2, y1, y2);
        };
        full_or_tail(tile_len(n, j), run);
      }
    } else if (warp == 1) {
      const int j = it - 3;
      if (kPlan != kSerial) {
        if (live(j) && wl < ns) {
          // in: the frame's deltas (D); out: the window sum after each of
          // its sub-steps (D). The second tile is not read.
          Tile& db = D[j % kDBufs];
          auto step = [&](float (&d)[2], float (&)[2]) {
            const float dh = kPlan == kRel0 ? rt::add(d[0], d[1]) : d[1];
            d[0] = rt::add(rs, d[0]);
            rs = rt::add(rs, dh);
            d[1] = rs;
          };
          full_or_tail(tile_len(n, j), [&](auto tt) {
            stream_chunks(db, db, &db, nullptr, 2 * wl, tt, step);
          });
        }
      } else if (live(j) && wl < ns) {
        // in: d (D) and y (Y); out: rs (D) and pk (PK)
        Tile& db = D[j % kDBufs];
        auto step = [&](float (&d)[2], float (&y)[2]) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            rs = rt::add(rs, d[c]);
            const float xs = fabsf(y[c]);
            pk = rt::max_nan(xs,
                             rt::add(rt::mul(p.rel, pk), rt::mul(crel, xs)));
            d[c] = rs;
            y[c] = pk;
          }
        };
        full_or_tail(tile_len(n, j), [&](auto tt) {
          stream_chunks(db, Y[j % kYBufs], &db, &PK[j % kPBufs], 2 * wl, tt,
                        step);
        });
      }
    } else if (warp == 2) {
      const int j = it - 5;
      if (live(j) && wl < ns) {
        // in: desired gain (D) and y (Y); out: y*g*gain (Y)
        Tile& yb = Y[j % kYBufs];
        auto step = [&](float (&d)[2], float (&y)[2]) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            g = kPlan == kSerial
                    ? rt::smooth_gain(g, d[c], p.att, p.rel, p.max_gain)
                    : rt::smooth_gain_rel0(g, d[c], p.att, catt);
            y[c] = rt::mul(rt::mul(y[c], g), c ? gain1 : gain0);
          }
        };
        full_or_tail(tile_len(n, j), [&](auto tt) {
          stream_chunks(D[j % kDBufs], yb, nullptr, &yb, 2 * wl, tt, step);
        });
      }
    } else if (work_slot(warp) >= 0) {
      const int sub = work_slot(warp) * 32 + wl;
      const bool fill = live(it), prep = live(it - 2);
      const bool stage = live(it + 1) && sub < kTile;
      // 1. every global load of the iteration, from clamped, always-valid
      //    addresses (unsigned, so that a negative row clamps too)
      const Row* rf = rows + (it & 1) * kTile;  // tile it's staged rows
      const int ttf = fill ? tile_len(n, it) : 1;
      const int ttp = prep ? tile_len(n, it - 2) : 1;
      float xl[kPer], xr[kPer];
      R old[kPer];
      Row next;
      if (fill) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = sub + k * kNWork;
          const U64 r0 = (U64)rf[min(e / kBL, ttf - 1)].left;
          const long long lane = lane0 + min(e % kBL, nl - 1);
          xl[k] = pcm[min(r0, (U64)F - 1) * L + lane];
          xr[k] = pcm[min(r0 + 1, (U64)F - 1) * L + lane];
        }
      }
      if (prep) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = sub + k * kNWork;
          old[k] = ring[ring_at(it - 2, min(e / kBL, ttp - 1),
                                min(e % kBL, nl - 1))];
        }
      }
      if (stage) stage_rows(it + 1, sub, next);
      // 2. shared-memory work while the loads are in flight
      if (live(it - 4)) desired(it - 4, sub);
      if (live(it - 6)) mix(it - 6, sub);
      // 3. the loaded values used
      if (fill) {
        Tile& b = Y[it % kYBufs];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = sub + k * kNWork, t = e / kBL, l = e % kBL;
          if (t < ttf && l < nl) {
            const Row& r = rf[t];
            const float vl = (U64)r.left < (U64)F ? xl[k] : 0.f;
            const float vr = (U64)r.left + 1 < (U64)F ? xr[k] : 0.f;
            b[t][l] = rt::add(rt::mul(vl, r.w.x), rt::mul(vr, r.w.y));
          }
        }
      }
      if (prep) {
        Tile& yb = Y[(it - 2) % kYBufs];
        Tile& db = D[(it - 2) % kDBufs];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = sub + k * kNWork, t = e / kBL, l = e % kBL;
          if (t < ttp && l < nl) {
            const float y = yb[t][l];
            float sq = rt::mul(y, y);
            if (kPlan == kRel0f && (l & 1)) {  // the packed hi: sq0 + sq1
              const float y0 = yb[t][l - 1];
              sq = rt::add(rt::mul(y0, y0), sq);
            }
            const R q = ring_round<R>(sq);
            ring[ring_at(it - 2, t, l)] = q;
            db[t][l] = rt::sub(ring_f32(q), ring_f32(old[k]));
          }
        }
      }
      if (stage) rows[((it + 1) & 1) * kTile + sub] = next;
    }
    __syncthreads();
  }

  if (warp == 0 && wl < nl) {
    bq_out[0 * L + lane0 + wl] = x1;
    bq_out[1 * L + lane0 + wl] = x2;
    bq_out[2 * L + lane0 + wl] = y1;
    bq_out[3 * L + lane0 + wl] = y2;
  } else if (warp == 1 && wl < ns) {
    agc_out[0 * S + s0 + wl] = rs;
    agc_out[1 * S + s0 + wl] = pk;
  } else if (warp == 2 && wl < ns) {
    agc_out[2 * S + s0 + wl] = g;
  }
}

__global__ void agc_mix_partials_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int nblk,
                                        long long cn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cn) return;
  float acc = partial[i];
  for (int b = 1; b < nblk; ++b) acc = rt::add(acc, partial[b * cn + i]);
  out[i] = acc;
}

template <typename R, int kPlan>
cudaError_t launch(const float* pcm, long long F, int L, const long long* left,
                   const float* wts, const float* gains, const float* coef,
                   const float* bq_in, float* bq_out, const float* agc_in,
                   float* agc_out, const float* params, void* ring,
                   int ring_row, float* partial, int n, int nblk,
                   cudaStream_t s) {
  fused_agc_kernel<R, kPlan><<<nblk, kAgcThreads, kShmem, s>>>(
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
  cudaError_t err =
      ring_bf16 ? launch<__nv_bfloat16, kPlan>(pcm, F, L, left, wts, gains,
                                               coef, bq_in, bq_out, agc_in,
                                               agc_out, params, ring, ring_row,
                                               partial, n, nblk, s)
                : launch<float, kPlan>(pcm, F, L, left, wts, gains, coef,
                                       bq_in, bq_out, agc_in, agc_out, params,
                                       ring, ring_row, partial, n, nblk, s);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_partials(partial, out, nblk, n, s);
}

}  // namespace

cudaError_t rt::fused_agc::sum_partials(const float* partial, float* out,
                                        int nblk, int n, cudaStream_t s) {
  const long long cn = 2LL * n;
  agc_mix_partials_kernel<<<(unsigned)((cn + 255) / 256), 256, 0, s>>>(
      partial, out, nblk, cn);
  return cudaGetLastError();
}

// lanes per block: partial holds [ceil(L / this), 2, n] floats
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

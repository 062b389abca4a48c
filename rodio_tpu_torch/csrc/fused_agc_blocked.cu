// K2b: K2 under its blocked rel0 plans, rel0b* and rel0c*.
//
// Replaces the rel0b/rel0c branches of rodio_tpu/ops/fused.py
// fused_resample_biquad_agc_mix / _fused_agc_kernel (:920-1158):
// FusedWidePipeline(with_agc=True, agc_plan="rel0b16") is the JAX package's
// AGC-on bench leg. Stereo streams, lane l = 2s + c; the lerp and the biquad
// are K2's (fused_agc.cu). At a release coefficient of exactly 0 the AGC's
// smoother step is a clamp of an affine map of constant slope att,
//
//   f(g) = min(H, max(0.1, att*g + B)),  B = (1-att)*des, H = max(0.1, des),
//
// and such maps compose: f2(f1(g)) = min(H', max(L', att^2*g + B')). The
// JAX pipeline's grid steps of m*to frames split into RPC chunks of
// `chunk` = m*to / RPC frames; blocks start on a step, so a chunk is every
// `chunk` frames from the block's start. Per frame, in the TPU kernel's
// order, every op rounded alone:
//
//   ring:    packed basis, lane 2s = round(sq0), lane 2s+1 = round(sq0 +
//            sq1) (sq = y*y, f32 sum), d = q - old (old 4096 frames back)
//   window:  rel0b: rs_lo = rs + d_lo, rs = rs + d_hi; rel0c: the same
//            from 0 within each chunk, plus the chunk's base, the bases
//            chained over chunks (rs' = base + the chunk's total)
//   desired: q = max(rs*(1/W), y*y), des = q > 0 ? min(target*rsqrt(q),
//            max_gain) : max_gain; B and H as above
//   pass 2:  within each chunk, from (B, L, H) = (0, 0, max_gain), sub-step
//            by sub-step (ch0, then ch1): B' = att*B + b, L' = max(0.1,
//            att*L + b), H' = min(h, max(0.1, att*H + b))
//   pass 3:  per stream, g0[chunk] = g, then g = min(H, max(L, att^(2
//            chunk)*g + B)) with the chunk's last (B, L, H)
//   pass 4:  gain = min(H, max(L, ap*g0 + B)), ap = att^(2j+1) (ch0) and
//            att^(2j+2) (ch1) at the chunk's frame j, by serial products
//   mix:     sum over streams of (y*gain)*gain_lane
//
// What bounds it on the H100: the elementwise stages (the lerp's loads,
// the ring, an IEEE sqrt and divide per sample, pass 4 in the mix), spread
// over eight warps; the serial chains are short. The only chain through g is
// pass 3, one step per chunk; the window sum is one dependent add a frame;
// pass 2 runs on one thread per (stream, chunk) of a tile, ~4 dependent ops
// per sub-step (the H chain) over a chunk only; the biquad ~3 a frame.
// Measured (benches/warp_cycles.py, H100 80GB HBM3 at 700 W, 512 streams,
// rel0b16): 0.40 ms, iterations of ~3200 cycles with the mix warps the
// busiest (~3100) and the biquad warp at ~2150.
//
// Design: K2's tile pipeline (fused_agc_common.cuh: 8 lanes, 4 streams, a
// block), with tiles of whole chunks (as many as fit 64 frames, or one
// longer chunk up to 256 frames), so that no chunk straddles a tile, and 12
// warps. At iteration i:
//
//   elementwise warps (3, 4, 6-11): fill tile i (the lerp), prep tile i-2
//            (ring read and write, d), desired gains and maps of tile i-4
//            (rel0c: the chunk's base added here), pass 4 and the mix of
//            tile i-7 into per-block partials (on warps 8-11; warps 3 and 4
//            stage the next tile's lerp rows)
//   warp 0:  biquad of tile i-1, one thread per lane
//   warp 1:  window sums of tile i-3, one thread per stream
//   warp 5:  pass 2 of tile i-5, one thread per (stream, chunk), a few
//            frames at a time in registers
//   warp 2:  pass 3 of tile i-6, one thread per stream
//
// Four elementwise warps, K2's layout, bound the first version at 0.55 ms
// (iterations of ~4700 cycles against ~2100 for the biquad warp). The power
// table ap is built once per launch. Tiles and the table live in dynamic
// shared memory; a second kernel sums the partials in block order.
#include "fused_agc_common.cuh"

namespace {

using namespace rt::fused_agc;

constexpr int kTileTarget = 64;   // frames a tile of short chunks fills
constexpr int kMaxChunk = 256;    // the longest chunk (one a tile)
constexpr int kSB = kBL / 2;      // streams per block
constexpr int kStride = kBL + 1;  // floats per tile row (+1: no bank conflicts)
// tile buffers, and iterations from a tile's fill to its mix
constexpr int kYB = 8, kDB = 6, kHB = 4, kLB = 3, kGB = 2, kBB = 2;
constexpr int kDepth = 7;
constexpr int kCh = 8;            // frames per register chunk of a serial walk
constexpr int kCc = 4;            // ... of pass 2
// warps: 0 the biquad, 1 the window sums, 2 pass 3, 5 pass 2; the other
// eight the elementwise stages (they bound K2's layout, which has four)
constexpr int kWarps = 12, kThreads = kWarps * 32, kNElem = 8 * 32;

// the elementwise slot of a warp, or -1
__device__ __forceinline__ int elem_slot(int warp) {
  return warp == 3 || warp == 4 ? warp - 3 : warp >= 6 ? warp - 4 : -1;
}

// frames of a tile: whole chunks
__host__ __device__ constexpr int tile_frames(int chunk) {
  return chunk >= kTileTarget ? chunk : kTileTarget / chunk * chunk;
}

size_t shmem_bytes(int chunk) {
  const size_t tl = tile_frames(chunk);
  return sizeof(Row) * 2 * tl +
         sizeof(float) * ((kYB + kDB + kHB + kLB) * tl * kStride +
                          (kGB + kBB) * kTileTarget * kSB + 2 * chunk);
}

// Frames t0 .. t0+len-1 of lanes l0, l0+1 of a tile, in register chunks of
// kCh: loaded, step(v) on each frame's pair, stored back.
template <class Step>
__device__ __forceinline__ void walk_pairs(float* tile, int l0, int t0,
                                           int len, Step step) {
#pragma unroll 1
  for (int a = 0; a < len; a += kCh) {
    float* p = tile + (t0 + a) * kStride + l0;
    float v[kCh][2];
    if (a + kCh <= len) {
#pragma unroll
      for (int u = 0; u < kCh; ++u) {
        v[u][0] = p[u * kStride];
        v[u][1] = p[u * kStride + 1];
      }
#pragma unroll
      for (int u = 0; u < kCh; ++u) step(v[u]);
#pragma unroll
      for (int u = 0; u < kCh; ++u) {
        p[u * kStride] = v[u][0];
        p[u * kStride + 1] = v[u][1];
      }
    } else {
      for (int u = 0; u < len - a; ++u) {
        v[0][0] = p[u * kStride];
        v[0][1] = p[u * kStride + 1];
        step(v[0]);
        p[u * kStride] = v[0][0];
        p[u * kStride + 1] = v[0][1];
      }
    }
  }
}

// one biquad step on v in place, carries this thread's lane's
__device__ __forceinline__ void bq_step(const rt::BiquadCoef& cf, float& v,
                                        float& x1, float& x2, float& y1,
                                        float& y2) {
  const float yt = rt::biquad_step(cf, v, x1, x2, y1, y2);
  x2 = x1;
  x1 = v;
  y2 = y1;
  y1 = yt;
  v = yt;
}

// the biquad down lane wl's column of a tile's tt frames, 16 at a time in
// registers
__device__ __forceinline__ void biquad_walk(float* b, int wl, int tt,
                                            const rt::BiquadCoef& cf,
                                            float& x1, float& x2, float& y1,
                                            float& y2) {
#pragma unroll 1
  for (int t0 = 0; t0 < tt; t0 += kBqCh) {
    float* p = b + t0 * kStride + wl;
    if (t0 + kBqCh <= tt) {
      float v[kBqCh];
#pragma unroll
      for (int u = 0; u < kBqCh; ++u) v[u] = p[u * kStride];
#pragma unroll
      for (int u = 0; u < kBqCh; ++u) bq_step(cf, v[u], x1, x2, y1, y2);
#pragma unroll
      for (int u = 0; u < kBqCh; ++u) p[u * kStride] = v[u];
    } else {
      for (int u = 0; u < tt - t0; ++u) {
        float v = p[u * kStride];
        bq_step(cf, v, x1, x2, y1, y2);
        p[u * kStride] = v;
      }
    }
  }
}

// one sub-step of pass 2: the composed map (B, L, H) after the step map of
// b = (1-att)*des, h = max(0.1, des) (rodio_tpu/ops/fused.py:1070-1077)
__device__ __forceinline__ void compose(float att, float b, float h, float& B,
                                        float& Lm, float& H) {
  B = rt::add(rt::mul(att, B), b);
  Lm = rt::max_nan(rt::add(rt::mul(att, Lm), b), 0.1f);
  H = rt::min_nan(h, rt::max_nan(rt::add(rt::mul(att, H), b), 0.1f));
}

// pass 2 over N frames of a stream's (B, H, L) columns from row 0 of db,
// hb, lb: loaded into registers first, so the chain waits on no load
template <int N>
__device__ __forceinline__ void compose_frames(float* db, float* hb, float* lb,
                                               float att, float& B, float& Lm,
                                               float& H) {
  float b[N][2], h[N][2], l[N][2];
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      b[u][c] = db[u * kStride + c];
      h[u][c] = hb[u * kStride + c];
    }
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      compose(att, b[u][c], h[u][c], B, Lm, H);
      b[u][c] = B;
      l[u][c] = Lm;
      h[u][c] = H;
    }
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      db[u * kStride + c] = b[u][c];
      lb[u * kStride + c] = l[u][c];
      hb[u * kStride + c] = h[u][c];
    }
}

// kTiled: rel0c's chunked window sum; kPer: tile elements per elementwise
// thread (a tile of up to 32 * kPer frames)
template <typename R, bool kTiled, int kPer>
__global__ void __launch_bounds__(kThreads, 1)
fused_agc_blocked_kernel(const float* __restrict__ pcm, long long F, int L,
                         const long long* __restrict__ left,
                         const float2* __restrict__ wts,
                         const float* __restrict__ gains,
                         const float* __restrict__ coef,
                         const float* __restrict__ bq_in,
                         float* __restrict__ bq_out,
                         const float* __restrict__ agc_in,
                         float* __restrict__ agc_out,
                         const float* __restrict__ params, R* ring,
                         int ring_row, int chunk, float* __restrict__ partial,
                         int n) {
  extern __shared__ float4 smem[];
  __shared__ float gain_sh[kBL];
  const int TL = tile_frames(chunk), tsz = TL * kStride;
  Row* rows = reinterpret_cast<Row*>(smem);
  float* Y = reinterpret_cast<float*>(rows + 2 * TL);  // y (and the lerp)
  float* D = Y + kYB * tsz;     // d, window sums, then the maps' B
  float* H = D + kDB * tsz;     // the maps' H
  float* Lt = H + kHB * tsz;    // the maps' L
  float* G0 = Lt + kLB * tsz;   // [kGB][chunk of a tile][stream]: pass 3's g
  float* BS = G0 + kGB * kTileTarget * kSB;  // [kBB][chunk][stream]: rel0c's bases
  float* AP = BS + kBB * kTileTarget * kSB;  // [j][c]: att^(2j+1+c)
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int lane0 = blockIdx.x * kBL;
  const int nl = min(kBL, L - lane0);  // even: L is, and lane0 too
  const int ns = nl / 2;
  const int S = L / 2, s0 = lane0 / 2;
  const int n_tiles = (n + TL - 1) / TL;
  const rt::AgcParams p = rt::load_agc_params(params);
  const rt::BiquadCoef cf = rt::load_coef(coef);
  const float catt = rt::sub(1.0f, p.att);

  // carries: biquad on warp 0 (per lane), the window sum (and the untouched
  // peak) on warp 1 and the gain on warp 2 (per stream)
  float x1 = 0.f, x2 = 0.f, y1 = 0.f, y2 = 0.f;
  float rs = 0.f, pk = 0.f, g = 0.f;
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
  }
  if (tid < kBL) gain_sh[tid] = tid < nl ? gains[lane0 + tid] : 0.f;
  if (tid == kThreads - 1) {  // the power table, in the serial order
    float ap = p.att;
    for (int j = 0; j < chunk; ++j) {
      const float ap2 = rt::mul(ap, p.att);
      AP[2 * j] = ap;
      AP[2 * j + 1] = ap2;
      ap = rt::mul(ap2, p.att);
    }
  }
  const float att_r = rt::ipow(p.att, 2 * chunk);

  auto tlen = [&](int i) { return min(TL, n - i * TL); };
  auto at = [&](float* base, int nbuf, int i, int t, int l) -> float& {
    return base[(i % nbuf) * tsz + t * kStride + l];
  };
  auto stage_rows = [&](int i, int sub, Row& r) {  // tile i's frame `sub`
    const int tc = i * TL + min(sub, tlen(i) - 1);
    r.left = left[tc];
    r.w = wts[tc];
  };
  auto ring_at = [&](int i, int t, int l) {
    const int row = (ring_row + i * TL + t) & (kRing - 1);
    return (long long)row * L + lane0 + l;
  };
  auto live = [&](int j) { return j >= 0 && j < n_tiles; };

  for (int k = tid; k < TL; k += kThreads) {
    Row r;
    stage_rows(0, k, r);
    rows[k] = r;
  }
  __syncthreads();
  for (int it = 0; it < n_tiles + kDepth; ++it) {
    if (warp == 0) {
      const int j = it - 1;
      if (live(j) && wl < nl)
        biquad_walk(Y + (j % kYB) * tsz, wl, tlen(j), cf, x1, x2, y1, y2);
    } else if (warp == 1) {
      const int j = it - 3;
      if (live(j) && wl < ns) {
        // in: the packed deltas (D); out: the window sums (D)
        float* db = D + (j % kDB) * tsz;
        if (!kTiled) {
          walk_pairs(db, 2 * wl, 0, tlen(j), [&](float (&v)[2]) {
            v[0] = rt::add(rs, v[0]);
            rs = rt::add(rs, v[1]);
            v[1] = rs;
          });
        } else {
          // the sums from 0 within each chunk; the chunk's base goes to BS
          // and is added in the desired-gain stage
          float* bs = BS + (j % kBB) * kTileTarget * kSB;
          for (int c0 = 0; c0 < tlen(j); c0 += chunk) {
            float acc = 0.f;
            walk_pairs(db, 2 * wl, c0, chunk, [&](float (&v)[2]) {
              v[0] = rt::add(acc, v[0]);
              acc = rt::add(acc, v[1]);
              v[1] = acc;
            });
            bs[c0 / chunk * kSB + wl] = rs;
            rs = rt::add(rs, acc);
          }
        }
      }
    } else if (warp == 2) {
      const int j = it - 6;
      if (live(j) && wl < ns) {
        // pass 3: g through the chunks' total maps (their last sub-step)
        const int l = 2 * wl + 1;
        float* g0 = G0 + (j % kGB) * kTileTarget * kSB;
        for (int c = 0; c < tlen(j) / chunk; ++c) {
          const int t = c * chunk + chunk - 1;
          g0[c * kSB + wl] = g;
          g = rt::min_nan(at(H, kHB, j, t, l),
                          rt::max_nan(at(Lt, kLB, j, t, l),
                                      rt::add(rt::mul(att_r, g),
                                              at(D, kDB, j, t, l))));
        }
      }
    } else if (warp == 5) {
      const int j = it - 5;
      if (live(j)) {
        // pass 2: one (stream, chunk) per thread, sub-steps in order
        const int items = tlen(j) / chunk * kSB;
        for (int k = wl; k < items; k += 32) {
          const int s = k % kSB, c0 = k / kSB * chunk;
          if (s >= ns) continue;
          const int o = c0 * kStride + 2 * s;
          float* db = D + (j % kDB) * tsz + o;
          float* hb = H + (j % kHB) * tsz + o;
          float* lb = Lt + (j % kLB) * tsz + o;
          float B = 0.f, Lm = 0.f, Hm = p.max_gain;
          int r = 0;
#pragma unroll 1
          for (; r + kCc <= chunk; r += kCc)
            compose_frames<kCc>(db + r * kStride, hb + r * kStride,
                                lb + r * kStride, p.att, B, Lm, Hm);
#pragma unroll 1
          for (; r < chunk; ++r)
            compose_frames<1>(db + r * kStride, hb + r * kStride,
                              lb + r * kStride, p.att, B, Lm, Hm);
        }
      }
    } else if (elem_slot(warp) >= 0) {
      const int sub = elem_slot(warp) * 32 + wl;
      const bool fill = live(it), prep = live(it - 2);
      // 1. every global load of the iteration, from clamped, always-valid
      //    addresses (unsigned, so that a negative row clamps too)
      const Row* rf = rows + (it & 1) * TL;  // tile it's staged rows
      const int ttf = fill ? tlen(it) : 1;
      const int ttp = prep ? tlen(it - 2) : 1;
      float xl[kPer], xr[kPer];
      R old[kPer];
      Row next;
      if (fill) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = sub + k * kNElem;
          const U64 r0 = (U64)rf[min(e / kBL, ttf - 1)].left;
          const long long lane = lane0 + min(e % kBL, nl - 1);
          xl[k] = pcm[min(r0, (U64)F - 1) * L + lane];
          xr[k] = pcm[min(r0 + 1, (U64)F - 1) * L + lane];
        }
      }
      if (prep) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = sub + k * kNElem;
          old[k] = ring[ring_at(it - 2, min(e / kBL, ttp - 1),
                                min(e % kBL, nl - 1))];
        }
      }
      const bool stage = live(it + 1) && sub < TL;
      if (stage) stage_rows(it + 1, sub, next);
      // 2. shared-memory work while the loads are in flight: the desired
      //    gains and step maps of tile it-4, the gains and mix of tile it-7
      if (live(it - 4)) {
        const int i = it - 4, tt = tlen(i);
        const float* bs = BS + (i % kBB) * kTileTarget * kSB;
        for (int e = sub; e < tt * kBL; e += kNElem) {
          const int t = e / kBL, l = e % kBL;
          if (l < nl) {
            float rsv = at(D, kDB, i, t, l);
            if (kTiled) rsv = rt::add(rsv, bs[t / chunk * kSB + l / 2]);
            const float des =
                rt::desired_gain_folded(rsv, at(Y, kYB, i, t, l), p);
            at(D, kDB, i, t, l) = rt::mul(catt, des);
            at(H, kHB, i, t, l) = rt::max_nan(des, 0.1f);
          }
        }
      }
      if (live(it - kDepth)) {
        const int i = it - kDepth, tt = tlen(i);
        const float* g0 = G0 + (i % kGB) * kTileTarget * kSB;
        // from the last slot down: the first ones stage the rows
        for (int e = kNElem - 1 - sub; e < 2 * TL; e += kNElem) {
          const int c = e / TL, t = e % TL;
          if (t < tt) {
            const int ck = t / chunk, r = t % chunk;
            const float ap = AP[2 * r + c];
            float acc = 0.f;
            for (int s = 0; s < ns; ++s) {
              const int l = 2 * s + c;
              const float gain = rt::min_nan(
                  at(H, kHB, i, t, l),
                  rt::max_nan(at(Lt, kLB, i, t, l),
                              rt::add(rt::mul(ap, g0[ck * kSB + s]),
                                      at(D, kDB, i, t, l))));
              const float v =
                  rt::mul(rt::mul(at(Y, kYB, i, t, l), gain), gain_sh[l]);
              acc = s ? rt::add(acc, v) : v;
            }
            partial[((long long)blockIdx.x * 2 + c) * n + i * TL + t] = acc;
          }
        }
      }
      // 3. the loaded values used
      if (fill) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = sub + k * kNElem, t = e / kBL, l = e % kBL;
          if (t < ttf && l < nl) {
            const Row& r = rf[t];
            const float vl = (U64)r.left < (U64)F ? xl[k] : 0.f;
            const float vr = (U64)r.left + 1 < (U64)F ? xr[k] : 0.f;
            at(Y, kYB, it, t, l) = rt::add(rt::mul(vl, r.w.x), rt::mul(vr, r.w.y));
          }
        }
      }
      if (prep) {
        const int i = it - 2;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int e = sub + k * kNElem, t = e / kBL, l = e % kBL;
          if (t < ttp && l < nl) {
            const float y0 = at(Y, kYB, i, t, l & ~1);
            float sq = rt::mul(y0, y0);
            if (l & 1) {  // the packed hi: sq0 + sq1
              const float y = at(Y, kYB, i, t, l);
              sq = rt::add(sq, rt::mul(y, y));
            }
            const R q = ring_round<R>(sq);
            ring[ring_at(i, t, l)] = q;
            at(D, kDB, i, t, l) = rt::sub(ring_f32(q), ring_f32(old[k]));
          }
        }
      }
      if (stage) rows[((it + 1) & 1) * TL + sub] = next;
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
    agc_out[1 * S + s0 + wl] = pk;  // the peak: memoryless at release 0
  } else if (warp == 2 && wl < ns) {
    agc_out[2 * S + s0 + wl] = g;
  }
}

template <typename R, bool kTiled, int kPer>
cudaError_t launch(const float* pcm, long long F, int L, const long long* left,
                   const float* wts, const float* gains, const float* coef,
                   const float* bq_in, float* bq_out, const float* agc_in,
                   float* agc_out, const float* params, void* ring,
                   int ring_row, int chunk, float* partial, int n, int nblk,
                   cudaStream_t s) {
  const size_t shmem = shmem_bytes(chunk);
  auto kernel = fused_agc_blocked_kernel<R, kTiled, kPer>;
  if (shmem > 48 * 1024) {  // more than the default needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<nblk, kThreads, shmem, s>>>(
      pcm, F, L, left, reinterpret_cast<const float2*>(wts), gains, coef,
      bq_in, bq_out, agc_in, agc_out, params, static_cast<R*>(ring), ring_row,
      chunk, partial, n);
  return cudaGetLastError();
}

// the instance for the ring's type, the window sum's form and the tile's
// length (kPer elements a thread: tiles up to 64, 128 or 256 frames)
template <typename R, bool kTiled>
cudaError_t launch_tiles(const float* pcm, long long F, int L,
                         const long long* left, const float* wts,
                         const float* gains, const float* coef,
                         const float* bq_in, float* bq_out,
                         const float* agc_in, float* agc_out,
                         const float* params, void* ring, int ring_row,
                         int chunk, float* partial, int n, int nblk,
                         cudaStream_t s) {
  const int tl = tile_frames(chunk);
  auto run = tl <= 64    ? launch<R, kTiled, 64 * kBL / kNElem>
             : tl <= 128 ? launch<R, kTiled, 128 * kBL / kNElem>
                         : launch<R, kTiled, 256 * kBL / kNElem>;
  return run(pcm, F, L, left, wts, gains, coef, bq_in, bq_out, agc_in,
             agc_out, params, ring, ring_row, chunk, partial, n, nblk, s);
}

}  // namespace

// partial holds [ceil(L / rt_fused_agc_block_lanes()), 2, n] floats; ring
// [4096, L] of the ring's type in the packed basis, ring_row the row of the
// block's first frame; chunk (1 .. 256) divides n; tiled: rel0c's window sum
extern "C" int rt_fused_resample_biquad_agc_blocked_mix(
    const float* pcm, long long F, int L, const long long* left,
    const float* wts, const float* gains, const float* coef,
    const float* bq_in, float* bq_out, const float* agc_in, float* agc_out,
    const float* params, void* ring, int ring_bf16, int ring_row, int chunk,
    int tiled, float* partial, float* out, int n, void* stream) {
  if (L < 2 || L % 2 || n < 1 || F < 1 || ring_row < 0 || ring_row >= kRing ||
      chunk < 1 || chunk > kMaxChunk || n % chunk)
    return (int)cudaErrorInvalidValue;
  const int nblk = (L + kBL - 1) / kBL;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = ring_bf16 ? (tiled ? launch_tiles<__nv_bfloat16, true>
                                : launch_tiles<__nv_bfloat16, false>)
                       : (tiled ? launch_tiles<float, true>
                                : launch_tiles<float, false>);
  const cudaError_t err =
      run(pcm, F, L, left, wts, gains, coef, bq_in, bq_out, agc_in, agc_out,
          params, ring, ring_row, chunk, partial, n, nblk, s);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_partials(partial, out, nblk, n, s);
}

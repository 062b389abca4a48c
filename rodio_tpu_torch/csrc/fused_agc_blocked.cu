// K2b: K2 under its blocked rel0 plans, rel0b* and rel0c*, on K1's
// front end.
//
// Replaces the rel0b/rel0c branches of rodio_tpu/ops/fused.py
// fused_resample_biquad_agc_mix / _fused_agc_kernel (:920-1158):
// FusedWidePipeline(with_agc=True, agc_plan="rel0b16") is the JAX package's
// AGC-on bench leg. Stereo streams, lane l = 2s + c. The lerp and the
// biquad are K1's (fused_front.cuh) without the gain, which K2 applies
// after the AGC. At a release coefficient of exactly 0 the AGC's smoother
// step is a clamp of an affine map of constant slope att,
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
// What bounds it on the H100: the biquad's IIR half, as in K1, is a chain
// of 3 dependent rounded ops a frame on one thread per lane (~0.078 ms at
// 12800 frames); around it the AGC's stages are elementwise (the ring, an
// IEEE sqrt and divide a sample, pass 4 and the mix) or short chains (the
// window sum, one dependent add a frame per stream; pass 2, ~4 dependent
// ops a sub-step within a chunk; pass 3, one step a chunk). Shared memory
// traffic binds them: stages whose stores went 4 ways to one bank (pass 2
// on lane-major tiles) slowed every warp's loads. On K2's 64-frame
// pipeline (the earlier design) eight elementwise warps bound it at ~3240
// cycles an iteration (0.39 ms, NVIDIA H100 80GB HBM3, 700 W); this design
// runs iterations of ~3450 cycles for twice the frames, pass 2's warp and
// the mix warps binding at ~3050, the IIR warp at ~2800 (0.21-0.23 ms at
// path E's shape, chip_smoke.py and benches/warp_cycles.py, the same card).
//
// Chunks and tiles: a path E chunk is 320 / 16 = 20 frames, and the front
// end's tile is 128 frames at compile time, no multiple of 20. This cuts
// each tile into pieces at the chunk boundaries, and pass 2 carries a
// chunk's partial (B, L, H) from a tile's last piece to the next tile's
// first (as K2g carries a group longer than a tile), so any chunk length
// runs on K1's tile unchanged: a front-end tile of whole chunks would need
// a tile length per chunk length (20, 40, 80, 160, ... up to 256), each
// its own instance of K1's staging, fill and IIR register runs. Pass 3
// writes g0 for every piece of a tile; pass 4 finds a frame's piece and
// its row in the chunk from its position.
//
// Design (fused_front.cuh: K1's block of 8 lanes, 4 stereo streams, so 128
// blocks for 1024 lanes; 128-frame tiles; K1's fill, copy and IIR warps):
// the AGC's elementwise stages where K1's warps wait or idle on SMSPs 1-3,
// its three serial chains on the idle warps beside the IIR warp on SMSP 0
// (chains issue little; K2g's elementwise work there slowed the IIR half by
// a quarter). At iteration i:
//
//   fill warps:  tile i's lerp and FIR half; then tile i-4's desired gains
//                over its window sums, 4 frames of one lane a thread
//   copy warps:  the ring's words of tile i-1 (a frame's 8 lanes in one
//                16-byte load where the rows allow, 2 frames a thread),
//                used an iteration later; the PCM rows of tile i+2 and the
//                row indices of tiles i+3, i+4; while those copies fly,
//                tile i-2's squares, the ring's rounding and write, and d
//   warp 0:      the IIR half of tile i-1
//   warp 4:      the window sums of tile i-3, one thread per stream
//   warp 8:      pass 2 of tile i-5, one (stream, piece) a thread, its maps
//                stored frame-major (kMLd), so its stores and the mix's
//                loads meet no bank twice
//   warp 12:     pass 3 over tile i-6, one thread per stream
//   mix warps:   the gains (pass 4) and the mix of tile i-7, one frame of
//                one channel an item
//
// 120 KB of shared memory. The mix partials are summed over blocks in
// block order, in f64, as K1's. Every op rounds alone in the plain
// version's order, so the biquad carries, the AGC carries and the ring
// equal the plain version's bit for bit, and the mix differs only by the
// order of its sum over streams and blocks.
#include "fused_agc_common.cuh"  // the ring
#include "fused_front.cuh"

namespace {

using namespace rt::front;
using rt::fused_agc::kRing;
using rt::fused_agc::kWords;
using rt::fused_agc::ring_frame;
using rt::fused_agc::ring_load;

constexpr int kSB = kBL / 2;       // streams a block
constexpr int kMaxChunk = 256;     // the longest chunk the wrapper passes
constexpr int kMaxPieces = kTile;  // pieces of a tile at most (chunks of 1)
constexpr int kWinWarp = 4;        // the window sums (SMSP 0)
constexpr int kComposeWarp = 8;    // pass 2 (SMSP 0)
constexpr int kGainWarp = 12;      // pass 3 (SMSP 0)
// y tiles, d tiles (then the window sums, then the desired gains), the
// composed maps' tiles, and iterations from a tile's fill to its mix
constexpr int kYBufs = 8, kDBufs = 4, kMBufs = 3;
// A maps tile is frame-major, [frame][B, L, H][channel][stream] with a pad
// float a frame: pass 2's threads, one a (stream, piece), store to 32
// different banks (the pieces of a 20-frame chunk start 20 frames apart,
// 20 * 25 = 500 = 20 mod 32 banks), and the mix's, one a frame, load from
// 32 different banks (25 is odd)
constexpr int kMLd = 3 * kBL + 1;
constexpr int kDepth = 7;
constexpr int kCc = 4;             // frames a pass 2 thread holds at once
constexpr int kFrames = kTile / kCopy;  // frames of a tile a copy thread takes
static_assert(kFill == kBL * (kTile / 4), "4 frames of one lane a fill thread");
static_assert(kMix == 2 * (kTile / 4), "the mix: 4 frames of one channel a thread");
static_assert(block_lanes(2) == kBL, "blocks of kSB stereo streams");

// after the front end's buffers (float offsets): the d tiles ([lane][kYLd]
// each), the maps tiles ([kTile][kMLd]), pass 3's g0 a piece
// ([2][kMaxPieces][kSB]), pass 2's carried (B, L, H) ([2][3][kSB]), the
// power table ([2 * kMaxChunk]) and the lanes' gains; the total bytes
struct BLayout {
  size_t d, m, g0, pc, ap, gain, bytes;
};

__host__ __device__ inline BLayout blayout() {
  BLayout b;
  b.d = layout(kBL, kYBufs).bytes / sizeof(float);
  b.m = b.d + (size_t)kDBufs * kBL * kYLd;
  b.g0 = b.m + (size_t)kMBufs * kTile * kMLd;
  b.pc = b.g0 + 2 * kMaxPieces * kSB;
  b.ap = b.pc + 2 * 3 * kSB;
  b.gain = b.ap + 2 * kMaxChunk;
  b.bytes = (b.gain + kBL) * sizeof(float);
  return b;
}

// A tile's pieces: the frames between its chunk boundaries. Piece 0 starts
// at the tile's start, `off` frames into its chunk; piece p >= 1 at frame
// first + (p-1)*chunk, a chunk's first frame.
struct Pieces {
  int off, first, np, chunk, tt;
  __device__ Pieces(int j, int tt_, int chunk_) : chunk(chunk_), tt(tt_) {
    off = j * kTile % chunk;
    first = chunk - off;
    np = first >= tt ? 1 : 1 + (tt - first + chunk - 1) / chunk;
  }
  __device__ int begin(int p) const { return p ? first + (p - 1) * chunk : 0; }
  // the piece's end, a chunk boundary unless the tile ends first
  __device__ int end(int p) const { return min(first + p * chunk, tt); }
  __device__ bool ends_chunk(int p) const { return first + p * chunk <= tt; }
};

// one sub-step of pass 2: the composed map (B, L, H) after the step map of
// b = (1-att)*des, h = max(0.1, des) (rodio_tpu/ops/fused.py:1070-1077)
__device__ __forceinline__ void compose(float att, float catt, float des, float& B,
                                        float& Lm, float& H) {
  const float b = rt::mul(catt, des), h = rt::max_nan(des, 0.1f);
  B = rt::add(rt::mul(att, B), b);
  Lm = rt::max_nan(rt::add(rt::mul(att, Lm), b), 0.1f);
  H = rt::min_nan(h, rt::max_nan(rt::add(rt::mul(att, H), b), 0.1f));
}

// pass 2 over N frames of a stream: d points at frame 0 of its lane 2s row
// of desired gains (lane 2s+1's kYLd further), m at frame 0 of its maps
// (stream s of channel 0); the desired gains loaded into registers first,
// so the chain waits on no load
template <int N>
__device__ __forceinline__ void compose_frames(const float* d, float* m, float att,
                                               float catt, float& B, float& Lm,
                                               float& H) {
  float dv[N][2];
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int c = 0; c < 2; ++c) dv[u][c] = d[c * kYLd + u];
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      compose(att, catt, dv[u][c], B, Lm, H);
      float* const mc = m + u * kMLd + c * kSB;
      mc[0] = B;
      mc[kBL] = Lm;
      mc[2 * kBL] = H;
    }
}

// kTiled: rel0c's chunked window sum
template <typename R, bool kTiled>
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
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const Front fe(smem, pcm, F, L, left, wts, n, kBL, kYBufs);
  const BLayout bl = blayout();
  constexpr int tsz = kBL * kYLd;
  auto dt = [&](int j) { return smem + bl.d + (j % kDBufs) * tsz; };
  auto mt = [&](int j) { return smem + bl.m + (j % kMBufs) * (kTile * kMLd); };
  auto g0t = [&](int j) { return smem + bl.g0 + (j & 1) * kMaxPieces * kSB; };
  float* const PC = smem + bl.pc;  // [tile parity][B, L, H][stream]
  float* const AP = smem + bl.ap;  // [j][c]: att^(2j+1+c)
  float* const gain_sh = smem + bl.gain;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int nl = fe.nl, ns = nl / 2;
  const int S = L / 2, s0 = fe.lane0 / 2;
  const rt::AgcParams p = rt::load_agc_params(params);
  const rt::BiquadCoef cf = rt::load_coef(coef);
  const float catt = rt::sub(1.0f, p.att);
  // 16-byte ring pieces: whole blocks of lanes on aligned rows
  const bool rvec = nl == kBL && (L * sizeof(R)) % 16 == 0 && ((U64)ring & 15) == 0;

  // carries: the IIR half on warp 0 (per lane); the window sum, the
  // untouched peak and the gain on warp 14 (per stream)
  float y1 = 0.f, y2 = 0.f;
  float rs = 0.f, pk = 0.f, g = 0.f, acc = 0.f;
  int left_in_chunk = 0;  // rel0c: frames left in the window sum's chunk
  if (warp == 0 && wl < nl) {
    y1 = bq_in[2 * L + fe.lane0 + wl];
    y2 = bq_in[3 * L + fe.lane0 + wl];
  } else if (warp == kWinWarp && wl < ns) {
    rs = agc_in[0 * S + s0 + wl];
    pk = agc_in[1 * S + s0 + wl];
  } else if (warp == kGainWarp && wl < ns) {
    g = agc_in[2 * S + s0 + wl];
  }
  if (tid < kBL) gain_sh[tid] = tid < nl ? gains[fe.lane0 + tid] : 0.f;
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
        // the window sums over d of tile it-3, in place: lane 2s the lo
        // sub-step's, lane 2s+1 the hi's
        const int j = it - 3;
        float* const lo = dt(j) + 2 * wl * kYLd;
        float* const hi = lo + kYLd;
        full_or_tail(tile_len(n, j), [&](auto tt) {
#pragma unroll 1
          for (int t0 = 0; t0 < kTile; t0 += 16) {
            if (!kWhole<decltype(tt)> && t0 >= tt) break;
            float a[16], b[16];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 va = reinterpret_cast<const float4*>(lo + t0)[q];
              const float4 vb = reinterpret_cast<const float4*>(hi + t0)[q];
              a[4 * q] = va.x, a[4 * q + 1] = va.y, a[4 * q + 2] = va.z, a[4 * q + 3] = va.w;
              b[4 * q] = vb.x, b[4 * q + 1] = vb.y, b[4 * q + 2] = vb.z, b[4 * q + 3] = vb.w;
            }
#pragma unroll
            for (int u = 0; u < 16; ++u) {
              if (kWhole<decltype(tt)> || t0 + u < tt) {
                if (!kTiled) {
                  a[u] = rt::add(rs, a[u]);
                  rs = rt::add(rs, b[u]);
                  b[u] = rs;
                } else {
                  if (left_in_chunk == 0) {
                    acc = 0.f;
                    left_in_chunk = chunk;
                  }
                  a[u] = rt::add(rt::add(acc, a[u]), rs);
                  acc = rt::add(acc, b[u]);
                  b[u] = rt::add(acc, rs);
                  if (--left_in_chunk == 0) rs = rt::add(rs, acc);
                }
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              reinterpret_cast<float4*>(lo + t0)[q] =
                  make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
              reinterpret_cast<float4*>(hi + t0)[q] =
                  make_float4(b[4 * q], b[4 * q + 1], b[4 * q + 2], b[4 * q + 3]);
            }
          }
        });
      }
    } else if (warp == kGainWarp) {
      if (wl < ns && fe.live(it - 6)) {
        // pass 3: g0 of each piece of tile it-6, g through the chunks that
        // end in it (their last sub-step's maps)
        const int j = it - 6;
        const Pieces pc(j, tile_len(n, j), chunk);
        float* const g0 = g0t(j);
        const float* const m = mt(j) + kSB + wl;  // channel 1's maps of stream wl
        for (int q = 0; q < pc.np; ++q) {
          g0[q * kSB + wl] = g;
          if (pc.ends_chunk(q)) {
            const float* const mq = m + (pc.end(q) - 1) * kMLd;
            g = rt::min_nan(mq[2 * kBL], rt::max_nan(mq[kBL], rt::add(rt::mul(att_r, g), mq[0])));
          }
        }
      }
    } else if (warp == kComposeWarp) {
      if (fe.live(it - 5)) {
        // pass 2: one (stream, piece) a thread, sub-steps in order; a
        // piece that continues a chunk starts from the (B, L, H) the
        // previous tile's last piece left
        const int j = it - 5;
        const Pieces pc(j, tile_len(n, j), chunk);
        for (int k = wl; k < pc.np * ns; k += 32) {
          const int q = k / ns, s = k - q * ns;
          const int a = pc.begin(q), b = pc.end(q);
          float B = 0.f, Lm = 0.f, Hm = p.max_gain;
          if (q == 0 && pc.off) {
            const float* c = PC + ((j - 1) & 1) * 3 * kSB;
            B = c[s];
            Lm = c[kSB + s];
            Hm = c[2 * kSB + s];
          }
          const float* const d = dt(j) + 2 * s * kYLd;
          float* const m = mt(j) + s;
          int t = a;
#pragma unroll 1
          for (; t + kCc <= b; t += kCc)
            compose_frames<kCc>(d + t, m + t * kMLd, p.att, catt, B, Lm, Hm);
#pragma unroll 1
          for (; t < b; ++t) compose_frames<1>(d + t, m + t * kMLd, p.att, catt, B, Lm, Hm);
          if (q == pc.np - 1 && !pc.ends_chunk(q)) {  // the chunk goes on
            float* c = PC + (j & 1) * 3 * kSB;
            c[s] = B;
            c[kSB + s] = Lm;
            c[2 * kSB + s] = Hm;
          }
        }
      }
    } else if (group == 2) {
      if (fe.live(it - kDepth)) {
        // pass 4 and the mix of tile it-7: this block's streams per
        // (channel, frame), in stream order, one frame of one channel an
        // item, neighbouring threads on neighbouring frames; each y times
        // its gain and its lane's
        const int j = it - kDepth, tt = tile_len(n, j);
        const Pieces pc(j, tt, chunk);
        const float* const y = fe.y_tile(j);
        const float* const g0 = g0t(j);
        const float* const m = mt(j);
#pragma unroll 1
        for (int e = gsub; e < 2 * kTile; e += kMix) {
          const int c = e / kTile, t = e % kTile;
          if (t >= tt) continue;
          // the frame's piece and its row in the chunk
          const int pos = pc.off + t, pi = pos / chunk;
          const float ap = AP[2 * (pos - pi * chunk) + c];
          const float4 gv = *reinterpret_cast<const float4*>(g0 + pi * kSB);
          const float gs[kSB] = {gv.x, gv.y, gv.z, gv.w};
          const float* const mc = m + t * kMLd + c * kSB;
          float acc = 0.f;
#pragma unroll
          for (int s = 0; s < kSB; ++s) {
            if (s < ns) {
              const float gain = rt::min_nan(
                  mc[2 * kBL + s], rt::max_nan(mc[kBL + s], rt::add(rt::mul(ap, gs[s]),
                                                                     mc[s])));
              const float v = rt::mul(rt::mul(y[(2 * s + c) * kYLd + t], gain), gain_sh[2 * s + c]);
              acc = s ? rt::add(acc, v) : v;  // the first term alone
            }
          }
          partial[((long long)blockIdx.x * 2 + c) * n + (long long)j * kTile + t] = acc;
        }
      }
    } else if (group == 0) {
      fe.fill<false>(it, gsub, nullptr, 0.f, cf);
      if (fe.live(it - 4)) {
        // tile it-4's desired gains over its window sums (d's tile) and y
        const int j = it - 4, l = gsub / (kTile / 4), t0 = gsub % (kTile / 4) * 4;
        if (l < nl && t0 < tile_len(n, j)) {
          const int o = l * kYLd + t0;
          float4* const b4 = reinterpret_cast<float4*>(dt(j) + o);
          const float4 rv = *b4;
          const float4 yv = *reinterpret_cast<const float4*>(fe.y_tile(j) + o);
          const float d0 = rt::desired_gain_folded(rv.x, yv.x, p);
          const float d1 = rt::desired_gain_folded(rv.y, yv.y, p);
          const float d2 = rt::desired_gain_folded(rv.z, yv.z, p);
          const float d3 = rt::desired_gain_folded(rv.w, yv.w, p);
          *b4 = make_float4(d0, d1, d2, d3);
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
          if (t < ttr) ring_frame<true>(yb, t, ring_at(jr, t), rvec, nl, cur[k], dt(jr));
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
    agc_out[1 * S + s0 + wl] = pk;  // the peak: memoryless at release 0
  } else if (warp == kGainWarp && wl < ns) {
    agc_out[2 * S + s0 + wl] = g;
  }
}

template <typename R, bool kTiled>
cudaError_t launch(const float* pcm, long long F, int L, const long long* left,
                   const float* wts, const float* gains, const float* coef,
                   const float* bq_in, float* bq_out, const float* agc_in,
                   float* agc_out, const float* params, void* ring,
                   int ring_row, int chunk, float* partial, int n, int nblk,
                   cudaStream_t s) {
  const size_t shmem = blayout().bytes;
  auto kernel = fused_agc_blocked_kernel<R, kTiled>;
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
  auto run = ring_bf16 ? (tiled ? launch<__nv_bfloat16, true> : launch<__nv_bfloat16, false>)
                       : (tiled ? launch<float, true> : launch<float, false>);
  const cudaError_t err =
      run(pcm, F, L, left, wts, gains, coef, bq_in, bq_out, agc_in, agc_out,
          params, ring, ring_row, chunk, partial, n, nblk, s);
  if (err != cudaSuccess) return (int)err;
  return (int)rt::front::sum_partials(partial, out, nblk, 2LL * n, s);
}

// K1's front end, shared by K1 (fused.cu), K2 and K2r (fused_agc.cu), K2b
// (fused_agc_blocked.cu) and K2g (fused_agc_group.cu): the block's shape
// and warp roles, the staged lerp rows, the PCM rows' copies, the fill (the
// lerp, the gain where the kernel applies it before the biquad, and the
// biquad's FIR half) and the IIR warp's register halves.
//
// For each output frame o of lane l:
//
//   left = (o / to)*fr + (fr*(o % to)) / to,  j = o % to
//   v    = w0[j]*x[left] + w1[j]*x[left+1]    (K1: times gain[l])
//   u    = (b0*v + b1*v1) + b2*v2             (v1, v2: the lane's last two v)
//   y    = (u - a1*y1) - a2*y2                (y1, y2: its last two y)
//
// u then y is the DF-I step of the reference (src/source/blt.rs:556-561)
// in its own operand order, split where the chain begins, so y and the
// carries (x1, x2, y1, y2) equal the plain sequential scan's bit for bit:
// the JAX package's "ufir" split (rodio_tpu/ops/fused.py:444-452). w0/w1
// are the two nonzero f32 taps of the JAX lerp operator G0/g1
// (conversions/resample.py:125-133), built once on the host. PCM rows past
// the buffer read as zero.
//
// The block: LB lanes of whole streams (kBL / C * C lanes; one stream of C
// lanes for C > 8), so 128 blocks for 1024 lanes, walking time in tiles of
// 128 frames, one __syncthreads a tile. Warp 0 runs the IIR half on SMSP 0
// (warps 4, 8 and 12 share it: idle in K1, the AGC's serial warps in K2's
// plans); the other 12 warps are elementwise, four on each of SMSPs 1-3.
// At iteration i:
//
//   fill warps (1-3, 5-7, 9, 10): tile i's lerp and FIR half u, a run of 4
//                           frames of one lane per thread (and the run's two
//                           frames before it), stored 16 bytes at a time
//   copy warps (11, 13):    the asynchronous copy (cp.async, 16 bytes at a
//                           time where the rows allow) of the range of PCM
//                           rows that tile i+2 reads into shared memory;
//                           the row indices and weights of tile i+3 into
//                           shared memory, and of tile i+4 into registers
//   mix warps (14, 15):     the kernel's own stages after the biquad (and
//                           the copy warps' between their copies' issue and
//                           the wait)
//   warp 0:                 the IIR half y of tile i-1, one thread per lane
//
// A tile's frames read a short run of consecutive PCM rows (the 44.1 ->
// 48 kHz ratio moves left by 0 or 1 a frame), so a tile's rows are copied
// once, as a range, two iterations ahead, and the fill reads its two taps
// from shared memory; a frame whose rows lie outside the staged range (a
// ratio that moves further, or rows out of order) loads them from global
// memory itself. Warp 0 keeps half a tile of its lane in registers at a
// time, loaded and stored 16 bytes at a time (its tile rows are
// lane-major), so its chain runs with no per-step test and no load inside.
// The x history (v1, v2) crosses tiles through a small array and comes from
// bq[0:2] at the block's start. Every op rounds alone.
#pragma once

#include <type_traits>

#include "lane_pipeline.cuh"  // rt::Steps
#include "precise_math.cuh"

namespace rt::front {

using U64 = unsigned long long;

constexpr int kBL = 8;              // lanes a block where C divides it
constexpr int kMaxLB = 32;          // lanes of one block at most
constexpr int kThreads = 16 * 32;   // warp 0 IIR; warps 4, 8, 12 off the elementwise SMSPs
// the elementwise warps' groups: threads of each
constexpr int kFill = 8 * 32, kCopy = 2 * 32, kMix = 2 * 32;
constexpr int kTile = 128;          // frames of a tile
constexpr int kHalf = 64;           // frames warp 0 holds in registers at once
constexpr int kRun = 4;             // frames of a fill thread's run
constexpr int kRuns = kTile / kRun;
constexpr int kRowBufs = 4;    // staged row indices: tiles i .. i+3
constexpr int kPcmBufs = 3;    // staged PCM rows: tiles i .. i+2
constexpr int kMaxRows = 192;  // PCM rows a tile stages (44.1 -> 48 kHz: <= 120)
constexpr int kStageRows = kTile / kCopy;  // row indices a copy thread stages
constexpr int kYLd = kTile + 4;  // a y tile's row stride: 16-byte rows, 4 banks apart

// a frame's left input row and lerp weights, staged in shared memory
struct Row {
  long long left;
  float2 w;
};

// lanes per block for C channels: whole streams, kBL lanes where C <= kBL
__host__ __device__ constexpr int block_lanes(int C) {
  return C <= kBL ? kBL / C * C : C;
}

// the elementwise group (0 fill, 1 copy, 2 mix) of a warp and its thread
// index in the group; warps 0, 4, 8 and 12 give -1. Each of SMSPs 1-3
// gets four: fill warps 1-3, 5-7, 9 and 10, copy warps 11 and 13, mix
// warps 14 and 15.
__device__ __forceinline__ int work_group(int warp, int wl, int& gsub) {
  const int slot = warp - warp / 4 - 1;
  if (warp % 4 == 0) return -1;
  if (slot < kFill / 32) {
    gsub = slot * 32 + wl;
    return 0;
  }
  if (slot < (kFill + kCopy) / 32) {
    gsub = slot * 32 + wl - kFill;
    return 1;
  }
  gsub = slot * 32 + wl - kFill - kCopy;
  return 2;
}

// Shared memory for LB lanes and nY y tiles: the staged rows, the y tiles
// of [LB][kYLd] (one row of frames per lane), kPcmBufs PCM row ranges of
// [kMaxRows][LB], and the x history and last values ([2][kMaxLB] each);
// `bytes` is 16-byte aligned, where a kernel's own buffers may follow.
struct Layout {
  size_t y, pcm, hist, last, bytes;  // float offsets; total bytes
};

__host__ __device__ inline Layout layout(int LB, int nY) {
  Layout s;
  s.y = sizeof(Row) * kRowBufs * kTile / sizeof(float);
  s.pcm = s.y + (size_t)nY * LB * kYLd;
  s.hist = s.pcm + (size_t)kPcmBufs * kMaxRows * LB;
  s.last = s.hist + 2 * 2 * kMaxLB;
  s.bytes = (s.last + 2 * kMaxLB) * sizeof(float);
  return s;
}

// cp.async of N bytes; src-size 0 fills them with zeros (a row past the PCM)
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ int tile_len(int n, int i) {
  return min(kTile, n - i * kTile);
}

// a whole tile's tt is rt::Steps<kTile>, a tail tile's an int
template <class TT>
constexpr bool kWhole = !std::is_same<TT, int>::value;

// run(tt) for a tile of tt frames: a whole tile runs with tt a
// compile-time kTile, so its copy of run has no per-step test
template <class Run>
__device__ __forceinline__ void full_or_tail(int tt, Run run) {
  if (tt == kTile)
    run(rt::Steps<kTile>{});
  else
    run(tt);
}

// The IIR half along a lane's row of a tile, y over u in place: kHalf
// frames at a time in registers, loaded and stored 16 bytes at a time, so
// that the chain's steps are all the loop issues.
template <class TT>
__device__ __forceinline__ void iir_row(float* b, TT tt, float a1, float a2,
                                        float& y1, float& y2) {
#pragma unroll 1
  for (int h = 0; h < kTile; h += kHalf) {
    float4* b4 = reinterpret_cast<float4*>(b + h);
    float v[kHalf];
#pragma unroll
    for (int q = 0; q < kHalf / 4; ++q) {
      const float4 f = b4[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      if (kWhole<TT> || h + u < tt) {
        const float yt = rt::sub(rt::sub(v[u], rt::mul(a1, y1)), rt::mul(a2, y2));
        y2 = y1;
        y1 = yt;
        v[u] = yt;
      }
    }
#pragma unroll
    for (int q = 0; q < kHalf / 4; ++q)
      b4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// One block's front end: its geometry, its shared buffers and the stages
// of the fill, copy and IIR warps.
struct Front {
  const float* __restrict__ pcm;
  long long F;
  int L, n, LB, nY, lane0, nl, n_tiles;
  const long long* __restrict__ left;
  const float2* __restrict__ wts;
  Row* rows;
  float *Y, *PR, *hist, *last;
  bool vec;  // 16-byte PCM copies: the block's rows are 16-byte aligned

  __device__ Front(float* smem, const float* pcm_, long long F_, int L_,
                   const long long* left_, const float2* wts_, int n_, int LB_,
                   int nY_)
      : pcm(pcm_), F(F_), L(L_), n(n_), LB(LB_), nY(nY_), left(left_),
        wts(wts_) {
    const Layout lay = layout(LB, nY);
    rows = reinterpret_cast<Row*>(smem);
    Y = smem + lay.y;
    PR = smem + lay.pcm;
    hist = smem + lay.hist;  // [buffer][x2, x1][lane]
    last = smem + lay.last;  // [x1, x2][lane] of the latest tile
    lane0 = blockIdx.x * LB;
    nl = min(LB, L - lane0);  // whole streams: C divides L and LB
    n_tiles = (n + kTile - 1) / kTile;
    vec = nl == LB && LB % 4 == 0 && L % 4 == 0 && ((U64)pcm & 15) == 0;
  }

  __device__ float* y_tile(int j) const { return Y + (j % nY) * LB * kYLd; }
  __device__ Row* rows_of(int j) const { return rows + (j % kRowBufs) * kTile; }
  __device__ float* pcm_of(int j) const { return PR + (j % kPcmBufs) * kMaxRows * LB; }
  __device__ bool live(int j) const { return j >= 0 && j < n_tiles; }
  __device__ void stage_rows(int i, int t, Row& r) const {  // tile i's frame t
    const int tc = i * kTile + min(t, tile_len(n, i) - 1);
    r.left = left[tc];
    r.w = wts[tc];
  }
  // the first PCM row tile i stages and how many (rows left[0] .. left[tt
  // - 1] + 1, at most kMaxRows; none if they run backwards)
  __device__ int row_range(int i, long long& r0) const {
    const Row* r = rows_of(i);
    r0 = r[0].left;
    const long long span = r[tile_len(n, i) - 1].left + 2 - r0;
    return (int)max(0LL, min(span, (long long)kMaxRows));
  }

  // the copies of tile i's PCM row range into shared memory, as copy
  // thread gsub: 16 bytes at a time where the block's rows allow
  __device__ void copy_tile(int i, int gsub) const {
    long long r0;
    const int span = row_range(i, r0);
    float* dst = pcm_of(i);
    if (vec) {
      const int per = LB / 4;
      for (int e = gsub; e < span * per; e += kCopy) {
        const int k = e / per, q = e - k * per;
        const U64 r = (U64)(r0 + k);
        cp_async<16>(dst + k * LB + 4 * q,
                     pcm + min(r, (U64)F - 1) * L + lane0 + 4 * q, r < (U64)F);
      }
    } else {
      for (int e = gsub; e < span * LB; e += kCopy) {
        const int k = e / LB, l = e - k * LB;
        const U64 r = (U64)(r0 + k);
        cp_async<4>(dst + e, pcm + min(r, (U64)F - 1) * L + lane0 + min(l, nl - 1),
                    r < (U64)F && l < nl);
      }
    }
  }

  // Before the tile loop, every thread: tile 0's x history from bq
  // (x2 = bq[1], x1 = bq[0]) and the row indices of tiles 0-2; a copy
  // thread's indices of tile 3 into `next`; then the PCM rows of tiles 0
  // and 1. Ends on a barrier.
  __device__ void start(const float* __restrict__ bq_in, int group, int gsub,
                        Row (&next)[kStageRows]) const {
    const int tid = threadIdx.x;
    if (tid < nl) {  // tile 0's history: x2 (frame -2), x1 (frame -1)
      hist[tid] = bq_in[1 * L + lane0 + tid];
      hist[kMaxLB + tid] = bq_in[0 * L + lane0 + tid];
    }
    for (int e = tid; e < 3 * kTile; e += kThreads) {
      const int i = e / kTile;
      if (live(i)) {
        Row r;
        stage_rows(i, e % kTile, r);
        rows_of(i)[e % kTile] = r;
      }
    }
    if (group == 1 && live(3))
      for (int k = 0; k < kStageRows; ++k) stage_rows(3, gsub + k * kCopy, next[k]);
    __syncthreads();
    if (group == 1) {
      if (live(0)) copy_tile(0, gsub);
      cp_async_commit();
      if (live(1)) copy_tile(1, gsub);
      cp_async_commit();
      cp_async_wait_prior();
    }
    __syncthreads();
  }

  // a copy thread's iteration it: the row indices of tile it+3 (loaded an
  // iteration ago) and of tile it+4 (into registers), and the PCM rows of
  // tile it+2; then mid(), a kernel's own work while the copies fly; then
  // waits for tile it+1's
  template <class Mid>
  __device__ void copy_step(int it, int gsub, Row (&next)[kStageRows],
                            Mid mid) const {
    if (live(it + 3))
      for (int k = 0; k < kStageRows; ++k) rows_of(it + 3)[gsub + k * kCopy] = next[k];
    if (live(it + 4))
      for (int k = 0; k < kStageRows; ++k) stage_rows(it + 4, gsub + k * kCopy, next[k]);
    if (live(it + 2)) copy_tile(it + 2, gsub);
    cp_async_commit();
    mid();
    cp_async_wait_prior();  // tile it+1's copies have landed
  }

  // a fill thread's share of tile it: the lerp (kGain: times the lane's
  // gain; gain0 the gain of its first run's lane) and the FIR half u, a run
  // of kRun frames of one lane at a time, into y_tile(it); the next tile's
  // history and the tile's last two v
  template <bool kGain>
  __device__ void fill(int it, int gsub, const float* __restrict__ gains,
                       float gain0, const rt::BiquadCoef& cf) const {
    if (!live(it)) return;
    const int tt = tile_len(n, it);
    const Row* r = rows_of(it);
    long long r0;
    const int span = row_range(it, r0);
    const float* xs = pcm_of(it);
    const float* hin = hist + (it & 1) * 2 * kMaxLB;
    float* hout = hist + ((it + 1) & 1) * 2 * kMaxLB;
    float* y = y_tile(it);
    for (int pr = gsub; pr < kRuns * LB; pr += kFill) {
      const int l = pr % LB, t0 = pr / LB * kRun;
      if (l >= nl) continue;
      const float g = !kGain ? 1.f : pr == gsub ? gain0 : gains[lane0 + l];
      // frames t0 - 2 .. t0 + kRun - 1: first every row index, then every
      // tap (all from the staged rows unless one lies outside), then the
      // lerps; a frame before the tile takes the history
      Row rw[kRun + 2];
#pragma unroll
      for (int k = 0; k < kRun + 2; ++k) rw[k] = r[min(max(t0 - 2 + k, 0), tt - 1)];
      int kr[kRun + 2];
      bool staged = true;
#pragma unroll
      for (int k = 0; k < kRun + 2; ++k) {
        const long long d = rw[k].left - r0;
        staged = staged && d >= 0 && d + 1 < span;
        kr[k] = (int)d;
      }
      float xl[kRun + 2], xr[kRun + 2];
      if (staged) {
#pragma unroll
        for (int k = 0; k < kRun + 2; ++k) {
          xl[k] = xs[kr[k] * LB + l];
          xr[k] = xs[(kr[k] + 1) * LB + l];
        }
      } else {  // a row outside the staged range: from global memory
#pragma unroll
        for (int k = 0; k < kRun + 2; ++k) {
          const U64 r1 = (U64)rw[k].left, lane = lane0 + l;
          xl[k] = r1 < (U64)F ? pcm[r1 * L + lane] : 0.f;
          xr[k] = r1 + 1 < (U64)F ? pcm[(r1 + 1) * L + lane] : 0.f;
        }
      }
      float v[kRun + 2];
#pragma unroll
      for (int k = 0; k < kRun + 2; ++k) {
        const float lerp =
            rt::add(rt::mul(xl[k], rw[k].w.x), rt::mul(xr[k], rw[k].w.y));
        const float vk = kGain ? rt::mul(lerp, g) : lerp;
        v[k] = k < 2 && t0 == 0 ? hin[(k & 1) * kMaxLB + l] : vk;
      }
      float u[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        u[k] = rt::add(rt::add(rt::mul(cf.b0, v[k + 2]), rt::mul(cf.b1, v[k + 1])),
                       rt::mul(cf.b2, v[k]));
      *reinterpret_cast<float4*>(y + l * kYLd + t0) = make_float4(u[0], u[1], u[2], u[3]);
      if (t0 + kRun == kTile) {  // the next tile's history
        hout[l] = v[kRun];
        hout[kMaxLB + l] = v[kRun + 1];
      }
#pragma unroll
      for (int k = 0; k < kRun + 2; ++k) {  // the tile's last two v
        const int t = t0 - 2 + k;
        if (t >= t0 || t0 == 0) {
          if (t == tt - 1) last[l] = v[k];
          if (t == tt - 2) last[kMaxLB + l] = v[k];
        }
      }
    }
  }

  // warp 0's share of iteration it: the IIR half of tile it-1, its lane wl
  __device__ void iir(int it, int wl, const rt::BiquadCoef& cf, float& y1,
                      float& y2) const {
    const int j = it - 1;
    if (live(j) && wl < nl) {
      float* b = y_tile(j) + wl * kYLd;
      full_or_tail(tile_len(n, j), [&](auto tt) { iir_row(b, tt, cf.a1, cf.a2, y1, y2); });
    }
  }

  // after the tile loop, warp 0: the biquad carries (x1, x2, y1, y2)
  __device__ void finish(float* __restrict__ bq_out, int wl, float y1,
                         float y2) const {
    if (wl < nl) {
      bq_out[0 * L + lane0 + wl] = last[wl];
      bq_out[1 * L + lane0 + wl] = last[kMaxLB + wl];
      bq_out[2 * L + lane0 + wl] = y1;
      bq_out[3 * L + lane0 + wl] = y2;
    }
  }
};

// out[i] = sum over blocks b (in order) of partial[b * cn + i], in f64,
// rounded to f32 once, on stream s (defined in fused.cu)
cudaError_t sum_partials(const float* partial, float* out, int nblk,
                         long long cn, cudaStream_t s);

}  // namespace rt::front

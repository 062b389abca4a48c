// K2g: K2 with its group branch, the group-rate AGC (agc_group = AG).
//
// Replaces the group branch of rodio_tpu/ops/fused.py
// fused_resample_biquad_agc_mix / _fused_agc_kernel (:652-764):
// FusedWidePipeline(with_agc=True, agc_group=AG), the JAX package's opt-in
// that changes results (its AgcGroup contract, rodio_tpu/effects/agc.py).
// Stereo streams, lane l = 2s + c. The lerp and the biquad are K2's
// (fused_agc.cu); the AGC then advances once per group of AG frames, the
// groups placed at multiples of AG from the stream's first frame, in the
// TPU kernel's order:
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
// each; as in K2 each element is read, then overwritten, by one thread.
//
// What bounds it on the H100: the biquad, as in K1: ~3 dependent rounded
// ops per frame on one thread per lane. The rs/pk and smoother chains step
// once per group, AG times less often than K2's per sample. AG is a power
// of two up to the RMS lag (it divides 4096), and blocks are whole groups.
//
// Design: K2's seven-stage tile pipeline (fused_agc_common.cuh). At
// iteration i the elementwise warps fill tile i (the lerp), reduce the
// groups of tile i-2 (one (group, stream) per thread: the sums, the peak,
// the ring read and write, d), take the desired gains of tile i-4 and mix
// tile i-6 (one (channel, frame) per thread, the staircase gain applied
// there); warp 0 runs the biquad of tile i-1, warp 1 the rs/pk chains of
// tile i-3 and warp 2 the smoother of tile i-5, one thread per stream, on
// small per-group tiles. A group longer than a tile (AG > 64) spans
// E = AG/64 - 1 more tiles: its thread carries the partial sums and the
// peak from tile to tile, the group's values land in its last tile's
// per-group tile, and the mix waits E more iterations for the gain, so
// E more y tiles and per-group tiles are kept in shared memory. The mix
// partials are summed in block order by a second kernel, as in K2. Every
// op rounds alone.
#include "fused_agc_common.cuh"

namespace {

using namespace rt::fused_agc;

constexpr int kSB = kBL / 2;      // streams per block
constexpr int kGMax = kTile / 2;  // groups per tile at AG = 2
// buffers, and iterations from a tile's fill to its mix, at AG <= 64; a
// longer group adds E to each but the GM tiles
constexpr int kYBufs = 7, kGDBufs = 5, kGMBufs = 3;
constexpr int kDepth = 6;
constexpr int kPer = kTile * kBL / kNWork;  // lerp elements per thread
static_assert(kPer * kNWork == kTile * kBL, "whole tiles per thread");
static_assert(kGMax * kSB == kNWork, "one (group, stream) per thread");
static_assert(2 * kTile == kNWork, "one mixed (channel, frame) per thread");

// a tile's per-group values: [group of the tile][stream of the block]
typedef float GTile[kGMax][kSB + 1];

static_assert(sizeof(Tile) % 16 == 0 && sizeof(GTile) % 16 == 0,
              "every buffer 16-byte aligned");

// tiles a group spans beyond its first: 0 for AG <= 64
__host__ __device__ constexpr int extra_tiles(int ag) {
  return ag > kTile ? ag / kTile - 1 : 0;
}

// bytes of the y tiles and per-group tiles, then the staged rows
__host__ __device__ constexpr size_t tiles_bytes(int ag) {
  return sizeof(Tile) * (kYBufs + extra_tiles(ag)) +
         sizeof(GTile) * (kGDBufs + extra_tiles(ag) + kGMBufs);
}
constexpr size_t shmem_bytes(int ag) {
  return tiles_bytes(ag) + sizeof(Row) * 2 * kTile;
}
static_assert(shmem_bytes(kRing) <= 227 * 1024, "the longest group fits");

// kLong: AG > 64 (E > 0); otherwise E is the constant 0, so that the
// buffer indices of the common case stay constant divisions
template <typename R, bool kLong>
__global__ void __launch_bounds__(kAgcThreads, 1)
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
  extern __shared__ float smem[];
  __shared__ float gain_sh[kBL];
  const int E = kLong ? extra_tiles(ag) : 0, tpg = E + 1;  // tiles per group
  const int nY = kYBufs + E, nGD = kGDBufs + E;
  Tile* Y = reinterpret_cast<Tile*>(smem);
  GTile* GD = reinterpret_cast<GTile*>(Y + nY);  // d, rs, des, g
  GTile* GM = GD + nGD;                          // ym, pk
  Row* rows =
      reinterpret_cast<Row*>(reinterpret_cast<char*>(smem) + tiles_bytes(ag));
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int lane0 = blockIdx.x * kBL;
  const int nl = min(kBL, L - lane0);  // even: L is, and lane0 too
  const int ns = nl / 2;
  const int S = L / 2, s0 = lane0 / 2;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int gpt = max(1, kTile / ag);      // groups per whole tile
  const int ring_mask = kRing / ag - 1;    // ring rows: a power of two
  const rt::AgcParams p = rt::load_agc_params(params);
  const rt::BiquadCoef cf = rt::load_coef(coef);
  const float attG = rt::ipow(p.att, 2 * ag);
  const float relG = rt::ipow(p.rel, 2 * ag);
  const float crelG = rt::sub(1.0f, relG);

  // carries: biquad on warp 0 (per lane), rs/pk on warp 1 and the gain on
  // warp 2 (per stream)
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

  auto stage_rows = [&](int i, int sub, Row& r) {  // tile i's frame `sub`
    const int tc = i * kTile + min(sub, rt::tile_len(n, i) - 1);
    r.left = left[tc];
    r.w = wts[tc];
  };
  // ring element of stream s for the block's group kb
  auto ring_at = [&](int kb, int s) {
    return (long long)((ring_row + kb) & ring_mask) * S + s0 + s;
  };
  // the groups that end in tile i; the group items (whole groups, or a
  // part of one) in it; the block's index of its first group
  auto groups = [&](int i) {
    return E ? (int)((i + 1) % tpg == 0) : rt::tile_len(n, i) / ag;
  };
  auto items = [&](int i) { return E ? 1 : groups(i); };
  auto first_group = [&](int i) { return E ? i / tpg : i * gpt; };
  auto live = [&](int j) { return j >= 0 && j < n_tiles; };

  if (tid < kTile) {
    Row r;
    stage_rows(0, tid, r);
    rows[tid] = r;
  }
  __syncthreads();
  // a group's partial sums and peak per channel, carried across its tiles
  float cur[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles + kDepth + E; ++it) {
    if (warp == 0) {
      const int j = it - 1;
      if (live(j) && wl < nl) {
        Tile& b = Y[j % nY];
        full_or_tail(rt::tile_len(n, j), [&](auto tt) {
          biquad_column(b, wl, tt, cf, x1, x2, y1, y2);
        });
      }
    } else if (warp == 1) {
      const int j = it - 3;
      if (live(j) && wl < ns) {
        // in: d (GD) and ym (GM); out: rs (GD) and pk (GM)
        GTile& d = GD[j % nGD];
        GTile& m = GM[j % kGMBufs];
        const int G = groups(j);
        for (int k = 0; k < G; ++k) {
          rs = rt::add(rs, d[k][wl]);
          const float ym = m[k][wl];
          pk = rt::max_nan(ym, rt::add(rt::mul(relG, pk), rt::mul(crelG, ym)));
          d[k][wl] = rs;
          m[k][wl] = pk;
        }
      }
    } else if (warp == 2) {
      const int j = it - 5;
      if (live(j) && wl < ns) {
        // in: the desired gains (GD); out: the group gains (GD)
        GTile& d = GD[j % nGD];
        const int G = groups(j);
        for (int k = 0; k < G; ++k) {
          g = rt::smooth_gain(g, d[k][wl], attG, relG, p.max_gain);
          d[k][wl] = g;
        }
      }
    } else if (work_slot(warp) >= 0) {
      const int sub = work_slot(warp) * 32 + wl;
      const int gk = sub / kSB, gs = sub % kSB;  // this thread's group item
      const bool fill = live(it), prep = live(it - 2);
      const bool stage = live(it + 1) && sub < kTile;
      const int gp = prep ? items(it - 2) : 1;
      const bool item = prep && gk < gp && gs < ns;
      // 1. every global load of the iteration, from clamped, always-valid
      //    addresses (unsigned, so that a negative row clamps too)
      const Row* rf = rows + (it & 1) * kTile;  // tile it's staged rows
      const int ttf = fill ? rt::tile_len(n, it) : 1;
      float xl[kPer], xr[kPer];
      R old;
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
      if (prep)
        old = ring[ring_at(first_group(it - 2) + min(gk, gp - 1),
                           min(gs, ns - 1))];
      if (stage) stage_rows(it + 1, sub, next);
      // 2. shared-memory work while the loads are in flight: the desired
      //    gains of tile it-4, the mix of tile it-6-E
      if (live(it - 4) && gk < groups(it - 4) && gs < ns) {
        float& v = GD[(it - 4) % nGD][gk][gs];
        v = rt::desired_gain(v, GM[(it - 4) % kGMBufs][gk][gs], p);
      }
      if (live(it - kDepth - E)) {
        const int j = it - kDepth - E, c = sub / kTile, t = sub % kTile;
        if (t < rt::tile_len(n, j)) {
          const Tile& yb = Y[j % nY];
          // the gains of frame t's group, in the tile where it ends
          const float* gg = E ? GD[(j - j % tpg + E) % nGD][0]
                              : GD[j % nGD][t / ag];
          float acc = rt::mul(rt::mul(yb[t][c], gg[0]), gain_sh[c]);
          for (int s = 1; s < ns; ++s)
            acc = rt::add(acc, rt::mul(rt::mul(yb[t][2 * s + c], gg[s]),
                                       gain_sh[2 * s + c]));
          partial[((long long)blockIdx.x * 2 + c) * n + j * kTile + t] = acc;
        }
      }
      // 3. the loaded values used
      if (fill) {
        Tile& b = Y[it % nY];
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
      if (item) {
        // group item gk of tile j, stream gs: both channels in frame order,
        // from the group's first frame (its first tile) on
        const int j = it - 2;
        const Tile& yb = Y[j % nY];
        const int t0 = E ? 0 : gk * ag, len = E ? kTile : ag, l = 2 * gs;
        const int u0 = j % tpg == 0 ? 1 : 0;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (u0) {
            const float v0 = yb[t0][l + c];
            cur[c] = rt::mul(v0, v0);
            mx[c] = fabsf(v0);
          }
          for (int u = u0; u < len; ++u) {
            const float v = yb[t0 + u][l + c];
            cur[c] = rt::add(cur[c], rt::mul(v, v));
            mx[c] = rt::max_nan(mx[c], fabsf(v));
          }
        }
        if (groups(j)) {  // the group ends in tile j
          const R q = ring_round<R>(rt::add(cur[0], cur[1]));
          ring[ring_at(first_group(j) + gk, gs)] = q;
          GD[j % nGD][gk][gs] = rt::sub(ring_f32(q), ring_f32(old));
          GM[j % kGMBufs][gk][gs] = rt::max_nan(mx[0], mx[1]);
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

template <typename R>
cudaError_t launch(const float* pcm, long long F, int L, const long long* left,
                   const float* wts, const float* gains, const float* coef,
                   const float* bq_in, float* bq_out, const float* agc_in,
                   float* agc_out, const float* params, void* ring,
                   int ring_row, int ag, float* partial, int n, int nblk,
                   cudaStream_t s) {
  const size_t shmem = shmem_bytes(ag);
  auto kernel = ag > kTile ? fused_agc_group_kernel<R, true>
                           : fused_agc_group_kernel<R, false>;
  if (shmem > 48 * 1024) {  // more than the default needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<nblk, kAgcThreads, shmem, s>>>(
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
  return (int)sum_partials(partial, out, nblk, n, s);
}

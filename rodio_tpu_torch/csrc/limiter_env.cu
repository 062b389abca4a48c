// K5: the limiter's two envelope recurrences per lane (limiter_env), and
// the Limit node's whole per-stream limiter around them (limiter_stream).
//
// Replaces rodio_tpu/ops/pallas_scan.py limiter_env_pallas /
// _limiter_env_kernel (src/source/limit.rs:909-913). Per step, in the TPU
// kernel's order, from the soft-knee gain db of each sample:
//
//   integ = max(db, rel*integ + (1-rel)*db)
//   peak  = att*peak + (1-att)*integ            -> limiter_env's output
//
// The carries out are those of the last step, T-1: the port has no padded
// tail, so they are what the TPU kernel's saved pair holds.
//
// limiter_stream also takes in what XLA fuses around that pallas_call on
// the TPU (rodio_tpu/effects/limit.py:166-212), which the port has no XLA
// for: from x, the soft-knee gain computer (ops/limiter_block.py:44-52's
// op order, precise_math.cuh's log2_precise) before the envelopes, and
// after them the coupling within each group of cg channels (lanes) and the
// gain. At frame t channel c takes the max of the fresh peaks of channels
// <= c and the peaks at t-1 of channels > c (the reference's interleaved
// order: effects/limit.py:137-152), then y = x * exp2_precise((-max_peak)
// * (0.05 log2 10)) in core/math.py's order. So one pass reads x and writes
// y, where the node ran a dozen elementwise torch passes on each side of
// the envelopes.
//
// What bounds it on the H100: the serial chain, one thread per lane. The
// products (1-rel)*db do not depend on the carries, so they leave the
// chain; what stays is mul, add, max on the integrator (the peak follows
// it, 2 ops behind), 3 dependent ops a step (about 2 ns each,
// benches/op_latency.py). At the per-stream chain's shape ([1024, 12800],
// 512 stereo streams) that floor is ~0.08 ms, against 31 us for the 105 MB
// the kernel must read and write.
//
// Design (chain_pipeline.cuh, as K6 and K7): a block owns whole groups of
// channels, kLB = 8 lanes where cg divides it (cg <= 8: floor(8 / cg) * cg
// lanes; one group of cg <= 32 lanes otherwise), so 128 blocks for 1024
// lanes, one wave on 132 SMs, and walks time in tiles of 128 steps, one
// __syncthreads a tile. At iteration i:
//
//   warp 0 (copy):       tile i+1's rows of the input into shared memory
//                        with cp.async, then waits for tile i's
//   elementwise warps    limiter_stream: the gain computer of tile i-1 (db
//   (2-4, 6-8, 10, 11):  over x, into a second ring); the coupling and the
//                        gain of tile i-3, y stored coalesced, 16 bytes at
//                        a time where the rows allow; limiter_env: tile
//                        i-2's peaks stored from their rows
//   warp 1:              the envelopes of tile i-2 (limiter_env: i-1), one
//                        thread per lane, 64 steps at a time in registers,
//                        the peaks over db in place
//
// Warp 1 has SMSP 1 (warp % 4) to itself (warps 5 and 9 idle). A group's
// coupling at a tile's first frame reads the previous tile's last peaks,
// still in the ring (five tiles), or the carry-in at tile 0; 42 KB of
// shared memory at 8 lanes. The build flags keep every op rounded alone
// (-fmad=false) and every op is written with an explicit rounding, in the
// plain version's order, so the kernel equals its plain PyTorch version
// bit for bit: the peaks, the carries and y.
//
// The f64 instances (set_float64: the JAX kernel runs in its input's
// dtype, pallas_scan.py:394) are the same kernel on C = double: the rows,
// the chain, the coefficients (att, rel and the unrounded 1 - att, 1 - rel)
// and every op f64, rounded alone; limiter_stream's gain computer and gain
// take precise_math.cuh's f64 soft knee and exp2, as K3's f64 instance
// does. The rings are sized in bytes: 83 KB of dynamic shared memory at 8
// lanes for limiter_stream, so a group of up to kMaxLB64 = 16 channels
// runs in one block (rt_limiter_stream_f64_max_group); the chain thread
// holds 32 steps at a time in registers.
#include "agc_math.cuh"
#include "chain_pipeline.cuh"

namespace {

using namespace rt::chain;

constexpr int kLB = 8;              // lanes a block where cg divides it
constexpr int kMaxLB = 32;          // lanes of one block at most (one chain warp)
constexpr int kMaxLB64 = 16;        // ... of the f64 instance's limiter_stream
                                    // (two rings of 16 f64 lanes: 166 KB)
constexpr int kThreads5 = 12 * 32;  // warps 5 and 9 idle
constexpr int kNWork = 8 * 32;      // elementwise threads
constexpr int kRing = 5;            // tiles staged: i+1 .. i-3
constexpr int kQuads = kTile / 4;   // 4-step pieces of a lane's tile

// lanes per block for groups of cg channels: whole groups
__host__ __device__ constexpr int block_lanes(int cg) {
  return cg <= kLB ? kLB / cg * cg : cg;
}

// the elementwise slot of a warp, or -1: warps 2-4, 6-8, 10 and 11 (SMSPs
// 2, 3, 0, 2, 3, 0, 2, 3), none beside the chain warp on SMSP 1
__device__ __forceinline__ int work_slot(int warp) {
  return warp == 0 || warp % 4 == 1 || warp > 11 ? -1 : warp - 2 - (warp - 2) / 4;
}

template <class C>
struct LimParams {
  C att, rel, catt, crel;
  C threshold, knee_width, inv_knee_8, log2_to_db, db_to_log2;
};

// soft-knee gain computer (precise_math.cuh, K3's)
template <class C>
__device__ __forceinline__ C gain_db(C x, const LimParams<C>& p) {
  return rt::soft_knee_db(x, p.threshold, p.knee_width, p.inv_knee_8,
                          p.log2_to_db);
}

// the chain's step: db in, the peak out in its place
template <class C>
struct Env {
  C integ, peak, att, rel, catt, crel;
  template <int H>
  __device__ __forceinline__ void operator()(C (&v)[1][H], int u) {
    const C d = v[0][u];
    integ = rt::max_nan(d, rt::add(rt::mul(rel, integ), rt::mul(crel, d)));
    peak = rt::add(rt::mul(att, peak), rt::mul(catt, integ));
    v[0][u] = peak;
  }
};

// four consecutive steps of a staged row (16-byte aligned), as the chain's
// type's vector: float4, or Double4 (two 16-byte accesses)
template <class C>
using Vec4 = std::conditional_t<std::is_same<C, double>::value, Double4, float4>;

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(rt::max_nan(a.x, b.x), rt::max_nan(a.y, b.y),
                     rt::max_nan(a.z, b.z), rt::max_nan(a.w, b.w));
}
__device__ __forceinline__ Double4 max4(Double4 a, Double4 b) {
  return Double4{rt::max_nan(a.x, b.x), rt::max_nan(a.y, b.y),
                 rt::max_nan(a.z, b.z), rt::max_nan(a.w, b.w)};
}

// kStream: limiter_stream (x in, y out), else limiter_env (db in, peaks
// out); LB lanes a block, groups of cg; C the sample type (f32 or f64)
template <bool kStream, class C>
__global__ void __launch_bounds__(kThreads5, 1)
limiter_kernel(const C* __restrict__ in, const C* __restrict__ integ0,
               const C* __restrict__ peak0, C* __restrict__ out,
               C* __restrict__ carry_out, int L, long long T, int cg,
               int LB, LimParams<C> p, int vec) {
  using V4 = Vec4<C>;
  constexpr int LD = kLdOf<C>;
  constexpr int H = std::is_same<C, double>::value ? kHalf / 2 : kHalf;
  // X: the input's tiles; D (limiter_stream): db, then the peaks; the
  // limiter_env's peaks over its input in X
  extern __shared__ float4 smem4[];
  C* const X = reinterpret_cast<C*>(smem4);
  C* const D = kStream ? X + kRing * LB * LD : X;
  // iterations from a tile's landing to its chain, and to its output
  constexpr int kChain = kStream ? 2 : 1, kOut = kChain + 1;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const long long lane0 = (long long)blockIdx.x * LB;
  const int nl = (int)min((long long)LB, L - lane0);  // whole groups
  const int n_tiles = (int)((T + kTile - 1) / kTile);
  auto live = [&](int j) { return j >= 0 && j < n_tiles; };
  auto xrow = [&](int j, int l) { return X + ((j % kRing) * LB + l) * LD; };
  auto drow = [&](int j, int l) { return D + ((j % kRing) * LB + l) * LD; };

  Env<C> env{C(0), C(0), p.att, p.rel, p.catt, p.crel};
  if (warp == 1 && wl < nl) {
    env.integ = integ0[lane0 + wl];
    env.peak = peak0[lane0 + wl];
  }
  const int slot = work_slot(warp);
  if (warp == 0) {
    copy_lanes(xrow(0, 0), in, lane0, LB, nl, T, 0, tile_len(T, 0), vec, wl, 32);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles + kOut; ++it) {
    if (warp == 0) {
      if (live(it + 1))
        copy_lanes(xrow(it + 1, 0), in, lane0, LB, nl, T, (long long)(it + 1) * kTile,
                   tile_len(T, it + 1), vec, wl, 32);
      cp_async_commit();
      cp_async_wait<1>();  // tile it has landed
    } else if (warp == 1) {
      const int j = it - kChain;
      if (live(j) && wl < nl) {
        C* const rows[1] = {drow(j, wl)};
        full_or_tail(tile_len(T, j),
                     [&](auto tt) { chain_row<1, 1, H, C>(rows, tt, env); });
      }
    } else if (slot >= 0) {
      const int sub = slot * 32 + wl;
      if (!kStream) {
        const int j = it - kOut;
        if (live(j))
          store_lanes<C, C>(out, xrow(j, 0), lane0, LB, nl, T, (long long)j * kTile,
                            tile_len(T, j), vec, sub, kNWork);
      } else {
        if (live(it - 1)) {
          // the gain computer over 4 steps of a lane, the whole row (a tail
          // tile's steps past its end are never read)
          const int j = it - 1;
          for (int q = sub; q < nl * kQuads; q += kNWork) {
            const int l = q / kQuads, t0 = q % kQuads * 4;
            const V4 x = *reinterpret_cast<const V4*>(xrow(j, l) + t0);
            *reinterpret_cast<V4*>(drow(j, l) + t0) = make4(
                gain_db(x.x, p), gain_db(x.y, p), gain_db(x.z, p), gain_db(x.w, p));
          }
        }
        if (live(it - kOut)) {
          // the coupling and the gain over 4 steps of a lane
          const int j = it - kOut, tt = tile_len(T, j);
          const long long tg = (long long)j * kTile;
          for (int q = sub; q < nl * kQuads; q += kNWork) {
            const int l = q / kQuads, t0 = q % kQuads * 4;
            if (t0 >= tt) continue;
            const int c = l % cg, g0 = l - c;
            // fresh peaks of the group's channels <= c, then the previous
            // step's of those above it
            V4 m = *reinterpret_cast<const V4*>(drow(j, g0) + t0);
            for (int k = 1; k <= c; ++k)
              m = max4(m, *reinterpret_cast<const V4*>(drow(j, g0 + k) + t0));
            for (int k = c + 1; k < cg; ++k) {
              const C* r = drow(j, g0 + k);
              const V4 v = *reinterpret_cast<const V4*>(r + t0);
              const C before = t0 ? r[t0 - 1]
                                  : j ? drow(j - 1, g0 + k)[kTile - 1]
                                      : peak0[lane0 + g0 + k];
              m = max4(m, make4(before, v.x, v.y, v.z));
            }
            const V4 x = *reinterpret_cast<const V4*>(xrow(j, l) + t0);
            const C y[4] = {
                rt::mul(x.x, rt::exp2_precise(rt::mul(-m.x, p.db_to_log2))),
                rt::mul(x.y, rt::exp2_precise(rt::mul(-m.y, p.db_to_log2))),
                rt::mul(x.z, rt::exp2_precise(rt::mul(-m.z, p.db_to_log2))),
                rt::mul(x.w, rt::exp2_precise(rt::mul(-m.w, p.db_to_log2)))};
            C* o = out + (lane0 + l) * T + tg + t0;
            if (vec && t0 + 4 <= tt) {
              *reinterpret_cast<V4*>(o) = make4(y[0], y[1], y[2], y[3]);
            } else {
              for (int k = 0; k < 4 && t0 + k < tt; ++k) o[k] = y[k];
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the carries of the last step
  if (warp == 1 && wl < nl) {
    carry_out[lane0 + wl] = env.integ;
    carry_out[L + lane0 + wl] = env.peak;
  }
}

// the most channels a group of limiter_stream may have, by the sample type
template <class C>
constexpr int max_group() {
  return std::is_same<C, double>::value ? kMaxLB64 : kMaxLB;
}

template <class C>
cudaError_t launch(bool with_gain, const C* in, const C* integ0,
                   const C* peak0, C* out, C* carry_out, int L,
                   long long T, int cg, const LimParams<C>& p, void* stream) {
  if (L < 0 || T < 1 || cg < 1 || cg > (with_gain ? max_group<C>() : kMaxLB) ||
      L % cg)
    return cudaErrorInvalidValue;
  const int LB = block_lanes(cg);
  const int blocks = (L + LB - 1) / LB;
  if (blocks == 0) return cudaSuccess;
  // 16-byte pieces of 4 steps (the gain's stores) and of the copies
  const int vec = T % 4 == 0 && aligned16(in) && aligned16(out);
  const size_t shmem =
      (size_t)(with_gain ? 2 : 1) * kRing * LB * kLdOf<C> * sizeof(C);
  auto kernel = with_gain ? limiter_kernel<true, C> : limiter_kernel<false, C>;
  if (shmem > 48 * 1024) {  // more than the default needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads5, shmem, (cudaStream_t)stream>>>(
      in, integ0, peak0, out, carry_out, L, T, cg, LB, p, vec);
  return cudaGetLastError();
}

}  // namespace

// db, integ0, peak0: [L, T], [L], [L]; peak_out [L, T]; carry_out [2, L]
// (integ, peak of the last step)
extern "C" int rt_limiter_env(const float* db, const float* integ0,
                              const float* peak0, float* peak_out,
                              float* carry_out, int L, long long T, float att,
                              float rel, float catt, float crel, void* stream) {
  const LimParams<float> p{att, rel, catt, crel, 0.f, 0.f, 0.f, 0.f, 0.f};
  return (int)launch(false, db, integ0, peak0, peak_out, carry_out, L, T, 1, p,
                     stream);
}

// K5's f64 instance of limiter_env: every array and coefficient f64
extern "C" int rt_limiter_env_f64(const double* db, const double* integ0,
                                  const double* peak0, double* peak_out,
                                  double* carry_out, int L, long long T,
                                  double att, double rel, double catt,
                                  double crel, void* stream) {
  const LimParams<double> p{att, rel, catt, crel, 0.0, 0.0, 0.0, 0.0, 0.0};
  return (int)launch(false, db, integ0, peak0, peak_out, carry_out, L, T, 1, p,
                     stream);
}

// x: [L, T] in groups of cg consecutive lanes (cg <= 32 dividing L); y
// [L, T]; carry_out [2, L] as rt_limiter_env's
extern "C" int rt_limiter_stream(const float* x, const float* integ0,
                                 const float* peak0, float* y,
                                 float* carry_out, int L, long long T, int cg,
                                 float att, float rel, float catt, float crel,
                                 float threshold, float knee_width,
                                 float inv_knee_8, float log2_to_db,
                                 float db_to_log2, void* stream) {
  const LimParams<float> p{att,        rel,        catt,       crel,      threshold,
                           knee_width, inv_knee_8, log2_to_db, db_to_log2};
  return (int)launch(true, x, integ0, peak0, y, carry_out, L, T, cg, p, stream);
}

// K5's f64 instance of limiter_stream: every array and parameter f64
extern "C" int rt_limiter_stream_f64(const double* x, const double* integ0,
                                     const double* peak0, double* y,
                                     double* carry_out, int L, long long T,
                                     int cg, double att, double rel,
                                     double catt, double crel, double threshold,
                                     double knee_width, double inv_knee_8,
                                     double log2_to_db, double db_to_log2,
                                     void* stream) {
  const LimParams<double> p{att,        rel,        catt,       crel,      threshold,
                            knee_width, inv_knee_8, log2_to_db, db_to_log2};
  return (int)launch(true, x, integ0, peak0, y, carry_out, L, T, cg, p, stream);
}

// the most channels a group of rt_limiter_stream may have
extern "C" int rt_limiter_stream_max_group() { return max_group<float>(); }

// ... and of rt_limiter_stream_f64
extern "C" int rt_limiter_stream_f64_max_group() { return max_group<double>(); }

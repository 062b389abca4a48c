// K6: the AGC's whole per-sample loop, one serial recurrence per lane.
//
// Replaces rodio_tpu/ops/pallas_scan.py agc_pallas / _agc_kernel
// (src/source/agc.rs:397-496). Per step, in the TPU kernel's order:
//
//   coeff = x > peak ? 0 : rel;  peak = peak*coeff + x*(1 - coeff)
//   rsum  = rsum + d                              (d = sq - old, given)
//   des   = desired_gain(rsum, peak)              (agc_math.cuh)
//   gain  = smooth_gain(gain, des)                -> the output
//
// What bounds it on the H100: the gain smoother's chain, 5 dependent
// rounded ops a step (mul, add, max, min, select), which one thread runs at
// 24.3 SM cycles (12.2 ns) a step (benches/op_latency.py smooth_step): 0.31
// ms for the 25600 steps of [512, 25600]. The peak and window-sum chains
// are shorter (~3 ops and 1), and the desired gain (an IEEE sqrt and two
// divides, each with a slow-path branch) depends only on rsum and peak, not
// on the gain, so it leaves the chains: run on the chains' thread it made a
// step ~310 cycles (4.0 ms, one thread per lane, 16 blocks of 32 lanes).
// This design: ~0.39 ms on an H100 80GB HBM3 at 700 W, the smoother warp at
// ~28 cycles a step (benches/warp_cycles.py).
//
// Design (K2's shape, fused_agc.cu, without its resampler and biquad; the
// tiles of chain_pipeline.cuh): a block owns kBL = 4 lanes (128 blocks for
// 512) and walks time in tiles of 128 steps through a five-stage pipeline,
// one __syncthreads a tile. At iteration i:
//
//   warp 0 (copy):        |x| and d of tile i+1 into shared memory with
//                         cp.async, then waits for tile i's
//   warp 1:               peak and rsum chains of tile i-1, one thread per
//                         lane, 32 steps at a time in registers: peak over
//                         |x|, rsum over d, in place
//   elementwise warps     desired_gain(rsum, peak) of tile i-2 (over rsum),
//   (3, 4, 7, 8):         and tile i-4's gains stored coalesced
//   warp 2:               the smoother over tile i-3 (gains over the desired
//                         gains), one thread per lane, 32 steps at a time
//
// A tile's two rows of each lane sit in a ring of six (from its copy to its
// store); 25 KB of static shared memory. No elementwise warp shares an SMSP
// (warp % 4) with warp 1 or 2 (warps 5 and 6 idle), and each elementwise
// thread reads all of its elements before it computes any: the lessons of
// K2. The parameters (att, rel, target, max_gain, floor, 1/window) are
// data, so a live knob rebuilds nothing. Every op is agc_math.cuh's, each
// rounding alone in the same order, so the gains and the carries (peak,
// rsum, gain at the last step) equal the plain PyTorch version bit for bit.
//
// The f64 instance (set_float64: the JAX kernel runs in its input's dtype,
// pallas_scan.py:337, its params stacked in that dtype, :346-349) is the
// same kernel on C = double: the rows, the chains, the parameters [6] and
// every op f64, rounded alone (agc_math.cuh's f64 path: the IEEE f64 sqrt
// and divides, NaN-propagating min and max as selects). Its ring of four
// lanes takes 49920 bytes, past the 48 KB a static allocation may hold, so
// it lives in dynamic shared memory (opted in with cudaFuncSetAttribute):
// 128 blocks for 512 lanes, one wave on 132 SMs, where 2 lanes a block in
// static memory would take two (the chain threads' registers allow one
// block an SM). Warps 1 and 2 hold 16 steps at a time in registers.
#include "agc_math.cuh"
#include "chain_pipeline.cuh"

namespace {

using namespace rt::chain;

constexpr int kThreads6 = 9 * 32;  // warps 5 and 6 idle
constexpr int kNWork = 4 * 32;     // elementwise threads
constexpr int kRing = 6;           // tiles staged: i+1 .. i-4
constexpr int kDepth = 4;          // iterations from a tile's chains to its store
// steps warps 1 and 2 hold in registers at once: with 64, the blocks'
// times spread 10 % apart (block 0 the fastest); with 32 they match
constexpr int kHalf6 = 32;
static_assert(kNWork == kTile, "an elementwise thread takes one step of each lane");
// steps a chain thread holds, by the chain's type; the f64 ring is dynamic
// (the f32 instance keeps its static ring as it was measured)
template <class C>
constexpr int kHalfOf = std::is_same<C, double>::value ? kHalf6 / 2 : kHalf6;
template <class C>
constexpr bool kDynamic = std::is_same<C, double>::value;
// one input's tile: lane l's steps in row l
template <class C>
using Tile = C[kBL][kLdOf<C>];

// the elementwise slot of a warp (SMSPs 3, 0, 3, 0), or -1
__device__ __forceinline__ int work_slot(int warp) {
  return warp == 3 || warp == 4 ? warp - 3 : warp == 7 || warp == 8 ? warp - 5
                                                                    : -1;
}

// warp 1's step: the peak detector over |x| (row 0) and the window sum over
// d (row 1), each value replaced by the carry after it
template <class C>
struct PeakSum {
  C peak, rsum, rel;
  template <int H>
  __device__ __forceinline__ void operator()(C (&v)[2][H], int u) {
    peak = rt::peak_select(peak, v[0][u], rel);
    rsum = rt::add(rsum, v[1][u]);
    v[0][u] = peak;
    v[1][u] = rsum;
  }
};

// warp 2's step: the smoother toward the desired gain, replaced by the gain
template <class C>
struct Smooth {
  C g, att, rel, max_gain;
  template <int H>
  __device__ __forceinline__ void operator()(C (&v)[1][H], int u) {
    g = rt::smooth_gain(g, v[0][u], att, rel, max_gain);
    v[0][u] = g;
  }
};

template <class C>
__global__ void __launch_bounds__(kThreads6, 1)
agc_kernel(const C* __restrict__ xs, const C* __restrict__ d,
           const C* __restrict__ params, const C* __restrict__ peak0,
           const C* __restrict__ sum0, const C* __restrict__ gain0,
           C* __restrict__ gain_out, C* __restrict__ carry_out, int L,
           long long T, int vec) {
  constexpr int BL = kBL, H = kHalfOf<C>;
  // X: |x|, then the peaks; D: d, then the window sums, the desired gains
  // and the gains; kRing tiles each
  Tile<C>* X;
  Tile<C>* D;
  if constexpr (kDynamic<C>) {
    extern __shared__ float4 smem6[];
    X = reinterpret_cast<Tile<C>*>(smem6);
    D = X + kRing;
  } else {
    __shared__ __align__(16) C sx[kRing][BL][kLdOf<C>], sd[kRing][BL][kLdOf<C>];
    X = sx;
    D = sd;
  }
  const auto p = rt::load_agc_params(params);
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const long long lane0 = (long long)blockIdx.x * BL;
  const int nl = (int)min((long long)BL, L - lane0);
  const int n_tiles = (int)((T + kTile - 1) / kTile);
  auto live = [&](int j) { return j >= 0 && j < n_tiles; };
  auto copy = [&](int j) {
    const int s = j % kRing, tt = tile_len(T, j);
    const long long t0 = (long long)j * kTile;
    copy_lanes(X[s][0], xs, lane0, BL, nl, T, t0, tt, vec, wl, 32);
    copy_lanes(D[s][0], d, lane0, BL, nl, T, t0, tt, vec, wl, 32);
  };

  PeakSum<C> ps{C(0), C(0), p.rel};
  Smooth<C> sm{C(0), p.att, p.rel, p.max_gain};
  if (warp == 1 && wl < nl) {
    ps.peak = peak0[lane0 + wl];
    ps.rsum = sum0[lane0 + wl];
  } else if (warp == 2 && wl < nl) {
    sm.g = gain0[lane0 + wl];
  }
  const int slot = work_slot(warp);
  if (warp == 0) {
    if (live(0)) copy(0);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles + kDepth; ++it) {
    if (warp == 0) {
      if (live(it + 1)) copy(it + 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile it has landed
    } else if (warp == 1) {
      const int j = it - 1;
      if (live(j) && wl < nl) {
        const int s = j % kRing;
        C* const rows[2] = {X[s][wl], D[s][wl]};
        full_or_tail(tile_len(T, j),
                     [&](auto tt) { chain_row<2, 2, H, C>(rows, tt, ps); });
      }
    } else if (warp == 2) {
      const int j = it - 3;
      if (live(j) && wl < nl) {
        C* const rows[1] = {D[j % kRing][wl]};
        full_or_tail(tile_len(T, j),
                     [&](auto tt) { chain_row<1, 1, H, C>(rows, tt, sm); });
      }
    } else if (slot >= 0) {
      const int sub = slot * 32 + wl;
      if (live(it - kDepth)) {
        const int j = it - kDepth;
        store_lanes<C, C>(gain_out, D[j % kRing][0], lane0, BL, nl, T,
                          (long long)j * kTile, tile_len(T, j), vec, sub, kNWork);
      }
      if (live(it - 2)) {
        // step sub of each lane: every read first, then the desired gains
        const int s = (it - 2) % kRing, tt = tile_len(T, it - 2);
        C rs[BL], pk[BL];
#pragma unroll
        for (int l = 0; l < BL; ++l) {
          rs[l] = D[s][l][sub];
          pk[l] = X[s][l][sub];
        }
#pragma unroll
        for (int l = 0; l < BL; ++l)
          if (l < nl && sub < tt) D[s][l][sub] = rt::desired_gain(rs[l], pk[l], p);
      }
    }
    __syncthreads();
  }

  // the carries of the last step
  if (warp == 1 && wl < nl) {
    carry_out[0 * L + lane0 + wl] = ps.peak;
    carry_out[1 * L + lane0 + wl] = ps.rsum;
  } else if (warp == 2 && wl < nl) {
    carry_out[2 * L + lane0 + wl] = sm.g;
  }
}

template <class C>
int launch(const C* xs, const C* d, const C* params, const C* peak0,
           const C* sum0, const C* gain0, C* gain_out, C* carry_out, int L,
           long long T, void* stream) {
  if (L < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (L + kBL - 1) / kBL;
  if (blocks == 0) return 0;
  const int vec = T % kVec<C> == 0 && aligned16(xs) && aligned16(d) &&
                  aligned16(gain_out);
  const size_t shmem = kDynamic<C> ? 2 * kRing * sizeof(Tile<C>) : 0;
  if (shmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        agc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  agc_kernel<C><<<blocks, kThreads6, shmem, (cudaStream_t)stream>>>(
      xs, d, params, peak0, sum0, gain0, gain_out, carry_out, L, T, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_agc(const float* xs, const float* d, const float* params,
                      const float* peak0, const float* sum0,
                      const float* gain0, float* gain_out, float* carry_out,
                      int L, long long T, void* stream) {
  return launch(xs, d, params, peak0, sum0, gain0, gain_out, carry_out, L, T,
                stream);
}

// K6's f64 instance: every array and the parameters f64
extern "C" int rt_agc_f64(const double* xs, const double* d, const double* params,
                          const double* peak0, const double* sum0,
                          const double* gain0, double* gain_out,
                          double* carry_out, int L, long long T, void* stream) {
  return launch(xs, d, params, peak0, sum0, gain0, gain_out, carry_out, L, T,
                stream);
}

// K7: a first-order recurrence per lane, three ops in one kernel.
//
// Replaces rodio_tpu/ops/pallas_scan.py first_order_pallas /
// _first_order_kernel. Per step, in the TPU kernel's order:
//
//   linear:      y = a*y' + b
//   max_affine:  y = max(a, b + c*y')
//   agc_gain:    y = smooth_gain(y', a) with (att, rel, max_gain) as data
//                (the AGC's dual-rate smoother, src/source/agc.rs:486-496)
//
// What bounds it on the H100: the serial chain, ~2 (linear) to 5
// (agc_gain: mul, add, max, min, select) dependent rounded ops a step on
// one thread per lane. The AGC's decomposed path calls it with one lane (a
// stereo stream's 2T interleaved samples: [1, 8192] at blocks of 4096
// frames; [1, 512] with group = 8): one thread, latency bound; a smoother
// step takes 24.3 SM cycles (12.2 ns) on one thread (benches/op_latency.py
// smooth_step), 0.10 ms for 8192. On 32-step tiles filled by plain loads
// one tile ahead (lane_pipeline.cuh) each tile waited for its load: ~54
// cycles a step, 0.225 ms. This design: ~0.119 ms on an H100 80GB HBM3 at
// 700 W, the chain warp at 27.2 cycles a step (benches/warp_cycles.py).
//
// Design (chain_pipeline.cuh): a block of two warps owns kBL = 4 lanes and
// walks time in tiles of 128 steps. Warp 0 is the chain, one thread per
// lane, on 64-step register halves of its rows, the output y over input a
// in place. Warp 1 keeps the tiles coming: with cp.async it stages tile i+3
// of each input the op reads at iteration i (so tiles i+1 .. i+3 are in
// flight or landed while the chain runs tile i) and waits for tile i+1's;
// it stores tile i-1's outputs from their staged rows, coalesced. The two
// warps meet once a tile on a named barrier of their 64 threads, in a ring
// of five tiles (from a tile's copy to its store; at most 31 KB of static
// shared memory). Every op rounds alone, so the kernel equals its plain
// PyTorch version bit for bit.
//
// The f64 instance (set_float64; the JAX kernel runs in its input dtype
// under interpret mode, pallas_scan.py:446) is the same kernel on C =
// double: the rows, the chain and the parameters f64, each op an f64 op
// rounded alone (agc_math.cuh's f64 smoother clips at the f64 0.1, as the
// JAX gain_step's dt(0.1)). A block holds kBLOf<double> = 2 lanes and the
// chain 32 steps at a time in registers, so the ring stays at 31 KB of
// static shared memory and the registers where the f32 instance's are.
#include "agc_math.cuh"
#include "chain_pipeline.cuh"

namespace {

using namespace rt::chain;

constexpr int kLinear = 0, kMaxAffine = 1, kAgcGain = 2;
constexpr int kThreads7 = 2 * 32;  // warp 0 the chain, warp 1 the copies
constexpr int kAhead = 3;          // tiles staged ahead of the chain's
constexpr int kRing7 = kAhead + 2;  // tiles i-1 .. i+3
// lanes a block, and steps a chain thread holds, by the chain's type
template <class C>
constexpr int kBLOf = std::is_same<C, double>::value ? 2 : kBL;
template <class C>
constexpr int kHalfOf = std::is_same<C, double>::value ? kHalf / 2 : kHalf;

// the two warps' barrier, once a tile
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads7) : "memory");
}

// the chain's step over its inputs' registers (a, b, c), y over a
template <int OP, int NIN, class C>
struct FirstOrderStep {
  C yc, att, rel, max_gain;

  template <int H>
  __device__ __forceinline__ void operator()(C (&v)[NIN][H], int u) {
    if constexpr (OP == kLinear) {
      yc = rt::add(rt::mul(v[0][u], yc), v[1][u]);
    } else if constexpr (OP == kMaxAffine) {
      yc = rt::maxn(v[0][u], rt::add(v[1][u], rt::mul(v[2][u], yc)));
    } else {
      yc = rt::smooth_gain(yc, v[0][u], att, rel, max_gain);
    }
    v[0][u] = yc;
  }
};

template <int OP, class C>
__global__ void __launch_bounds__(kThreads7, 1)
first_order_kernel(const C* __restrict__ a, const C* __restrict__ b,
                   const C* __restrict__ c,
                   const C* __restrict__ init,
                   const C* __restrict__ params, C* __restrict__ y,
                   int L, long long T, int vec) {
  constexpr int NIN = OP == kLinear ? 2 : OP == kMaxAffine ? 3 : 1;
  constexpr int BL = kBLOf<C>;
  __shared__ __align__(16) C bufs[kRing7][NIN][BL][kLdOf<C>];
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const long long lane0 = (long long)blockIdx.x * BL;
  const int nl = (int)min((long long)BL, L - lane0);
  const int n_tiles = (int)((T + kTile - 1) / kTile);
  const C* const in[3] = {a, b, c};
  auto live = [&](int j) { return j >= 0 && j < n_tiles; };
  auto copy = [&](int j) {
    if (!live(j)) return;
    const int tt = tile_len(T, j);
#pragma unroll
    for (int k = 0; k < NIN; ++k)
      copy_lanes(bufs[j % kRing7][k][0], in[k], lane0, BL, nl, T,
                 (long long)j * kTile, tt, vec, wl, 32);
  };

  FirstOrderStep<OP, NIN, C> step{C(0), C(0), C(0), C(0)};
  if (OP == kAgcGain) {
    step.att = params[0];
    step.rel = params[1];
    step.max_gain = params[2];
  }
  if (warp == 0 && wl < nl) step.yc = init[lane0 + wl];
  if (warp == 1) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      copy(j);
      cp_async_commit();
    }
    cp_async_wait<kAhead - 1>();  // tile 0 has landed
  }
  pair_sync();

  for (int it = 0; it < n_tiles + 1; ++it) {
    if (warp == 0) {
      if (live(it) && wl < nl) {
        C* rows[NIN];
#pragma unroll
        for (int k = 0; k < NIN; ++k) rows[k] = bufs[it % kRing7][k][wl];
        full_or_tail(tile_len(T, it), [&](auto tt) {
          chain_row<NIN, 1, kHalfOf<C>, C>(rows, tt, step);
        });
      }
    } else {
      const int j = it - 1;
      if (live(j))
        store_lanes(y, bufs[j % kRing7][0][0], lane0, BL, nl, T,
                    (long long)j * kTile, tile_len(T, j), vec, wl, 32);
      copy(it + kAhead);
      cp_async_commit();
      cp_async_wait<kAhead - 1>();  // tile it+1 has landed
    }
    pair_sync();
  }
}

template <int OP, class C>
void launch(const C* a, const C* b, const C* c, const C* init,
            const C* params, C* y, int L, long long T, int vec,
            int blocks, cudaStream_t s) {
  first_order_kernel<OP, C><<<blocks, kThreads7, 0, s>>>(a, b, c, init, params,
                                                         y, L, T, vec);
}

template <class C>
int first_order(const C* a, const C* b, const C* c, const C* init,
                const C* params, C* y, int L, long long T, int op,
                void* stream) {
  if (L < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (L + kBLOf<C> - 1) / kBLOf<C>;
  if (blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // the 16-byte path needs every array the op touches aligned
  int vec = T % kVec<C> == 0 && aligned16(a) && aligned16(y);
  if (op != kAgcGain) vec = vec && aligned16(b);
  if (op == kMaxAffine) vec = vec && aligned16(c);
  switch (op) {
    case kLinear:
      launch<kLinear>(a, b, c, init, params, y, L, T, vec, blocks, s);
      break;
    case kMaxAffine:
      launch<kMaxAffine>(a, b, c, init, params, y, L, T, vec, blocks, s);
      break;
    case kAgcGain:
      launch<kAgcGain>(a, b, c, init, params, y, L, T, vec, blocks, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_first_order(const float* a, const float* b, const float* c,
                              const float* init, const float* params,
                              float* y, int L, long long T, int op,
                              void* stream) {
  return first_order(a, b, c, init, params, y, L, T, op, stream);
}

// K7's f64 instance: every array and the parameters f64
extern "C" int rt_first_order_f64(const double* a, const double* b,
                                  const double* c, const double* init,
                                  const double* params, double* y, int L,
                                  long long T, int op, void* stream) {
  return first_order(a, b, c, init, params, y, L, T, op, stream);
}

// K4: direct-form-I biquad over lanes, one serial recurrence per lane.
//
// Replaces rodio_tpu/ops/pallas_scan.py biquad_df1_pallas / _biquad_kernel.
// Per step, the reference's DF-I step (src/source/blt.rs:556-561) split
// where the chain begins, every op rounded alone:
//
//   u = (b0*x + b1*x1) + b2*x2      the FIR half: no y in it
//   y = (u - a1*y1) - a2*y2         the IIR half: the chain
//
// biquad_step (precise_math.cuh) and the plain scan (ops/scan.py) round
// ((b0x + b1x1) + b2x2 - a1y1) - a2y2 one op at a time, left to right, so
// u is exactly their first three ops: y and the carries (x1, x2, y1, y2)
// equal biquad_df1_plain's bit for bit (K1 makes the same split,
// fused_front.cuh).
//
// What bounds it on the H100: the IIR half, mul a1*y1, sub, sub a step
// through y1 (a2*y2 is ready a step early), one thread per lane: 12800 x 3
// x ~2.04 ns = 0.078 ms at [1024, 12800]. The 105 MB it reads and writes
// take 31 us at 3.35 TB/s. This design: ~0.101 ms in a CUDA graph at
// [1024, 12800], the chain warp at ~14.4 cycles a step, and 0.034 ms at
// path B's [2, 4096] (the earlier 32-lane design: 0.34 and 0.075 ms;
// benches/warp_cycles.py, NVIDIA H100 80GB HBM3 at 700 W).
//
// Design (chain_pipeline.cuh, K5's block shape): a block owns kLB = 8
// lanes, so 128 blocks for 1024 lanes, one wave on 132 SMs, and walks time
// in tiles of 128 steps, one __syncthreads a tile. At iteration i:
//
//   warp 0 (copy):          tile i+3's rows of x into shared memory with
//                           cp.async (16 bytes a copy where T % 4 == 0 and
//                           x is aligned, else 4), then waits for tile
//                           i+2's
//   elementwise warps       tile i+1's FIR half, 4 steps of one lane a
//   (2, 3, 6, 7):           thread (x1, x2 of the tile's first steps from
//                           the previous thread by a shuffle, from tile
//                           i's staged rows, or the carry-in), u stored 16
//                           bytes at a time; tile i-1's y stored coalesced
//                           from its rows
//   warp 1 (the chain):     tile i's IIR half, one thread per lane, 64
//                           steps at a time in registers, y over u in place
//
// Warp 1 has SMSP 1 (warp % 4) to itself (warp 5 idles, as warp 4 does
// beside the copy warp). Tile 0's FIR half runs before the loop, so the
// chain starts at the first iteration and the loop has one iteration more
// than the tiles: path B's single block of 2 lanes is the chain and little
// else. 30 KB of static shared memory. The x carries out are read from x
// itself (its last two steps, or the carry-in where T < 2), so they are the
// sequential scan's.
//
// The bf16 instance (a block behind a Bf16Boundary, the JAX kernel's bf16
// block, pallas_scan.py:88-93) is the same kernel on E = __nv_bfloat16:
// the copy warp stages bf16 rows (16 bytes, 8 values, a cp.async where
// T % 8 == 0 and x is aligned, else plain loads), the FIR threads upcast
// them (exactly), the arithmetic is unchanged, and the stores round y to
// nearest even. Inside a call the feedback is f32, as the Pallas scratch
// is; the y carries out are the stored (rounded) outputs, as the JAX
// wrapper takes them (pallas_scan.py:133-138), so across calls the feedback
// is the rounded output. Its bound at [1024, 12800]: 52.4 MB, 0.0157 ms at
// 3.35 TB/s, under the same chain floor.
//
// The f64 instance (set_float64: rodio_tpu/core/types.py:29, the JAX
// kernel in its input dtype under interpret mode, pallas_scan.py:97) is
// the same kernel on E = C = double: x, y, the coefficients and the
// carries f64, every mul and add an f64 op rounded alone (__dmul_rn,
// __dadd_rn), so it equals the f64 sequential scan bit for bit. A block
// holds kLBOf<double> = 4 lanes, so its staged rows (twice as wide) stay
// under the 48 KB of static shared memory: 29 KB. Its bound at [2, 4096]
// and [1024, 12800]: 2 x 8 bytes a sample over 3.35 TB/s, under a chain of
// 3 dependent DMUL/DADD a step (benches/op_latency.py).
#include "chain_pipeline.cuh"
#include "precise_math.cuh"

namespace {

using namespace rt::chain;

// lanes a block: 8, and 4 for f64 blocks (their rows take twice the bytes)
template <class E>
constexpr int kLBOf = std::is_same<E, double>::value ? 4 : 8;
constexpr int kThreads4 = 8 * 32;   // warps 4 and 5 idle
constexpr int kNWork = 4 * 32;      // elementwise threads
constexpr int kXBufs = 4;           // x tiles staged: i+3 .. i
constexpr int kYBufs = 3;           // u, then y, tiles: i+1 .. i-1
constexpr int kQuads = kTile / 4;   // 4-step pieces of a lane's tile
static_assert(kQuads == 32, "a warp takes one lane's tile, a quad a thread");

// the elementwise slot of a warp, or -1: warps 2, 3, 6 and 7 (SMSPs 2, 3,
// 2, 3), none beside the chain warp on SMSP 1
__device__ __forceinline__ int work_slot(int warp) {
  return warp == 2 || warp == 3 ? warp - 2 : warp == 6 || warp == 7 ? warp - 4 : -1;
}

// the coefficients in the chain's type C
template <class C>
struct Coef {
  C b0, b1, b2, a1, a2;
};

// the chain's step: u in, y out in its place
template <class C>
struct Iir {
  C y1, y2, a1, a2;
  template <int H>
  __device__ __forceinline__ void operator()(C (&v)[1][H], int u) {
    const C yt = rt::sub(rt::sub(v[0][u], rt::mul(a1, y1)), rt::mul(a2, y2));
    y2 = y1;
    y1 = yt;
    v[0][u] = yt;
  }
};

// the FIR half of one step: (b0*x + b1*x1) + b2*x2
template <class C>
__device__ __forceinline__ C fir(const Coef<C>& k, C x, C x1, C x2) {
  return rt::add(rt::add(rt::mul(k.b0, x), rt::mul(k.b1, x1)), rt::mul(k.b2, x2));
}

// E: the block's element type (float, __nv_bfloat16 or double); the chain
// computes in C = Calc<E>, which also types the coefficients and carries
template <class E, class C = Calc<E>>
__global__ void __launch_bounds__(kThreads4, 1)
biquad_df1_kernel(const E* __restrict__ x, E* __restrict__ y,
                  const C* __restrict__ coef,
                  const C* __restrict__ x1i, const C* __restrict__ x2i,
                  const C* __restrict__ y1i, const C* __restrict__ y2i,
                  C* __restrict__ x1o, C* __restrict__ x2o,
                  C* __restrict__ y1o, C* __restrict__ y2o,
                  int L, long long T, int vec) {
  constexpr int kLB = kLBOf<E>;
  __shared__ __align__(16) E X[kXBufs][kLB][kLdOf<E>];
  __shared__ __align__(16) C Y[kYBufs][kLB][kLdOf<C>];
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const long long lane0 = (long long)blockIdx.x * kLB;
  const int nl = (int)min((long long)kLB, L - lane0);
  const int n_tiles = (int)((T + kTile - 1) / kTile);
  const Coef<C> k{coef[0], coef[1], coef[2], coef[3], coef[4]};
  auto live = [&](int j) { return j >= 0 && j < n_tiles; };

  Iir<C> iir{C(0), C(0), k.a1, k.a2};
  if (warp == 1 && wl < nl) {
    iir.y1 = y1i[lane0 + wl];
    iir.y2 = y2i[lane0 + wl];
  }
  const int slot = work_slot(warp);
  // the FIR half of tile j as elementwise thread sub: one lane's tile a warp
  // (so the shuffles are whole warps), 4 steps a thread, steps past a tail
  // tile's end computed and never read
  auto fir_tile = [&](int j, int sub) {
    for (int q = sub; q < nl * kQuads; q += kNWork) {
      const int l = q / kQuads, t0 = q % kQuads * 4;
      const auto v = load4(X[j % kXBufs][l] + t0);
      C h1 = __shfl_up_sync(0xffffffffu, v.w, 1);  // x at t0 - 1
      C h2 = __shfl_up_sync(0xffffffffu, v.z, 1);  // x at t0 - 2
      if (t0 == 0) {
        if (j) {
          const E* p = X[(j - 1) % kXBufs][l];
          h2 = to_calc(p[kTile - 2]);
          h1 = to_calc(p[kTile - 1]);
        } else {
          h2 = x2i[lane0 + l];
          h1 = x1i[lane0 + l];
        }
      }
      *reinterpret_cast<std::decay_t<decltype(v)>*>(Y[j % kYBufs][l] + t0) =
          make4(fir(k, v.x, h1, h2), fir(k, v.y, v.x, h1), fir(k, v.z, v.y, v.x),
                fir(k, v.w, v.z, v.y));
    }
  };
  auto copy_tile = [&](int j) {
    if (live(j))
      copy_lanes(X[j % kXBufs][0], x, lane0, kLB, nl, T, (long long)j * kTile,
                 tile_len(T, j), vec, wl, 32);
    cp_async_commit();
  };
  // tiles 0-2 in flight, tile 0's FIR half before the loop, so that the
  // chain starts at iteration 0
  if (warp == 0) {
    copy_tile(0);
    copy_tile(1);
    copy_tile(2);
    cp_async_wait<1>();  // tiles 0 and 1 have landed
  }
  __syncthreads();
  if (slot >= 0 && live(0)) fir_tile(0, slot * 32 + wl);
  __syncthreads();

  for (int it = 0; it < n_tiles + 1; ++it) {
    if (warp == 0) {
      copy_tile(it + 3);
      cp_async_wait<1>();  // tile it+2 has landed
    } else if (warp == 1) {
      if (live(it) && wl < nl) {
        C* const rows[1] = {Y[it % kYBufs][wl]};
        full_or_tail(tile_len(T, it), [&](auto tt) { chain_row<1, 1, kHalf, C>(rows, tt, iir); });
      }
    } else if (slot >= 0) {
      const int sub = slot * 32 + wl;
      if (live(it + 1)) fir_tile(it + 1, sub);
      if (live(it - 1))
        store_lanes(y, Y[(it - 1) % kYBufs][0], lane0, kLB, nl, T,
                    (long long)(it - 1) * kTile, tile_len(T, it - 1), vec, sub, kNWork);
    }
    __syncthreads();
  }

  // the carries: the last two inputs and stored outputs (the carry-in
  // where T < 2); a bf16 block's y carries are its rounded outputs, so
  // across calls the feedback is what was stored
  if (warp == 1 && wl < nl) {
    const long long l = lane0 + wl;
    const E* xl = x + l * T;
    x1o[l] = T >= 1 ? to_calc(xl[T - 1]) : x1i[l];
    x2o[l] = T >= 2 ? to_calc(xl[T - 2]) : T == 1 ? x1i[l] : x2i[l];
    if constexpr (std::is_same<E, __nv_bfloat16>::value) {
      y1o[l] = T >= 1 ? stored<E>(iir.y1) : iir.y1;
      y2o[l] = T >= 2 ? stored<E>(iir.y2) : iir.y2;
    } else {
      y1o[l] = iir.y1;
      y2o[l] = iir.y2;
    }
  }
}

template <class E, class C = Calc<E>>
int launch_biquad(const E* x, E* y, const C* coef, const C* x1i,
                  const C* x2i, const C* y1i, const C* y2i, C* x1o,
                  C* x2o, C* y1o, C* y2o, int L, long long T, void* stream) {
  if (L < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (L + kLBOf<E> - 1) / kLBOf<E>;
  if (blocks == 0) return 0;
  const int vec = T % kVec<E> == 0 && aligned16(x) && aligned16(y);
  biquad_df1_kernel<E><<<blocks, kThreads4, 0, (cudaStream_t)stream>>>(
      x, y, coef, x1i, x2i, y1i, y2i, x1o, x2o, y1o, y2o, L, T, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_biquad_df1(const float* x, float* y, const float* coef,
                             const float* x1i, const float* x2i,
                             const float* y1i, const float* y2i, float* x1o,
                             float* x2o, float* y1o, float* y2o, int L,
                             long long T, void* stream) {
  return launch_biquad(x, y, coef, x1i, x2i, y1i, y2i, x1o, x2o, y1o, y2o, L, T, stream);
}

// K4's bf16 instance: x and y bf16, everything else as rt_biquad_df1's
extern "C" int rt_biquad_df1_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                                  const float* coef, const float* x1i,
                                  const float* x2i, const float* y1i,
                                  const float* y2i, float* x1o, float* x2o,
                                  float* y1o, float* y2o, int L, long long T,
                                  void* stream) {
  return launch_biquad(x, y, coef, x1i, x2i, y1i, y2i, x1o, x2o, y1o, y2o, L, T, stream);
}

// K4's f64 instance: x, y, the coefficients and the carries f64
extern "C" int rt_biquad_df1_f64(const double* x, double* y, const double* coef,
                                 const double* x1i, const double* x2i,
                                 const double* y1i, const double* y2i,
                                 double* x1o, double* x2o, double* y1o,
                                 double* y2o, int L, long long T, void* stream) {
  return launch_biquad(x, y, coef, x1i, x2i, y1i, y2i, x1o, x2o, y1o, y2o, L, T, stream);
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

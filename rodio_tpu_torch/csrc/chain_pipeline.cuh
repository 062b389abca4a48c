// The tiled chain pipeline shared by K5 (limiter_env.cu), K6 (agc.cu) and
// K7 (first_order.cu).
//
// A block owns a few lanes of row-major [L, T] arrays (K6 and K7 kBL = 4,
// K5 whole channel groups; a ragged L ends on a block of fewer) and walks
// time in tiles of kTile = 128 steps. A tile of one input sits in shared
// memory as a row of steps per lane, the rows kLd floats apart, so that
// they are 16-byte aligned and neighbouring lanes' rows start on different
// banks (Rows: kBL of them). Around the serial chains:
//
// - copy warps stage a tile's rows with cp.async (copy_rows), tiles ahead
//   of their use: 16 bytes a copy where T % 4 == 0 and the array is 16-byte
//   aligned, 4 bytes otherwise, so the chains never wait on global memory
//   (copy_lanes and store_lanes also take K4's bf16 blocks);
// - a chain thread runs its lane's recurrence on H (kHalf = 64 by default)
//   steps of its rows at a time in registers, loaded and stored 16 bytes at a time (chain_row),
//   so the chain's steps are all the loop issues; a whole tile runs with a
//   compile-time length (full_or_tail: rt::Steps<kTile>), with no per-step
//   test, and only a tail tile tests each step;
// - a tile's outputs leave from its staged rows, stored coalesced
//   (store_rows), or are computed from them and stored coalesced.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "lane_pipeline.cuh"  // rt::Steps

namespace rt::chain {

constexpr int kBL = 4;          // lanes a block of K6 and K7
constexpr int kTile = 128;      // steps a tile
constexpr int kHalf = 64;       // steps a chain thread holds in registers, by default
constexpr int kLd = kTile + 4;  // a staged row's stride: 16-byte rows, 4 banks apart

typedef float Rows[kBL][kLd];  // one input's tile: lane l's steps in row l

__device__ __forceinline__ int tile_len(long long T, int i) {
  return (int)min((long long)kTile, T - (long long)i * kTile);
}

// a whole tile's tt is rt::Steps<kTile>, a tail tile's an int
template <class TT>
constexpr bool kWhole = !std::is_same<TT, int>::value;

// run(tt) for a tile of tt steps: a whole tile runs with tt a compile-time
// kTile, so its copy of run has no per-step test
template <class Run>
__device__ __forceinline__ void full_or_tail(int tt, Run run) {
  if (tt == kTile)
    run(rt::Steps<kTile>{});
  else
    run(tt);
}

__host__ __device__ inline bool aligned16(const void* p) {
  return ((unsigned long long)p & 15) == 0;
}

// A block's element type E: f32, or bf16 (K4's bf16 instance), which the
// kernels upcast on load (exactly) and round to nearest even on store, or
// f64 (the f64 instances of K4 and K7), which they compute in: Calc<E> is
// the type a chain computes in.
template <class E>
constexpr int kVec = 16 / (int)sizeof(E);  // elements a 16-byte copy moves
template <class E>
using Calc = std::conditional_t<std::is_same<E, double>::value, double, float>;
// a staged row's stride in elements: 16-byte rows, 4 banks apart
template <class E>
constexpr int kLdOf = kTile + kVec<E>;
static_assert(kLdOf<float> == kLd, "f32 rows keep their stride");

// an element as its Calc type: bf16 widened to f32, f64 stays f64
__device__ __forceinline__ float to_calc(float v) { return v; }
__device__ __forceinline__ float to_calc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double to_calc(double v) { return v; }
template <class E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v as a block of type E stores it, read back as f32
template <class E>
__device__ __forceinline__ float stored(float v) { return to_calc(from_f32<E>(v)); }

// (a, b) rounded to bf16, as the 32 bits that hold them in memory, a first
__device__ __forceinline__ unsigned bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Four consecutive f64 values, 16-byte aligned (two 16-byte accesses)
struct __align__(16) Double4 {
  double x, y, z, w;
};

// Four consecutive elements at p (8- or 16-byte aligned) as Calc values
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ Double4 load4(const double* p) {
  return *reinterpret_cast<const Double4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// and four Calc values as the same vector types
__device__ __forceinline__ float4 make4(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}
__device__ __forceinline__ Double4 make4(double a, double b, double c, double d) {
  return Double4{a, b, c, d};
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages steps t0 .. t0 + tt - 1 of rows lane0 .. lane0 + nl - 1 of src
// ([L, T] of element type E: float, or __nv_bfloat16 for K4's bf16
// instance) into row l (dst + l * kLdOf<E>) of a tile of nb >= nl lanes,
// as thread sub of nsub copy threads. vec: T % kVec<E> == 0 and src
// 16-byte aligned (t0 is a multiple of kTile, so every 16-byte piece of a
// row lies inside it); 16 bytes a copy, kVec<E> elements. Otherwise 4-byte
// cp.async for f32, 8-byte for f64, and plain loads for bf16 (cp.async has
// no 2-byte form).
template <class E>
__device__ __forceinline__ void copy_lanes(E* dst, const E* __restrict__ src,
                                           long long lane0, int nb, int nl,
                                           long long T, long long t0, int tt,
                                           bool vec, int sub, int nsub) {
  constexpr int V = kVec<E>, LD = kLdOf<E>;
  const E* s = src + lane0 * T + t0;
  if (vec) {
    for (int e = sub; e < nb * (kTile / V); e += nsub) {
      const int l = e / (kTile / V), q = e % (kTile / V);
      if (l < nl && V * q < tt) cp_async16(dst + l * LD + V * q, s + l * T + V * q);
    }
  } else {
    for (int e = sub; e < nb * kTile; e += nsub) {
      const int l = e / kTile, t = e % kTile;
      if (l < nl && t < tt) {
        if constexpr (std::is_same<E, float>::value)
          cp_async4(dst + l * LD + t, s + l * T + t);
        else if constexpr (std::is_same<E, double>::value)
          cp_async8(dst + l * LD + t, s + l * T + t);
        else
          dst[l * LD + t] = s[l * T + t];
      }
    }
  }
}

// copy_lanes into one input's Rows of kBL lanes
__device__ __forceinline__ void copy_rows(Rows& dst,
                                          const float* __restrict__ src,
                                          long long lane0, int nl,
                                          long long T, long long t0, int tt,
                                          bool vec, int sub, int nsub) {
  copy_lanes(dst[0], src, lane0, kBL, nl, T, t0, tt, vec, sub, nsub);
}

// Stores row l (src + l * kLdOf<C>, of the chain's type C: f32, or f64 for
// an f64 block) of a tile of nb >= nl lanes, steps 0 .. tt - 1, to steps
// t0 .. t0 + tt - 1 of row lane0 + l (l < nl) of dst ([L, T] of element
// type E, rounded to nearest even for bf16), as thread sub of nsub;
// neighbouring threads store neighbouring steps. vec as copy_lanes's, for
// dst: 16 bytes a store.
template <class E, class C = float>
__device__ __forceinline__ void store_lanes(E* __restrict__ dst,
                                            const C* src, long long lane0,
                                            int nb, int nl, long long T,
                                            long long t0, int tt, bool vec,
                                            int sub, int nsub) {
  constexpr int V = kVec<E>, LDC = kLdOf<C>;
  E* d = dst + lane0 * T + t0;
  if (vec) {
    for (int e = sub; e < nb * (kTile / V); e += nsub) {
      const int l = e / (kTile / V), q = e % (kTile / V);
      if (l < nl && V * q < tt) {
        const float4* r = reinterpret_cast<const float4*>(src + l * LDC + V * q);
        if constexpr (sizeof(E) == sizeof(C)) {  // f32 or f64: 16 bytes as they are
          *reinterpret_cast<float4*>(d + l * T + V * q) = r[0];
        } else {
          const float4 a = r[0], b = r[1];
          *reinterpret_cast<uint4*>(d + l * T + V * q) =
              make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y),
                         bf16x2(b.z, b.w));
        }
      }
    }
  } else {
    for (int e = sub; e < nb * kTile; e += nsub) {
      const int l = e / kTile, t = e % kTile;
      if (l < nl && t < tt) {
        if constexpr (std::is_same<E, C>::value)
          d[l * T + t] = src[l * LDC + t];
        else
          d[l * T + t] = from_f32<E>(src[l * LDC + t]);
      }
    }
  }
}

// store_lanes from one input's Rows of kBL lanes
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const Rows& src, long long lane0,
                                           int nl, long long T, long long t0,
                                           int tt, bool vec, int sub,
                                           int nsub) {
  store_lanes(dst, src[0], lane0, kBL, nl, T, t0, tt, vec, sub, nsub);
}

// A lane's recurrence over a tile of tt steps: H steps at a time, v[k][u]
// holds rows[k][h + u] (k < NIN) in registers and step(v, u) runs step h + u,
// rewriting its outputs in place; rows 0 .. NOUT - 1 are stored back. The
// step keeps its carries itself. C is the rows' type (f32, or f64 for the
// f64 instances: 16-byte pieces of two values).
template <int NIN, int NOUT, int H = kHalf, class C = float, class TT, class Step>
__device__ __forceinline__ void chain_row(C* const (&rows)[NIN], TT tt,
                                          Step& step) {
  static_assert(NOUT <= NIN, "outputs overwrite inputs");
  static_assert(kTile % H == 0 && H % 4 == 0, "whole 16-byte pieces of a tile");
  constexpr bool kF64 = std::is_same<C, double>::value;
  // not unrolled: one copy of the H-step body (code size)
#pragma unroll 1
  for (int h = 0; h < kTile; h += H) {
    if (!kWhole<TT> && h >= tt) break;
    C v[NIN][H];
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      if constexpr (kF64) {
        const double2* r2 = reinterpret_cast<const double2*>(rows[k] + h);
#pragma unroll
        for (int q = 0; q < H / 2; ++q) {
          const double2 f = r2[q];
          v[k][2 * q] = f.x;
          v[k][2 * q + 1] = f.y;
        }
      } else {
        const float4* r4 = reinterpret_cast<const float4*>(rows[k] + h);
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const float4 f = r4[q];
          v[k][4 * q] = f.x;
          v[k][4 * q + 1] = f.y;
          v[k][4 * q + 2] = f.z;
          v[k][4 * q + 3] = f.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < H; ++u)
      if (kWhole<TT> || h + u < tt) step(v, u);
#pragma unroll
    for (int k = 0; k < NOUT; ++k) {
      if constexpr (kF64) {
        double2* r2 = reinterpret_cast<double2*>(rows[k] + h);
#pragma unroll
        for (int q = 0; q < H / 2; ++q) r2[q] = make_double2(v[k][2 * q], v[k][2 * q + 1]);
      } else {
        float4* r4 = reinterpret_cast<float4*>(rows[k] + h);
#pragma unroll
        for (int q = 0; q < H / 4; ++q)
          r4[q] = make_float4(v[k][4 * q], v[k][4 * q + 1], v[k][4 * q + 2],
                              v[k][4 * q + 3]);
      }
    }
  }
}

}  // namespace rt::chain

// What K2's plans on K1's front end share (fused_agc.cu: K2, K2r;
// fused_agc_blocked.cu: K2b; fused_agc_group.cu: K2g): the RMS window's
// ring, its rounding to the ring's type, and a frame's ring words loaded,
// unpacked and stored for the block's 8 lanes at once.
#pragma once

#include <cuda_bf16.h>

#include "agc_math.cuh"
#include "fused_front.cuh"  // rt::front::kBL, kYLd

namespace rt::fused_agc {

constexpr int kRing = 4096;  // frames of the RMS window: 8192 samples / 2 ch
constexpr int kBL = rt::front::kBL;  // lanes a block (4 stereo streams)

__device__ __forceinline__ float ring_f32(float v) { return v; }
__device__ __forceinline__ float ring_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename R>
__device__ __forceinline__ R ring_round(float v);
template <>
__device__ __forceinline__ float ring_round<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 ring_round<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A frame's 8 ring values (the block's lanes) as raw 32-bit words, and as
// f32, and the rounded ones back. vec: one 16-byte piece for bf16, two for
// f32 (nl == 8 and the rows aligned); else lane by lane, the block's nl
// lanes (nl is even).
template <typename R>
constexpr int kWords = kBL * (int)sizeof(R) / 4;

__device__ __forceinline__ void ring_load(const __nv_bfloat16* p, bool vec, int nl,
                                          unsigned (&w)[4]) {
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = 2 * k < nl ? h[2 * k] | (unsigned)h[2 * k + 1] << 16 : 0u;
  }
}
__device__ __forceinline__ void ring_load(const float* p, bool vec, int nl,
                                          unsigned (&w)[8]) {
  if (vec) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];
    const uint4 b = reinterpret_cast<const uint4*>(p)[1];
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  } else {
    const unsigned* u = reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int l = 0; l < kBL; ++l) w[l] = l < nl ? u[l] : 0u;
  }
}
__device__ __forceinline__ void ring_unpack(const unsigned (&w)[4], float (&o)[kBL]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = __uint_as_float(w[k] << 16);
    o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void ring_unpack(const unsigned (&w)[8], float (&o)[kBL]) {
#pragma unroll
  for (int l = 0; l < kBL; ++l) o[l] = __uint_as_float(w[l]);
}
// q: values the ring's type holds exactly
__device__ __forceinline__ void ring_store(__nv_bfloat16* p, bool vec, int nl,
                                           const float (&q)[kBL]) {
  if (vec) {
    unsigned u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      u[k] = (__float_as_uint(q[2 * k]) >> 16) | (__float_as_uint(q[2 * k + 1]) & 0xffff0000u);
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
#pragma unroll
    for (int l = 0; l < kBL; ++l)
      if (l < nl) p[l] = __float2bfloat16_rn(q[l]);
  }
}
__device__ __forceinline__ void ring_store(float* p, bool vec, int nl,
                                           const float (&q)[kBL]) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(q[0], q[1], q[2], q[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(q[4], q[5], q[6], q[7]);
  } else {
#pragma unroll
    for (int l = 0; l < kBL; ++l)
      if (l < nl) p[l] = q[l];
  }
}

// One frame t of a y tile (lane-major, row stride rt::front::kYLd) through
// the ring: the squares rounded to the ring's type (kPacked: the packed
// basis, lane 2s = round(sq0) and lane 2s+1 = round(sq0 + sq1), the f32
// sum; else each lane's own square), written to the ring at p, and d = q -
// old, old the ring's words loaded before (w), into the d tile's frame t.
template <bool kPacked, typename R>
__device__ __forceinline__ void ring_frame(const float* yb, int t, R* p, bool vec,
                                           int nl, const unsigned (&w)[kWords<R>],
                                           float* d) {
  constexpr int ld = rt::front::kYLd;
  float q[kBL], old[kBL];
  ring_unpack(w, old);
#pragma unroll
  for (int s = 0; s < kBL / 2; ++s) {
    const float y0 = yb[2 * s * ld + t], y1 = yb[(2 * s + 1) * ld + t];
    const float sq0 = rt::mul(y0, y0), sq1 = rt::mul(y1, y1);
    q[2 * s] = ring_f32(ring_round<R>(sq0));
    q[2 * s + 1] = ring_f32(ring_round<R>(kPacked ? rt::add(sq0, sq1) : sq1));
  }
  ring_store(p, vec, nl, q);
#pragma unroll
  for (int l = 0; l < kBL; ++l)
    if (l < nl) d[l * ld + t] = rt::sub(q[l], old[l]);
}

}  // namespace rt::fused_agc

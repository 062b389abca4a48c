// Threefry2x32 random bits, bit for bit JAX's, for the noise sources and
// Dither (ops/threefry.py).
//
// Replaces no pallas_call: the JAX package draws its noise with jax.random
// (rodio_tpu/sources/noise.py, rodio_tpu/effects/dither.py), whose
// threefry2x32 hash XLA lowers to integer ops (jax/_src/prng.py
// _threefry2x32_lowering, 20 rounds; _threefry_fold_in;
// _threefry_random_bits_partitionable: the flat counter j as the pair
// (j >> 32, j & 0xffffffff), the draw bits1 ^ bits2). Four modes:
//
//   bits     out[j] = draw j under fold_in(key, i)
//   uniform  the same draw as jax.random.uniform(lo, hi): the top 23 bits
//            as the mantissa of a float in [1, 2), minus 1, times (hi - lo)
//            plus lo, max(lo, .) (jax/_src/random.py _uniform)
//   velvet   Velvet's sample t = i + j (int32, wrapping): the draws of
//            randint(fold_in(key, t // grid), (2,), 0, 2 grid) decide the
//            cell's impulse position and sign (7 hashes a sample)
//   pink     Pink's sample t: the sum, in octave order, of the 16 draws
//            uniform(fold_in(fold_in(key, o), t >> o), (), -1, 1)
//            (2 hashes an octave; the 16 fold_in(key, o) once a block)
//
// What bounds it on the H100: integer operations. A hash is at the fewest
// 67 INT32 instructions (the low word's key add, 20 rounds of add,
// funnel-shift rotate and xor, 5 key injections of 2 adds, 4 of them merged
// into the next round's add); the card's INT32 rate is 132 SMs x 64 lanes x
// 1.98 GHz = 16.7e12 ops/s, so 2^24 uniform draws (a hash and 3 ops each:
// the xor, the shift and the or) take >= 0.0702 ms against 0.020 ms to
// write their 67 MB (chip_smoke.py's THREEFRY_OPS). Velvet's and Pink's
// bounds count a hash once per distinct cell or (octave, t >> o), as their
// functions need; this kernel hashes them again for every sample. The
// design is the simplest that keeps every lane busy: one thread a draw (a
// counter pair), a grid-stride loop over a grid of at most 8 blocks an SM,
// the block's folded key (and Pink's 16 octave keys) hashed once a block
// into shared memory. The float conversions are exact (a 23-bit mantissa
// times a power of two plus an exact offset), so the kernel equals its
// plain PyTorch version (int64 arithmetic masked to 32 bits) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 0, kUniform = 1, kVelvet = 2, kPink = 3;
constexpr int kThreads = 256;
constexpr int kOctaves = 16;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 of the counter pair (x0, x1) under (k0, k1): both words
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[g & 1][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
}

// fold_in(key, d): the pair (0, d) hashed; the two words are the new key
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1, uint32_t d,
                                        uint32_t& o0, uint32_t& o1) {
  o0 = 0u;
  o1 = d;
  threefry(k0, k1, o0, o1);
}

// the 32-bit draw of flat counter j (< 2^32) under (k0, k1)
__device__ __forceinline__ uint32_t draw(uint32_t k0, uint32_t k1, uint32_t j) {
  uint32_t hi = 0u, lo = j;
  threefry(k0, k1, hi, lo);
  return hi ^ lo;
}

__device__ __forceinline__ float to_uniform(uint32_t bits, float lo, float span) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u);
  return fmaxf(lo, __fadd_rn(__fmul_rn(__fsub_rn(f, 1.0f), span), lo));
}

// randint(key, (2,), 0, span) element e (jax/_src/random.py _randint):
// split the key in two (pairs (0, 0) and (0, 1)), a draw under each, the
// high draw times 2^32 mod span plus the low one, mod span, in uint32
__device__ __forceinline__ void randint2(uint32_t k0, uint32_t k1, uint32_t span,
                                         uint32_t mult, uint32_t (&out)[2]) {
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 1u;
  threefry(k0, k1, a0, b0);  // pair (0, 0): a0 = word 1, b0 = word 2
  threefry(k0, k1, a1, b1);  // pair (0, 1)
  // split keys: (a0, b0) and (a1, b1)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const uint32_t higher = draw(a0, b0, (uint32_t)e);
    const uint32_t lower = draw(a1, b1, (uint32_t)e);
    out[e] = ((higher % span) * mult + lower % span) % span;
  }
}

__global__ void threefry_kernel(const long long* __restrict__ key,
                                const long long* __restrict__ ctr, int mode,
                                long long n, float lo, float hi, int grid,
                                void* __restrict__ out) {
  __shared__ uint32_t sk[2 * kOctaves];
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const uint32_t i = (uint32_t)ctr[0];
  if (mode == kBits || mode == kUniform) {
    if (threadIdx.x == 0) fold_in(k0, k1, i, sk[0], sk[1]);
  } else if (mode == kPink && threadIdx.x < kOctaves) {
    fold_in(k0, k1, threadIdx.x, sk[2 * threadIdx.x], sk[2 * threadIdx.x + 1]);
  }
  __syncthreads();
  const float span = __fsub_rn(hi, lo);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    if (mode == kBits) {
      ((uint32_t*)out)[j] = draw(sk[0], sk[1], (uint32_t)j);
    } else if (mode == kUniform) {
      ((float*)out)[j] = to_uniform(draw(sk[0], sk[1], (uint32_t)j), lo, span);
    } else {
      const int t = (int)(i + (uint32_t)j);  // the int32 sample counter
      if (mode == kVelvet) {
        int cell = t / grid, pos = t % grid;
        if (pos < 0) {  // floor division and modulo, as jnp's // and %
          pos += grid;
          cell -= 1;
        }
        uint32_t c0, c1;
        fold_in(k0, k1, (uint32_t)cell, c0, c1);
        const uint32_t s = 2u * (uint32_t)grid;
        const uint32_t m = (65536u % s) * (65536u % s) % s;
        uint32_t d[2];
        randint2(c0, c1, s, m, d);
        const float sign = (d[1] % 2u == 0u) ? 1.0f : -1.0f;
        ((float*)out)[j] = (pos == (int)(d[0] % (uint32_t)grid)) ? sign : 0.0f;
      } else {
        float acc = 0.0f;
#pragma unroll 1
        for (int o = 0; o < kOctaves; ++o) {
          uint32_t e0, e1;
          fold_in(sk[2 * o], sk[2 * o + 1], (uint32_t)(t >> o), e0, e1);
          const float v = to_uniform(draw(e0, e1, 0u), -1.0f, 2.0f);
          acc = o == 0 ? v : __fadd_rn(acc, v);
        }
        ((float*)out)[j] = acc;
      }
    }
  }
}

}  // namespace

extern "C" int rt_threefry(const long long* key, const long long* ctr, int mode,
                           long long n, float lo, float hi, int grid, void* out,
                           void* stream) {
  if (n < 0 || n > 0xFFFFFFFFll || mode < kBits || mode > kPink || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 8ll * sms;
  if (blocks > cap) blocks = cap;
  threefry_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      key, ctr, mode, n, lo, hi, grid, out);
  return (int)cudaGetLastError();
}

// K8: y_t = max(x_t, a*y_{t-1} + (1-a)*x_t) over <= 8 rows, blocked in time.
//
// Replaces rodio_tpu/ops/limiter_block.py blocked_max_affine_const /
// _bma_kernel: the AGC's instant-attack, slow-release peak detector
// (src/source/agc.rs:397-407) on its decomposed path. The TPU kernel's
// blocked order is kept step for step: time is cut into P chunks of
// Lc = M/P; one thread per chunk builds the chunk's local prefix maps
// (B = max(d, a*B + (1-a)*d), C = a*C + (1-a)*d); log2 P Hillis-Steele
// rounds compose them across the chunks of a row (B' = max(Bp, Ap*Bs +
// Cp), C' = Ap*Cs + Cp, A' = Ap*As); the carry-in v_in then gives y =
// max(B_t, a^(t+1)*v_in + C_t). The power table a^(t+1) is the caller's
// (one table for the kernel and its plain version), and a = pw[0], a^Lc =
// pw[Lc-1], so a live release knob is data.
//
// What bounds it on the H100: the serial depth, Lc steps of pass 1, log2 P
// combine rounds and Lc steps of pass 2 (64 + 7 + 64 on the AGC's [1, 8192]
// block at P = 128), each step ~3 dependent rounded ops; bytes are few (32
// KB in, 32 KB out). On that block the earlier design, one block of rows*P
// threads walking x in global memory a load at a time and keeping B and C
// in a global scratch, took 0.0235 ms in a CUDA graph.
//
// Design (after K3, limiter_block.cu): one block of kThreads8 threads a
// row. Its phases, each ended by a barrier:
//
//   loads:   x staged in shared memory by cp.async, 16 bytes a copy (4
//            where Lc % 4 != 0), the warp's copies contiguous in x;
//            chunk-major, chunk p's steps in a row of chunk_ld(Lc) floats,
//            16-byte rows of an odd number of quads (a stride of Lc | 1,
//            odd, would meet distinct banks too, but takes no 16-byte
//            copy); the power table beside them
//   pass 1:  chunk thread p walks its row in registers, kCh8 steps loaded
//            ahead 16 bytes at a time, and keeps only the chunk's map
//   combine: warp 0 alone, each lane holding P/32 chunks' maps in
//            registers, the rounds' partners in other lanes by
//            __shfl_up_sync, no barrier between rounds; then every chunk's
//            carry-in
//   pass 2:  B and C rebuilt from x with the same ops in the same order (so
//            the same values), y written over x in shared memory
//   stores:  y from shared memory, 16 bytes a store, coalesced
//
// A row longer than kStageMax bytes of staged chunks keeps them in a global
// scratch that the caller allocates (rt_blocked_max_affine_scratch_floats),
// in the same layout, staged by plain loads and stores, the power table
// read from global memory.
//
// Measured on [1, 8192], P = 128 (benches/warp_cycles.py, NVIDIA H100 80GB
// HBM3 at 700 W): 0.0054 ms in a CUDA graph; block 0's cycles by phase
// ~1600 loads, ~1240 pass 1 (19 a step), ~1310 combine, ~2500 pass 2, ~1310
// stores. With 4-byte copies onto odd rows and a barrier a combine round
// the phases took ~2440, ~2310, ~2730, ~5570 and ~2360 (0.0089 ms).
#include <type_traits>

#include "agc_math.cuh"        // max_nan
#include "chain_pipeline.cuh"  // cp_async4, cp_async16

// benches/warp_cycles.py defines this to time the phases (block 0,
// thread 0, after each phase's barrier)
#ifndef RT_PHASE
#define RT_PHASE(k)
#endif

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kThreads8 = 128;  // a block: one row, up to kMaxP chunks
constexpr int kMaxP = 128;
constexpr int kCh8 = 8;         // steps a chunk thread holds at once
constexpr size_t kStageMax = 200 * 1024;  // a row's chunks in shared memory up to this

// A chunk's row stride for chunks of Lc steps: 16-byte rows (so a row
// takes 16-byte copies and loads) of an odd number of 16-byte quads (so the
// 8 chunk threads of a quarter warp, reading one step's quad each, meet
// distinct banks).
__host__ __device__ inline int chunk_ld(int Lc) { return 4 * (((Lc + 3) / 4) | 1); }

// floats of a row's staging: its chunks' rows, then the power table (one
// row more)
inline size_t row_floats(int M, int P) { return (size_t)(P + 1) * chunk_ld(M / P); }

// f(v, t, w) on steps t = 0 .. Lc-1 of a chunk's row xc (16-byte aligned),
// v the step's value, w its power (pw[t]; pw null: 0); kCh8 steps held in
// registers, loaded one chunk ahead, and written back from v after f
// (store: y over x)
template <bool kStore, class F>
__device__ __forceinline__ void walk(float* xc, const float* pw, int Lc, F f) {
  auto load = [&](int t, float (&v)[kCh8], float (&w)[kCh8]) {
#pragma unroll
    for (int q = 0; q < kCh8 / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(xc + t + 4 * q);
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
    }
#pragma unroll
    for (int u = 0; u < kCh8; ++u) w[u] = pw ? pw[t + u] : 0.f;
  };
  int t = 0;
  if (Lc >= kCh8) {
    float v[kCh8], w[kCh8];
    load(0, v, w);
#pragma unroll 1
    for (; t + kCh8 <= Lc; t += kCh8) {
      float vn[kCh8], wn[kCh8];
      const bool more = t + 2 * kCh8 <= Lc;
      if (more) load(t + kCh8, vn, wn);
#pragma unroll
      for (int u = 0; u < kCh8; ++u) f(v[u], w[u]);
      if (kStore) {
#pragma unroll
        for (int q = 0; q < kCh8 / 4; ++q)
          *reinterpret_cast<float4*>(xc + t + 4 * q) =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
      if (more) {
#pragma unroll
        for (int u = 0; u < kCh8; ++u) v[u] = vn[u], w[u] = wn[u];
      }
    }
  }
  for (; t < Lc; ++t) {
    float v = xc[t];
    f(v, pw ? pw[t] : 0.f);
    if (kStore) xc[t] = v;
  }
}

// the chunk map's one sub-step over d: B = max(d, a*B + ca*d), C = a*C + ca*d
__device__ __forceinline__ void prefix_step(float a, float ca, float d, float& B, float& C) {
  using namespace rt;
  const float cd = mul(ca, d);
  B = max_nan(d, add(mul(a, B), cd));
  C = add(mul(a, C), cd);
}

// the later map (A, B, C) after the earlier (As, Bs, Cs): B = max(B, A*Bs +
// C), C = A*Cs + C, A = A*As
__device__ __forceinline__ void compose(float As, float Bs, float Cs, float& A, float& B,
                                        float& C) {
  using namespace rt;
  const float nB = max_nan(B, add(mul(A, Bs), C));
  C = add(mul(A, Cs), C);
  A = mul(A, As);
  B = nB;
}

// The combine on warp 0: the inclusive Hillis-Steele rounds over the row's
// P chunk maps (sA, sB, sC), lane l holding chunks lE .. lE+E-1 in
// registers, a partner in another lane by __shfl_up_sync; then each chunk's
// carry-in v_in = max(Bp, Ap*v + Cp) from the previous chunk's map (v for
// chunk 0), into sV.
template <int E>
__device__ __forceinline__ void combine_warp(const float* sA, const float* sB,
                                             const float* sC, float* sV, int P, float v) {
  using namespace rt;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float A[E], B[E], C[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = min(lane * E + e, P - 1);
    A[e] = sA[q], B[e] = sB[q], C[e] = sC[q];
  }
  auto apply = [&](int k, float (&As)[E], float (&Bs)[E], float (&Cs)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (lane * E + e >= k) compose(As[e], Bs[e], Cs[e], A[e], B[e], C[e]);
  };
  // offsets k < E: the partner in this lane (e >= k) or the one before
#pragma unroll
  for (int k = 1; k < E; k <<= 1) {
    float As[E], Bs[E], Cs[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int f = e >= k ? e - k : e - k + E;
      const float a = __shfl_up_sync(kAll, A[f], 1), b = __shfl_up_sync(kAll, B[f], 1),
                  c = __shfl_up_sync(kAll, C[f], 1);
      As[e] = e >= k ? A[f] : a, Bs[e] = e >= k ? B[f] : b, Cs[e] = e >= k ? C[f] : c;
    }
    apply(k, As, Bs, Cs);
  }
  // offsets k >= E: the same chunk of the lane k/E before
  for (int k = E; k < P; k <<= 1) {
    float As[E], Bs[E], Cs[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      As[e] = __shfl_up_sync(kAll, A[e], k / E);
      Bs[e] = __shfl_up_sync(kAll, B[e], k / E);
      Cs[e] = __shfl_up_sync(kAll, C[e], k / E);
    }
    apply(k, As, Bs, Cs);
  }
  const float Al = __shfl_up_sync(kAll, A[E - 1], 1), Bl = __shfl_up_sync(kAll, B[E - 1], 1),
              Cl = __shfl_up_sync(kAll, C[E - 1], 1);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = lane * E + e;
    const float Ap = e ? A[e - 1] : Al, Bp = e ? B[e - 1] : Bl, Cp = e ? C[e - 1] : Cl;
    if (q < P) sV[q] = q == 0 ? v : max_nan(Bp, add(mul(Ap, v), Cp));
  }
}

// The row's elements as this thread's share, Q (4: 16 bytes, or 1) at a
// time, kCh8 items of Q in flight: element e = p*Lc + t lives at X[p*ldc +
// t] ((p, t) stepped without a division); first v = load(e, i) for each
// item, then store(e, i, v).
template <int Q, class Load, class Store>
__device__ __forceinline__ void each(int M, int Lc, int ldc, Load load, Store store) {
  using V = std::conditional_t<Q == 4, float4, float>;
  constexpr int kStride = Q * kThreads8;
  const int dp = kStride / Lc, dt = kStride % Lc;
  int p = Q * threadIdx.x / Lc, t = Q * threadIdx.x % Lc;
  for (int e0 = Q * threadIdx.x; e0 < M; e0 += kCh8 * kStride) {
    V v[kCh8];
    int i[kCh8];
#pragma unroll
    for (int u = 0; u < kCh8; ++u) {
      i[u] = p * ldc + t;
      if (e0 + u * kStride < M) v[u] = load(e0 + u * kStride, i[u]);
      p += dp;
      t += dt;
      if (t >= Lc) t -= Lc, ++p;
    }
#pragma unroll
    for (int u = 0; u < kCh8; ++u)
      if (e0 + u * kStride < M) store(e0 + u * kStride, i[u], v[u]);
  }
}

// kStaged: the row's chunks in shared memory (else in the global scratch)
template <bool kStaged>
__global__ void __launch_bounds__(kThreads8)
bma_kernel(const float* __restrict__ x, const float* __restrict__ v0,
           const float* __restrict__ pw, float* __restrict__ y,
           float* scratch, int M, int P) {
  using namespace rt;
  using rt::chain::cp_async16;
  using rt::chain::cp_async4;
  extern __shared__ float4 sh4[];
  __shared__ float sA[kMaxP], sB[kMaxP], sC[kMaxP], sV[kMaxP];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int Lc = M / P, ldc = chunk_ld(Lc);
  float* const sh = reinterpret_cast<float*>(sh4);
  float* const X = kStaged ? sh : scratch + (size_t)r * P * ldc;
  const float* const pws = kStaged ? sh + (size_t)P * ldc : pw;  // the power table
  const float* const xr = x + (size_t)r * M;
  float* const yr = y + (size_t)r * M;
  const bool chain = tid < P;
  // 16 bytes at a time: whole quads of steps in each chunk, aligned rows
  const bool vec = Lc % 4 == 0 && ((unsigned long long)xr & 15) == 0 &&
                   ((unsigned long long)yr & 15) == 0;
  const float a = pw[0];
  const float ca = sub(1.0f, a);
  RT_PHASE(0);

  // loads
  if (kStaged) {
    for (int t = tid; t < Lc; t += kThreads8) cp_async4(sh + (size_t)P * ldc + t, pw + t);
    if (vec)
      each<4>(M, Lc, ldc, [&](int e, int i) { cp_async16(X + i, xr + e); return float4{}; },
              [](int, int, float4) {});
    else
      each<1>(M, Lc, ldc, [&](int e, int i) { cp_async4(X + i, xr + e); return 0.f; },
              [](int, int, float) {});
    rt::chain::cp_async_commit();
    rt::chain::cp_async_wait<0>();
  } else if (vec) {
    each<4>(M, Lc, ldc, [&](int e, int) { return *reinterpret_cast<const float4*>(xr + e); },
            [&](int, int i, float4 v) { *reinterpret_cast<float4*>(X + i) = v; });
  } else {
    each<1>(M, Lc, ldc, [&](int e, int) { return xr[e]; }, [&](int, int i, float v) { X[i] = v; });
  }
  __syncthreads();
  RT_PHASE(1);

  // pass 1: the chunk's map, published for the combine
  float* const xc = X + tid * ldc;
  if (chain) {
    float B = -kBig, C = 0.f;
    walk<false>(xc, nullptr, Lc, [&](float& d, float) { prefix_step(a, ca, d, B, C); });
    sA[tid] = pw[Lc - 1], sB[tid] = B, sC[tid] = C;
  }
  __syncthreads();
  RT_PHASE(2);

  // combine
  if (tid < 32) {
    const float v = v0[r];
    if (P > 64)
      combine_warp<4>(sA, sB, sC, sV, P, v);
    else if (P > 32)
      combine_warp<2>(sA, sB, sC, sV, P, v);
    else
      combine_warp<1>(sA, sB, sC, sV, P, v);
  }
  __syncthreads();
  RT_PHASE(3);

  // pass 2: the chunk's maps again from x, the carry-in applied, y over x
  if (chain) {
    const float v_in = sV[tid];
    float B = -kBig, C = 0.f;
    walk<true>(xc, pws, Lc, [&](float& d, float w) {
      prefix_step(a, ca, d, B, C);
      d = max_nan(B, add(mul(w, v_in), C));
    });
  }
  __syncthreads();
  RT_PHASE(4);

  // stores
  if (vec)
    each<4>(M, Lc, ldc, [&](int, int i) { return *reinterpret_cast<const float4*>(X + i); },
            [&](int e, int, float4 v) { *reinterpret_cast<float4*>(yr + e) = v; });
  else
    each<1>(M, Lc, ldc, [&](int, int i) { return X[i]; }, [&](int e, int, float v) { yr[e] = v; });
  RT_PHASE(5);
}

}  // namespace

// floats of global scratch that rt_blocked_max_affine needs for rows x M in
// chunks of M / P, or 0 where its blocks stage them in shared memory
extern "C" int rt_blocked_max_affine_scratch_floats(int rows, int M, int P) {
  if (P < 1 || M < P) return 0;
  const size_t f = row_floats(M, P);
  return f * sizeof(float) <= kStageMax ? 0 : (int)((f - chunk_ld(M / P)) * rows);
}

extern "C" int rt_blocked_max_affine(const float* x, const float* v0,
                                     const float* pw, float* y,
                                     float* scratch, int rows, int M, int P,
                                     void* stream) {
  if (rows < 1 || rows > 8 || P < 1 || P > kMaxP || (P & (P - 1)) || M % P ||
      M < P)
    return (int)cudaErrorInvalidValue;
  const bool staged = rt_blocked_max_affine_scratch_floats(rows, M, P) == 0;
  if (!staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t shmem = staged ? row_floats(M, P) * sizeof(float) : 0;
  auto kernel = staged ? bma_kernel<true> : bma_kernel<false>;
  if (shmem > 48 * 1024) {  // more than the default needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<rows, kThreads8, shmem, (cudaStream_t)stream>>>(x, v0, pw, y, scratch, M, P);
  return (int)cudaGetLastError();
}

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
//
// The f64 instance (set_float64; the JAX kernel in its input dtype under
// interpret mode, with an f64 power table) is the same kernel on C =
// double: 16-byte pieces of two values (chunk rows of an odd number of
// them), 8-byte cp.async where Lc is odd, every op an f64 op rounded
// alone. A row stages twice the bytes, so its chunks move to the global
// scratch at half the f32 row length (kStageMax counts bytes).
#include <type_traits>

#include "agc_math.cuh"        // max_nan
#include "chain_pipeline.cuh"  // cp_async4, cp_async16

// benches/warp_cycles.py defines this to time the phases (block 0,
// thread 0, after each phase's barrier)
#ifndef RT_PHASE
#define RT_PHASE(k)
#endif

namespace {

constexpr int kThreads8 = 128;  // a block: one row, up to kMaxP chunks
constexpr int kMaxP = 128;
constexpr int kCh8 = 8;         // steps a chunk thread holds at once
constexpr size_t kStageMax = 200 * 1024;  // a row's chunks in shared memory up to this

// values of type C in a 16-byte piece
template <class C>
constexpr int kQ = 16 / (int)sizeof(C);

// A chunk's row stride for chunks of Lc steps: 16-byte rows (so a row
// takes 16-byte copies and loads) of an odd number of 16-byte pieces (so
// the chunk threads of a quarter warp, reading one step's piece each, meet
// distinct banks).
template <class C>
__host__ __device__ inline int chunk_ld(int Lc) {
  return kQ<C> * (((Lc + kQ<C> - 1) / kQ<C>) | 1);
}

// values of a row's staging: its chunks' rows, then the power table (one
// row more)
template <class C>
inline size_t row_elems(int M, int P) { return (size_t)(P + 1) * chunk_ld<C>(M / P); }

// the 16-byte piece at p as values, and back
__device__ __forceinline__ void unpack(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void unpack(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  v[0] = a.x, v[1] = a.y;
}
__device__ __forceinline__ void pack(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// f(v, t, w) on steps t = 0 .. Lc-1 of a chunk's row xc (16-byte aligned),
// v the step's value, w its power (pw[t]; pw null: 0); kCh8 steps held in
// registers, loaded one chunk ahead, and written back from v after f
// (store: y over x)
template <bool kStore, class C, class F>
__device__ __forceinline__ void walk(C* xc, const C* pw, int Lc, F f) {
  constexpr int Q = kQ<C>;
  auto load = [&](int t, C (&v)[kCh8], C (&w)[kCh8]) {
#pragma unroll
    for (int q = 0; q < kCh8 / Q; ++q) unpack(xc + t + Q * q, v + Q * q);
#pragma unroll
    for (int u = 0; u < kCh8; ++u) w[u] = pw ? pw[t + u] : C(0);
  };
  int t = 0;
  if (Lc >= kCh8) {
    C v[kCh8], w[kCh8];
    load(0, v, w);
#pragma unroll 1
    for (; t + kCh8 <= Lc; t += kCh8) {
      C vn[kCh8], wn[kCh8];
      const bool more = t + 2 * kCh8 <= Lc;
      if (more) load(t + kCh8, vn, wn);
#pragma unroll
      for (int u = 0; u < kCh8; ++u) f(v[u], w[u]);
      if (kStore) {
#pragma unroll
        for (int q = 0; q < kCh8 / Q; ++q) pack(xc + t + Q * q, v + Q * q);
      }
      if (more) {
#pragma unroll
        for (int u = 0; u < kCh8; ++u) v[u] = vn[u], w[u] = wn[u];
      }
    }
  }
  for (; t < Lc; ++t) {
    C v = xc[t];
    f(v, pw ? pw[t] : C(0));
    if (kStore) xc[t] = v;
  }
}

// the chunk map's one sub-step over d: B = max(d, a*B + ca*d), C = a*C + ca*d
template <class T>
__device__ __forceinline__ void prefix_step(T a, T ca, T d, T& B, T& C) {
  using namespace rt;
  const T cd = mul(ca, d);
  B = max_nan(d, add(mul(a, B), cd));
  C = add(mul(a, C), cd);
}

// the later map (A, B, C) after the earlier (As, Bs, Cs): B = max(B, A*Bs +
// C), C = A*Cs + C, A = A*As
template <class T>
__device__ __forceinline__ void compose(T As, T Bs, T Cs, T& A, T& B, T& C) {
  using namespace rt;
  const T nB = max_nan(B, add(mul(A, Bs), C));
  C = add(mul(A, Cs), C);
  A = mul(A, As);
  B = nB;
}

// The combine on warp 0: the inclusive Hillis-Steele rounds over the row's
// P chunk maps (sA, sB, sC), lane l holding chunks lE .. lE+E-1 in
// registers, a partner in another lane by __shfl_up_sync; then each chunk's
// carry-in v_in = max(Bp, Ap*v + Cp) from the previous chunk's map (v for
// chunk 0), into sV.
template <int E, class T>
__device__ __forceinline__ void combine_warp(const T* sA, const T* sB,
                                             const T* sC, T* sV, int P, T v) {
  using namespace rt;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  T A[E], B[E], C[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = min(lane * E + e, P - 1);
    A[e] = sA[q], B[e] = sB[q], C[e] = sC[q];
  }
  auto apply = [&](int k, T (&As)[E], T (&Bs)[E], T (&Cs)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (lane * E + e >= k) compose(As[e], Bs[e], Cs[e], A[e], B[e], C[e]);
  };
  // offsets k < E: the partner in this lane (e >= k) or the one before
#pragma unroll
  for (int k = 1; k < E; k <<= 1) {
    T As[E], Bs[E], Cs[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int f = e >= k ? e - k : e - k + E;
      const T a = __shfl_up_sync(kAll, A[f], 1), b = __shfl_up_sync(kAll, B[f], 1),
              c = __shfl_up_sync(kAll, C[f], 1);
      As[e] = e >= k ? A[f] : a, Bs[e] = e >= k ? B[f] : b, Cs[e] = e >= k ? C[f] : c;
    }
    apply(k, As, Bs, Cs);
  }
  // offsets k >= E: the same chunk of the lane k/E before
  for (int k = E; k < P; k <<= 1) {
    T As[E], Bs[E], Cs[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      As[e] = __shfl_up_sync(kAll, A[e], k / E);
      Bs[e] = __shfl_up_sync(kAll, B[e], k / E);
      Cs[e] = __shfl_up_sync(kAll, C[e], k / E);
    }
    apply(k, As, Bs, Cs);
  }
  const T Al = __shfl_up_sync(kAll, A[E - 1], 1), Bl = __shfl_up_sync(kAll, B[E - 1], 1),
          Cl = __shfl_up_sync(kAll, C[E - 1], 1);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int q = lane * E + e;
    const T Ap = e ? A[e - 1] : Al, Bp = e ? B[e - 1] : Bl, Cp = e ? C[e - 1] : Cl;
    if (q < P) sV[q] = q == 0 ? v : max_nan(Bp, add(mul(Ap, v), Cp));
  }
}

// The row's elements as this thread's share, Q (a 16-byte piece V, or 1)
// at a time, kCh8 items of Q in flight: element e = p*Lc + t lives at
// X[p*ldc + t] ((p, t) stepped without a division); first v = load(e, i)
// for each item, then store(e, i, v).
template <class V, int Q, class Load, class Store>
__device__ __forceinline__ void each(int M, int Lc, int ldc, Load load, Store store) {
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

// 4-byte cp.async of an f32, 8-byte of an f64
__device__ __forceinline__ void cp_async_one(float* dst, const float* src) {
  rt::chain::cp_async4(dst, src);
}
__device__ __forceinline__ void cp_async_one(double* dst, const double* src) {
  rt::chain::cp_async8(dst, src);
}

// kStaged: the row's chunks in shared memory (else in the global scratch);
// C: the values' type, f32 or f64
template <bool kStaged, class C>
__global__ void __launch_bounds__(kThreads8)
bma_kernel(const C* __restrict__ x, const C* __restrict__ v0,
           const C* __restrict__ pw, C* __restrict__ y,
           C* scratch, int M, int P) {
  using namespace rt;
  using rt::chain::cp_async16;
  using V = std::conditional_t<std::is_same<C, double>::value, double2, float4>;
  constexpr int Q = kQ<C>;
  constexpr C kBig = C(3.0e38);
  extern __shared__ float4 sh4[];
  __shared__ C sA[kMaxP], sB[kMaxP], sC[kMaxP], sV[kMaxP];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int Lc = M / P, ldc = chunk_ld<C>(Lc);
  C* const sh = reinterpret_cast<C*>(sh4);
  C* const X = kStaged ? sh : scratch + (size_t)r * P * ldc;
  const C* const pws = kStaged ? sh + (size_t)P * ldc : pw;  // the power table
  const C* const xr = x + (size_t)r * M;
  C* const yr = y + (size_t)r * M;
  const bool chain = tid < P;
  // 16 bytes at a time: whole pieces of steps in each chunk, aligned rows
  const bool vec = Lc % Q == 0 && ((unsigned long long)xr & 15) == 0 &&
                   ((unsigned long long)yr & 15) == 0;
  const C a = pw[0];
  const C ca = sub(C(1), a);
  RT_PHASE(0);

  // loads
  if (kStaged) {
    for (int t = tid; t < Lc; t += kThreads8) cp_async_one(sh + (size_t)P * ldc + t, pw + t);
    if (vec)
      each<V, Q>(M, Lc, ldc, [&](int e, int i) { cp_async16(X + i, xr + e); return V{}; },
                 [](int, int, V) {});
    else
      each<C, 1>(M, Lc, ldc, [&](int e, int i) { cp_async_one(X + i, xr + e); return C(0); },
                 [](int, int, C) {});
    rt::chain::cp_async_commit();
    rt::chain::cp_async_wait<0>();
  } else if (vec) {
    each<V, Q>(M, Lc, ldc, [&](int e, int) { return *reinterpret_cast<const V*>(xr + e); },
               [&](int, int i, V v) { *reinterpret_cast<V*>(X + i) = v; });
  } else {
    each<C, 1>(M, Lc, ldc, [&](int e, int) { return xr[e]; }, [&](int, int i, C v) { X[i] = v; });
  }
  __syncthreads();
  RT_PHASE(1);

  // pass 1: the chunk's map, published for the combine
  C* const xc = X + tid * ldc;
  if (chain) {
    C B = -kBig, Cv = C(0);
    walk<false>(xc, (const C*)nullptr, Lc, [&](C& d, C) { prefix_step(a, ca, d, B, Cv); });
    sA[tid] = pw[Lc - 1], sB[tid] = B, sC[tid] = Cv;
  }
  __syncthreads();
  RT_PHASE(2);

  // combine
  if (tid < 32) {
    const C v = v0[r];
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
    const C v_in = sV[tid];
    C B = -kBig, Cv = C(0);
    walk<true>(xc, pws, Lc, [&](C& d, C w) {
      prefix_step(a, ca, d, B, Cv);
      d = max_nan(B, add(mul(w, v_in), Cv));
    });
  }
  __syncthreads();
  RT_PHASE(4);

  // stores
  if (vec)
    each<V, Q>(M, Lc, ldc, [&](int, int i) { return *reinterpret_cast<const V*>(X + i); },
               [&](int e, int, V v) { *reinterpret_cast<V*>(yr + e) = v; });
  else
    each<C, 1>(M, Lc, ldc, [&](int, int i) { return X[i]; }, [&](int e, int, C v) { yr[e] = v; });
  RT_PHASE(5);
}

// values of global scratch for rows x M in chunks of M / P, or 0 where the
// blocks stage them in shared memory (up to kStageMax bytes a row)
template <class C>
int scratch_elems(int rows, int M, int P) {
  if (P < 1 || M < P) return 0;
  const size_t f = row_elems<C>(M, P);
  return f * sizeof(C) <= kStageMax ? 0 : (int)((f - chunk_ld<C>(M / P)) * rows);
}

template <class C>
int blocked_max_affine(const C* x, const C* v0, const C* pw, C* y, C* scratch,
                       int rows, int M, int P, void* stream) {
  if (rows < 1 || rows > 8 || P < 1 || P > kMaxP || (P & (P - 1)) || M % P ||
      M < P)
    return (int)cudaErrorInvalidValue;
  const bool staged = scratch_elems<C>(rows, M, P) == 0;
  if (!staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t shmem = staged ? row_elems<C>(M, P) * sizeof(C) : 0;
  auto kernel = staged ? bma_kernel<true, C> : bma_kernel<false, C>;
  if (shmem > 48 * 1024) {  // more than the default needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<rows, kThreads8, shmem, (cudaStream_t)stream>>>(x, v0, pw, y, scratch, M, P);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of global scratch that rt_blocked_max_affine needs for rows x M in
// chunks of M / P, or 0 where its blocks stage them in shared memory
extern "C" int rt_blocked_max_affine_scratch_floats(int rows, int M, int P) {
  return scratch_elems<float>(rows, M, P);
}

extern "C" int rt_blocked_max_affine(const float* x, const float* v0,
                                     const float* pw, float* y,
                                     float* scratch, int rows, int M, int P,
                                     void* stream) {
  return blocked_max_affine(x, v0, pw, y, scratch, rows, M, P, stream);
}

// K8's f64 instance: the doubles of its global scratch, and the kernel on
// f64 rows, carries and power table
extern "C" int rt_blocked_max_affine_f64_scratch(int rows, int M, int P) {
  return scratch_elems<double>(rows, M, P);
}

extern "C" int rt_blocked_max_affine_f64(const double* x, const double* v0,
                                         const double* pw, double* y,
                                         double* scratch, int rows, int M,
                                         int P, void* stream) {
  return blocked_max_affine(x, v0, pw, y, scratch, rows, M, P, stream);
}

// K9: the streaming-read probe of K1's input (a tool, on no render path).
//
// Replaces benches/dma_roofline.py dma_pass / _dma_kernel, which copies the
// TPU kernel's chunk stream through a `depth`-deep ring of landing slots
// with no compute and sums one landed row per chunk, so that each wait sits
// on the value path. Here the stream is what the port's K1 (fused.cu) reads
// for a block: the time-major PCM rows x [R, L] f32, one block of 32 lanes
// per CUDA block (K1's first layout; it now stages 8 lanes per block), rows
// in tiles of `tr` (~60 input rows per 64 frames at 44.1 -> 48 kHz), in
// time order:
//
//   dma_ring:   each tile copied by cp.async into a ring of D tiles of
//               shared memory, D - 1 tiles ahead; once tile i has landed,
//               out[l] += tile i's first row, lane l (in tile order)
//   stream_max: the same bytes as one contiguous stream over every SM, as
//               an elementwise kernel reads them (by default 4 loads of 16
//               bytes per thread, a block per 16 KB), each block the max
//               of its chunk (order-free, so exact)
//
// What bounds it on the H100: the bytes, 3.35 TB/s. dma_ring keeps D - 1
// tiles of its 32 lanes in flight on each of L / 32 blocks: K1's first
// layout, so its rate is the ceiling of K1's reads as K1 was laid out. stream_max is
// the upper bound of a read on this card. Both report GB/s.
#include "agc_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;   // lanes per block, as K1's first layout
constexpr int kPieces = kLanes / 4;  // 16-byte pieces per tile row
constexpr int kStreamLoads = 4;  // 16-byte loads in flight per thread

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dma_ring_kernel(const float* __restrict__ x, long long R, int L, int tr,
                float* __restrict__ out) {
  extern __shared__ float4 ring[];  // [D][tr][kPieces]
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kLanes;
  const int n_tiles = (int)((R + tr - 1) / tr);
  const int per_tile = tr * kPieces;
  auto issue = [&](int i) {
    if (i < n_tiles) {
      float4* dst = ring + (i % D) * per_tile;
      for (int e = tid; e < per_tile; e += kThreads) {
        const long long row = (long long)i * tr + e / kPieces;
        const int lane = lane0 + (e % kPieces) * 4;
        if (row < R && lane < L) cp_async16(dst + e, x + row * L + lane);
      }
    }
    cp_commit();  // an empty group past the end keeps the count uniform
  };
  for (int i = 0; i < D - 1; ++i) issue(i);
  float acc = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    issue(i + D - 1);
    cp_wait<D - 1>();  // tile i has landed
    __syncthreads();
    if (tid < kLanes)
      acc = rt::add(acc,
                    reinterpret_cast<const float*>(ring + (i % D) * per_tile)[tid]);
    __syncthreads();  // slot i % D is refilled next iteration
  }
  if (tid < kLanes && lane0 + tid < L) out[lane0 + tid] = acc;
}

__global__ void __launch_bounds__(kThreads)
stream_max_kernel(const float4* __restrict__ x, long long n4, long long chunk,
                  float* __restrict__ out) {
  __shared__ float red[kThreads];
  const int tid = threadIdx.x;
  const long long b0 = blockIdx.x * chunk, b1 = min(b0 + chunk, n4);
  float m = __int_as_float(0xff800000);  // -inf
  for (long long base = b0 + tid; base < b1; base += kStreamLoads * kThreads) {
    // the loads of a run first, all in flight together, from clamped
    // addresses: a repeated element leaves a max unchanged
    float4 v[kStreamLoads];
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u)
      v[u] = x[min(base + (long long)u * kThreads, b1 - 1)];
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u)
      m = rt::max_nan(m, rt::max_nan(rt::max_nan(v[u].x, v[u].y),
                                     rt::max_nan(v[u].z, v[u].w)));
  }
  red[tid] = m;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] = rt::max_nan(red[tid], red[tid + w]);
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = red[0];  // -inf for an empty chunk
}

template <int D>
cudaError_t launch_ring(const float* x, long long R, int L, int tr,
                        float* out, cudaStream_t s) {
  const size_t shmem = (size_t)D * tr * kPieces * sizeof(float4);
  dma_ring_kernel<D><<<(L + kLanes - 1) / kLanes, kThreads, shmem, s>>>(
      x, R, L, tr, out);
  return cudaGetLastError();
}

}  // namespace

// out [L]: the sum, in tile order, of the first row of each tile of tr rows
// of x [R, L] (L % 4 == 0, R >= 1, depth 2, 3, 4 or 6, depth * tr * 128
// bytes <= 48 KB)
extern "C" int rt_dma_ring(const float* x, long long R, int L, int tr,
                           int depth, float* out, void* stream) {
  if (R < 1 || L < 4 || L % 4 || tr < 1 ||
      (size_t)depth * tr * kPieces * sizeof(float4) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (depth) {
    case 2: return (int)launch_ring<2>(x, R, L, tr, out, s);
    case 3: return (int)launch_ring<3>(x, R, L, tr, out, s);
    case 4: return (int)launch_ring<4>(x, R, L, tr, out, s);
    case 6: return (int)launch_ring<6>(x, R, L, tr, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out [blocks]: the max of each block's chunk of ceil(n4 / blocks) float4s
extern "C" int rt_stream_max(const float* x, long long n4, int blocks,
                             float* out, void* stream) {
  if (n4 < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const long long chunk = (n4 + blocks - 1) / blocks;
  stream_max_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), n4, chunk, out);
  return (int)cudaGetLastError();
}

// K9: the streaming-read probe of K1's input (a tool, on no render path).
//
// Replaces benches/dma_roofline.py dma_pass / _dma_kernel, which copies the
// TPU kernel's chunk stream through a `depth`-deep ring of landing slots
// with no compute and sums one landed row per chunk, so that each wait sits
// on the value path. Here the stream is what the port's K1 (fused.cu, on
// fused_front.cuh) reads for a block: the time-major PCM rows x [R, L] f32,
// `lanes` lanes per CUDA block (K1's kBL = 8, so 128 blocks for 1024
// lanes), rows in tiles of `tr` (~118 input rows per 128-frame tile at
// 44.1 -> 48 kHz), in time order. out[l] is the sum, in tile order from
// zero, of each tile's first row at lane l.
//
//   rt_dma_ring, route 0 (TMA, K9's row): one producer thread keeps the
//       ring of `depth` slots full with cp.async.bulk.tensor copies of a
//       [tr, lanes] box each, one full mbarrier a slot (arrive.expect_tx);
//       one consumer warp waits on tile i's barrier (phase parity i / depth),
//       adds its row 0 and releases the slot on the slot's empty mbarrier,
//       which the producer waits on before it refills the slot. Rows past R
//       and lanes past L are the copy's out-of-bounds zero fill.
//   rt_dma_ring, route 1 (cp.async, the route K1 takes today): K1's two
//       copy warps copy each tile 16 bytes at a time, depth - 1 tiles ahead,
//       one commit group a tile; K1 runs it at depth 3.
//   rt_stream_max: the same bytes as one contiguous stream, the card's
//       read ceiling: a persistent grid (two blocks an SM) sweeping the
//       buffer in 8 KB pieces, block b taking pieces b, b + G, ... of the
//       grid's G, 8 of them in flight (a 16-byte load of each a thread),
//       each block the max of its pieces (order-free, so exact).
//
// What bounds it on the H100: the bytes, 3.35 TB/s, and the bytes kept in
// flight: Little's law at ~0.7 us of loaded latency asks for ~2 MB across
// the card, ~16 KB on each SM. A TMA ring keeps depth x tr x lanes x 4
// bytes in flight per block for the price of one thread, so depth alone
// sets it (at 8 lanes its rate stops rising at depth 8, 30 KB a block).
// K1's route is bound by how fast its two copy warps issue 16-byte copies,
// not by depth: its rate is the same at every depth, and rises with the
// threads that issue them.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include "agc_math.cuh"

namespace {

constexpr int kMaxLanes = 32;     // one consumer warp holds a block's lanes
constexpr int kMaxBox = 256;      // rows of a TMA box at most
constexpr int kSlotAlign = 128;   // a TMA box lands on 128-byte boundaries
constexpr int kRingThreads = 64;  // warp 0: the producer thread; warp 1: the consumer
constexpr int kCopyThreads = 64;  // K1's two copy warps
constexpr int kStreamPiece = 512;    // float4s of a piece of the stream (8 KB)
constexpr int kStreamThreads = 512;  // a float4 of each piece a thread
constexpr int kStreamLoads = 8;      // pieces in flight a block (64 KB)

using U64 = unsigned long long;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// mbarriers (shared::cta) and the TMA copies that complete on them
__device__ __forceinline__ void mbar_init(U64* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(U64* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(U64* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b))
               : "memory");
}
// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(U64* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// box {c0 (lane), c1 (row)} of the map into dst; completes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            U64* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((U64)map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bytes of a TMA ring slot, and of the ring with its 2 x depth barriers and
// the slack that aligns it (the kernel aligns its dynamic shared memory)
__host__ __device__ inline int tma_slot_bytes(int tr, int lanes) {
  return (tr * lanes * 4 + kSlotAlign - 1) / kSlotAlign * kSlotAlign;
}
__host__ __device__ inline int tma_bar_bytes(int depth) {
  return (2 * depth * 8 + kSlotAlign - 1) / kSlotAlign * kSlotAlign;
}
__host__ __device__ inline size_t tma_ring_bytes(int tr, int lanes, int depth) {
  return (size_t)kSlotAlign + tma_bar_bytes(depth) +
         (size_t)depth * tma_slot_bytes(tr, lanes);
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const unsigned a = smem_addr(p);
  return p + ((kSlotAlign - a % kSlotAlign) % kSlotAlign);
}

__global__ void __launch_bounds__(kRingThreads)
dma_ring_tma_kernel(const __grid_constant__ CUtensorMap map, int n_tiles,
                    int tr, int lanes, int L, int depth,
                    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  U64* full = reinterpret_cast<U64*>(smem);
  U64* empty = full + depth;
  unsigned char* ring = smem + tma_bar_bytes(depth);
  const int slot = tma_slot_bytes(tr, lanes);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive.expect_tx
      mbar_init(&empty[s], 1);  // the consumer warp's release
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int lane0 = blockIdx.x * lanes;
  if (tid == 0) {  // the producer: tile i into slot i % depth
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((U64)&map) : "memory");
    const unsigned bytes = (unsigned)(tr * lanes * 4);  // the box, zero fill included
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % depth;
      if (i >= depth) mbar_wait(&empty[s], (unsigned)(i / depth - 1) & 1u);
      mbar_expect_tx(&full[s], bytes);
      tma_load_2d(ring + (size_t)s * slot, &map, &full[s], lane0, i * tr);
    }
  } else if (tid >= 32) {  // the consumer warp: row 0 of each tile, in order
    const int l = tid - 32;
    float acc = 0.f;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % depth;
      mbar_wait(&full[s], (unsigned)(i / depth) & 1u);
      if (l < lanes)
        acc = rt::add(acc, reinterpret_cast<const float*>(ring + (size_t)s * slot)[l]);
      __syncwarp();
      if (l == 0) mbar_arrive(&empty[s]);
    }
    if (l < lanes && lane0 + l < L) out[lane0 + l] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(kCopyThreads)
dma_ring_cp_kernel(const float* __restrict__ x, long long R, int L, int tr,
                   int lanes, float* __restrict__ out) {
  extern __shared__ float4 ring4[];  // [D][tr][lanes / 4]
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * lanes;
  const int pieces = lanes / 4;
  const int n_tiles = (int)((R + tr - 1) / tr);
  const int per_tile = tr * pieces;
  auto issue = [&](int i) {
    if (i < n_tiles) {
      float4* dst = ring4 + (i % D) * per_tile;
      for (int e = tid; e < per_tile; e += kCopyThreads) {
        const int k = e / pieces, q = e - k * pieces;
        const long long row = (long long)i * tr + k;
        const int lane = lane0 + 4 * q;
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
    if (tid < lanes)
      acc = rt::add(acc, reinterpret_cast<const float*>(ring4 + (i % D) * per_tile)[tid]);
    __syncthreads();  // slot i % D is refilled next iteration
  }
  if (tid < lanes && lane0 + tid < L) out[lane0 + tid] = acc;
}

__global__ void __launch_bounds__(kStreamThreads)
stream_max_kernel(const float4* __restrict__ x, long long n4,
                  float* __restrict__ out) {
  __shared__ float red[kStreamThreads / 32];
  const int tid = threadIdx.x;
  // block b's pieces are b, b + G, b + 2G, ... of the grid's G blocks; a
  // thread loads its float4 of kStreamLoads pieces before it uses any
  const long long step = (long long)gridDim.x * kStreamPiece;
  float m = __int_as_float(0xff800000);  // -inf
  for (long long base = (long long)blockIdx.x * kStreamPiece + tid; base < n4;
       base += kStreamLoads * step) {
    float4 v[kStreamLoads];
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) {
      const long long e = base + u * step;
      v[u] = e < n4 ? x[e] : make_float4(m, m, m, m);
    }
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u)
      m = rt::max_nan(m, rt::max_nan(rt::max_nan(v[u].x, v[u].y),
                                     rt::max_nan(v[u].z, v[u].w)));
  }
  for (int o = 16; o > 0; o >>= 1) m = rt::max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (tid % 32 == 0) red[tid / 32] = m;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kStreamThreads / 32; ++w) m = rt::max_nan(m, red[w]);
    out[blockIdx.x] = m;  // -inf for a block with no piece
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library links against the runtime alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the dynamic shared memory a block of the kernel may have on the current
// device (the opt-in limit less its static shared memory); raises the
// kernel's dynamic limit to it once per device (Key: one per kernel)
template <int Key, class K>
cudaError_t smem_limit(K kernel, int& limit) {
  constexpr int kDevices = 64;
  static int limits[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (limits[dev] == 0) {
    int v = 0;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    v -= (int)fa.sharedSizeBytes;  // the kernel's static shared memory
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, v);
    if (err != cudaSuccess) return err;
    limits[dev] = v;
  }
  limit = limits[dev];
  return cudaSuccess;
}

cudaError_t launch_tma(const float* x, long long R, int L, int tr, int depth,
                       int lanes, float* out, cudaStream_t s) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  int limit = 0;
  cudaError_t err = smem_limit<0>(dma_ring_tma_kernel, limit);
  if (err != cudaSuccess) return err;
  const size_t shmem = tma_ring_bytes(tr, lanes, depth);
  if (shmem > (size_t)limit) return cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)R};
  const cuuint64_t strides[1] = {(cuuint64_t)L * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)lanes, (cuuint32_t)tr};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)x, dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int n_tiles = (int)((R + tr - 1) / tr);
  dma_ring_tma_kernel<<<(L + lanes - 1) / lanes, kRingThreads, shmem, s>>>(
      map, n_tiles, tr, lanes, L, depth, out);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_cp(const float* x, long long R, int L, int tr, int lanes,
                      float* out, cudaStream_t s) {
  int limit = 0;
  cudaError_t err = smem_limit<D>(dma_ring_cp_kernel<D>, limit);
  if (err != cudaSuccess) return err;
  const size_t shmem = (size_t)D * tr * lanes * sizeof(float);
  if (shmem > (size_t)limit) return cudaErrorInvalidValue;
  dma_ring_cp_kernel<D><<<(L + lanes - 1) / lanes, kCopyThreads, shmem, s>>>(
      x, R, L, tr, lanes, out);
  return cudaGetLastError();
}

}  // namespace

// out [L]: the sum, in tile order, of the first row of each tile of tr rows
// of x [R, L], read by blocks of `lanes` lanes through a ring of `depth`
// tiles; route 0 TMA (depth 2 .. 64), route 1 K1's cp.async (depth 2, 3,
// 4, 6, 8, 12, 16, 24 or 32). x 16-byte aligned, L % 4 == 0, lanes % 4 ==
// 0 and 4 <= lanes <= 32, 1 <= tr <= 256, the ring within the opt-in
// shared memory of a block (benches/dma_roofline.py ring_bytes)
extern "C" int rt_dma_ring(const float* x, long long R, int L, int tr,
                           int depth, int lanes, int route, float* out,
                           void* stream) {
  if (R < 1 || R > 0x7fffffffLL || L < 4 || L % 4 || ((U64)x & 15) ||
      lanes < 4 || lanes > kMaxLanes || lanes % 4 || tr < 1 || tr > kMaxBox ||
      depth < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 0)
    return depth > 64 ? (int)cudaErrorInvalidValue
                      : (int)launch_tma(x, R, L, tr, depth, lanes, out, s);
  if (route != 1) return (int)cudaErrorInvalidValue;
  switch (depth) {
    case 2: return (int)launch_cp<2>(x, R, L, tr, lanes, out, s);
    case 3: return (int)launch_cp<3>(x, R, L, tr, lanes, out, s);
    case 4: return (int)launch_cp<4>(x, R, L, tr, lanes, out, s);
    case 6: return (int)launch_cp<6>(x, R, L, tr, lanes, out, s);
    case 8: return (int)launch_cp<8>(x, R, L, tr, lanes, out, s);
    case 12: return (int)launch_cp<12>(x, R, L, tr, lanes, out, s);
    case 16: return (int)launch_cp<16>(x, R, L, tr, lanes, out, s);
    case 24: return (int)launch_cp<24>(x, R, L, tr, lanes, out, s);
    case 32: return (int)launch_cp<32>(x, R, L, tr, lanes, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out [blocks]: the max of block b's pieces b, b + blocks, b + 2 blocks, ...
// of 512 float4s each (x 16-byte aligned)
extern "C" int rt_stream_max(const float* x, long long n4, int blocks,
                             float* out, void* stream) {
  if (n4 < 1 || blocks < 1 || ((U64)x & 15)) return (int)cudaErrorInvalidValue;
  stream_max_kernel<<<blocks, kStreamThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), n4, out);
  return (int)cudaGetLastError();
}

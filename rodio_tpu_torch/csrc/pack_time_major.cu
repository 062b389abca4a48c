// A buffer's PCM onto the card in one pass: the time-major, zero-padded
// layout K1 and K2 read, and the content probe's three flags.
//
// Replaces no Pallas kernel: the JAX package relayouts the PCM in XLA
// (rodio_tpu/flagship.py:454-470, pad + transpose) and probes it with an
// XLA-fused pass (rodio_tpu/flagship.py:91-121). Here SamplesBuffer
// (sources/generators.py) calls it once, for the [C, frames] source it is
// given, with any lane stride and frame stride (a slice of a wider corpus,
// or 1-D interleaved PCM: frame stride C, lane stride 1):
//
//   out[f, l] = src[l, f]  for f < frames,  0  for frames <= f < rows
//
// and, over every value it stores (the zero rows pass each flag), the flags
// of ops/pack.py, each op as torch rounds it on the card (__fmul_rn, rintf,
// __fsub_rn, RNE conversions to bf16, under -ftz=false):
//
//   int16_grid_exact  s = x * 2^15;  s == rint(s)  and  -32768 <= rint(s) <= 32767
//   int24_grid_exact  s = x * 2^23;  s == rint(s)  and  -2^23  <= rint(s) <= 2^23 - 1
//   two_piece_exact   r = x - f32(bf16_rn(x));  r == f32(bf16_rn(r))
//
// What bounds it on the H100: the bytes, each read once and written once.
// A render job's [1024, 470,547] f32 slice (1.927 GB) into [482,835, 1024]
// (1.978 GB) is 3.905 GB: 1.166 ms at 3.35 TB/s. The design:
//
// - a tile is 32 lanes x 32 16-byte vectors of frames (128 frames in f32);
//   a persistent grid (as many 256-thread blocks as fit an SM, times the
//   SMs) walks the tiles lanes first, so the blocks in flight write whole
//   4 KB output rows and read long runs of each lane row;
// - the load: a warp reads a lane row's 32 vectors with 16-byte loads; a
//   row that starts off a 16-byte boundary (a slice at any frame: mis
//   floats past it, the same for every row when the lane stride is a
//   multiple of 4) is read from the boundary before it, one vector more,
//   and the tile is read mis columns to the right. A vector not wholly
//   inside the row is read by its elements, zero outside;
// - shared memory rows of 133 floats (odd): the transposed reads, 4 frames
//   x 8 lane quads a warp, meet 32 banks; each thread stores its vector's
//   4 floats in an order rotated by its quarter of the warp, so the stores
//   meet 32 banks too;
// - the store: 16-byte stores along lanes, a warp writing 4 output rows of
//   128 bytes; the next tile's loads are in flight while this tile's
//   stores issue;
// - the flags: ANDed in registers over the values a thread stores, a
//   warp's __all_sync, one atomicOr a block a failed flag, after the tiles.
//   The fail words are zeroed on the same stream before the launch; the
//   caller's one read-back of them is the probe's only synchronisation.
//
// The f64 instance (set_float64) is the same pass on doubles (16-byte
// vectors of 2, 64-frame tiles) without the flags: the fused pipelines that
// read them refuse f64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;     // lanes of a tile
constexpr int kRowsPerWarp = kLanes / kWarps;

template <class T>
struct Geo {
  static constexpr int kVec = 16 / sizeof(T);     // elements of a 16-byte vector
  static constexpr int kFrames = 32 * kVec;       // frames of a tile
  static constexpr int kStride = kFrames + kVec + 1;  // a shared row, odd
  // output vectors a thread stores a tile: kFrames x kLanes / kVec / kThreads
  static constexpr int kStores = kFrames * kLanes / kVec / kThreads;
};

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const double* p, double (&v)[2]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_vec(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

struct Ok {
  bool g16 = true, g24 = true, tp = true;
};

__device__ __forceinline__ bool on_grid(float x, float scale, float lo, float hi) {
  const float s = __fmul_rn(x, scale);  // exact but for overflow to inf
  const float k = rintf(s);
  return (s == k) & (k >= lo) & (k <= hi);
}

// two_piece_exact of a and b
__device__ __forceinline__ bool two_piece(float a, float b) {
  const float2 p = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  const float ra = __fsub_rn(a, p.x), rb = __fsub_rn(b, p.y);
  const float2 q = __bfloat1622float2(__floats2bfloat162_rn(ra, rb));
  return (ra == q.x) & (rb == q.y);
}

__device__ __forceinline__ void check(const float (&x)[4], Ok& ok) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ok.g16 = ok.g16 & on_grid(x[k], 32768.0f, -32768.0f, 32767.0f);
    ok.g24 = ok.g24 & on_grid(x[k], 8388608.0f, -8388608.0f, 8388607.0f);
  }
  ok.tp = ok.tp & two_piece(x[0], x[1]) & two_piece(x[2], x[3]);
}
__device__ __forceinline__ void check(const double (&)[2], Ok&) {}

// element c of v, c a runtime index (selects, so v stays in registers)
template <class T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int c) {
  T x = v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) x = c == k ? v[k] : x;
  return x;
}

template <class T>
struct Src {
  const T* p;
  int C;
  long long frames, ls, fs;
};

// the float offset of lane l's frame f0 past the 16-byte boundary before it
// (0 unless frames are contiguous: a strided row is read by its elements)
template <class T>
__device__ __forceinline__ int misalign(const Src<T>& s, long long l, long long f0) {
  if (s.fs != 1 || l >= s.C) return 0;
  const unsigned long long e =
      (unsigned long long)(uintptr_t)s.p / sizeof(T) + (unsigned long long)(l * s.ls + f0);
  return (int)(e % Geo<T>::kVec);
}

// the vector of lane l's frames f .. f + kVec - 1: one 16-byte load where
// all lie in the row (f is then on a 16-byte boundary), else element by
// element, zero outside [0, frames) and past the last lane
template <class T>
__device__ __forceinline__ void load_slot(const Src<T>& s, long long l, long long f,
                                          T (&v)[Geo<T>::kVec]) {
  constexpr int V = Geo<T>::kVec;
  if (l >= s.C) {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = T(0);
    return;
  }
  const T* row = s.p + l * s.ls;
  if (s.fs == 1 && f >= 0 && f + V <= s.frames) {
    load_vec(row + f, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long fk = f + k;
    v[k] = fk >= 0 && fk < s.frames ? row[fk * s.fs] : T(0);
  }
}

template <class T>
struct Loads {
  T v[kRowsPerWarp][Geo<T>::kVec];
  T extra[Geo<T>::kVec];  // the window's 33rd vector (rows off a boundary)
  int mis[kRowsPerWarp];
};

// warp w loads lane rows 4w .. 4w+3 of the tile at (l0, f0): vector t of
// each (thread t), and thread j < 4 the 33rd vector of row 4w + j
template <class T>
__device__ __forceinline__ void load_tile(const Src<T>& s, long long l0, long long f0,
                                          int w, int t, Loads<T>& ld) {
  constexpr int V = Geo<T>::kVec;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const long long l = l0 + w * kRowsPerWarp + i;
    ld.mis[i] = misalign(s, l, f0);
    load_slot(s, l, f0 - ld.mis[i] + (long long)V * t, ld.v[i]);
  }
  if (t < kRowsPerWarp) {
    const long long l = l0 + w * kRowsPerWarp + t;
    const int mis = pick(ld.mis, t);
    if (mis) load_slot(s, l, f0 - mis + (long long)V * 32, ld.extra);
  }
}

template <class T, bool kProbe>
__global__ void __launch_bounds__(kThreads)
pack_kernel(Src<T> s, long long rows, T* __restrict__ out, int* __restrict__ fails,
            long long n_lt, long long tiles) {
  using G = Geo<T>;
  constexpr int V = G::kVec;
  constexpr int Q = kLanes / V;  // output vectors of a tile's frame row
  __shared__ T tile[kLanes][G::kStride];
  __shared__ int mis[kLanes];
  __shared__ int failed[3];
  const int tid = threadIdx.x, w = tid / 32, t = tid % 32;
  if (tid < 3) failed[tid] = 0;
  const bool vec_out = s.C % V == 0;
  Ok ok;
  Loads<T> ld;
  long long idx = blockIdx.x;
  if (idx < tiles) load_tile(s, (idx % n_lt) * kLanes, (idx / n_lt) * G::kFrames, w, t, ld);
  for (; idx < tiles; idx += gridDim.x) {
    const long long l0 = (idx % n_lt) * kLanes, f0 = (idx / n_lt) * G::kFrames;
    __syncthreads();  // the last tile's reads are done
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = w * kRowsPerWarp + i;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = (j + t / (32 / V)) % V;  // rotated: 32 banks a store
        tile[r][V * t + c] = pick(ld.v[i], c);
      }
      if (t == 0) mis[r] = ld.mis[i];
    }
    if (t < kRowsPerWarp && pick(ld.mis, t)) {
#pragma unroll
      for (int k = 0; k < V; ++k) tile[w * kRowsPerWarp + t][V * 32 + k] = ld.extra[k];
    }
    __syncthreads();
    const long long next = idx + gridDim.x;
    if (next < tiles)  // in flight while this tile is stored
      load_tile(s, (next % n_lt) * kLanes, (next / n_lt) * G::kFrames, w, t, ld);
#pragma unroll
    for (int i = 0; i < G::kStores; ++i) {
      const int q = t % Q;
      const int fr = (i * kWarps + w) * (32 / Q) + t / Q;
      const long long f = f0 + fr;
      T x[V];
#pragma unroll
      for (int k = 0; k < V; ++k) x[k] = tile[V * q + k][fr + mis[V * q + k]];
      if (kProbe) check(x, ok);
      if (f >= rows) continue;
      const long long l = l0 + V * q;
      T* dst = out + f * s.C + l;
      if (vec_out && l + V <= s.C) {
        store_vec(dst, x);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (l + k < s.C) dst[k] = x[k];
      }
    }
  }
  if (kProbe) {
    // every thread of the block reaches here: the whole warp votes
    const bool all16 = __all_sync(0xffffffffu, ok.g16);
    const bool all24 = __all_sync(0xffffffffu, ok.g24);
    const bool alltp = __all_sync(0xffffffffu, ok.tp);
    if (t == 0) {  // every writer stores the same 1
      if (!all16) failed[0] = 1;
      if (!all24) failed[1] = 1;
      if (!alltp) failed[2] = 1;
    }
    __syncthreads();
    if (tid < 3 && failed[tid]) atomicOr(fails + tid, 1);
  }
}

template <class T, bool kProbe>
int launch(const T* src, int C, long long frames, long long ls, long long fs, long long rows,
           T* out, int* fails, int sms, cudaStream_t stream) {
  using G = Geo<T>;
  if (C < 1 || frames < 0 || rows < frames || ls < 0 || fs < 0 || sms < 1 ||
      ((uintptr_t)src % sizeof(T)) || ((uintptr_t)out % 16))
    return (int)cudaErrorInvalidValue;
  if (kProbe) {
    const cudaError_t err = cudaMemsetAsync(fails, 0, 3 * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (rows == 0) return 0;
  const long long n_lt = (C + kLanes - 1) / kLanes;
  const long long tiles = n_lt * ((rows + G::kFrames - 1) / G::kFrames);
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pack_kernel<T, kProbe>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (tiles < blocks) blocks = tiles;
  pack_kernel<T, kProbe><<<(int)blocks, kThreads, 0, stream>>>(
      Src<T>{src, C, frames, ls, fs}, rows, out, fails, n_lt, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// out [rows, C] (contiguous, 16-byte aligned) <- src [C, frames] at element
// strides (ls, fs), rows >= frames, zero past frames; fails (int32 [3] on
// the card) end 0 where a flag holds over out and 1 where it fails. sms:
// the card's SM count, which sizes the persistent grid
extern "C" int rt_pack_time_major(const float* src, int C, long long frames, long long ls,
                                  long long fs, long long rows, float* out, int* fails,
                                  int sms, void* stream) {
  return launch<float, true>(src, C, frames, ls, fs, rows, out, fails, sms,
                             (cudaStream_t)stream);
}

// the same on doubles, without the flags
extern "C" int rt_pack_time_major_f64(const double* src, int C, long long frames,
                                      long long ls, long long fs, long long rows, double* out,
                                      int sms, void* stream) {
  return launch<double, false>(src, C, frames, ls, fs, rows, out, nullptr, sms,
                               (cudaStream_t)stream);
}

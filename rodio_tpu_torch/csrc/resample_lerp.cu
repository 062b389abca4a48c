// The resampler's weight form over a buffer's PCM in one pass: both taps,
// the lerp, the drain frame and the mask of a block, and the block's
// bookkeeping, from the device scalars of Resample's state.
//
// Replaces no Pallas kernel: the JAX package's weight form is an XLA matmul
// through its lerp operator G0/g1 (rodio_tpu/conversions/resample.py). Here
// Resample (conversions/resample.py) calls it for a block of n output frames
// whose input is a SamplesBuffer, in place of ~35 torch ops (ops/resample.py
// has the same function in PyTorch ops, lerp_block_plain). For output frame
// o = out_o + i, i in [0, n), with phase j = o % to:
//
//   left   = (o / to) * from + (from * j) / to      (= floor(o * from / to))
//   y[c,i] = data[c, start + left] * w0[j] + data[c, start + left + 1] * w1[j]
//
// each product and the sum rounded alone (__fmul_rn, __fadd_rn, as torch's
// mul, mul, add round; -fmad=false besides), a tap outside [0, W) zero.
// The drain rule of drain_bookkeeping, with e = in_end - 2:
//
//   n_full   = #{i : left(o) <= e}: the taps never decrease, and the o >= 0
//              with floor(o * from / to) <= e are the first ceil((e+1)*to/from)
//   drain_ok = n_full < n  and  left(out_o + n_full) == in_end - 1
//   valid    = drained ? 0 : n_full + drain_ok
//   y[c, n_full] = the left tap, unmodified, when drain_ok; y[c, i] = 0 for
//   i >= valid
//
// and the new out_o (out_o + n), valid and drained | drain_ok | valid < n
// are written to fresh 0-dim tensors: nothing is read back to the host, and
// no state tensor is written in place (a saved state may be emitted again).
//
// What bounds it on the H100: the bytes. At 1024 lanes, n = 12800 and
// 44.1 -> 48 kHz (from 147, to 160) a block's taps span, a lane,
// (n - 1) * from / to + 2 = 11,761 frames (48.2 MB in all), and it writes
// [1024, 12800] (52.4 MB): 0.0300 ms at 3.35 TB/s. The design:
//
// - a tile is 8 lanes x 512 output frames (256 in f64), one 256-thread
//   block a tile, so each SM holds eight blocks and their loads in flight;
// - the load: each lane's input window, ceil(512 * from / to) + 2 frames,
//   is staged in shared memory with 16-byte loads along frames, from the
//   16-byte boundary before its first frame (the rows of a [C, W] buffer
//   with W odd start on any float: each row keeps its own offset, as the
//   pack does); a vector not wholly inside [0, W) is read by its elements,
//   zero outside, so no read leaves the buffer;
// - the compute: a thread takes 4 consecutive output frames (2 in f64) and
//   holds their taps' offsets and weights in registers for the 4 lanes it
//   computes (the weights depend on the frame alone); the 2 x `to` weights
//   sit in shared memory (to <= 512; a longer table is read where it lies);
// - the store: 16-byte stores along frames where the block's rows start on
//   16-byte boundaries (n a multiple of 4, 2 in f64), element stores in the
//   other case and at a ragged tail;
// - the bookkeeping: one thread a block computes it from the scalars (a
//   division, no reduction); a tile wholly past `valid` is stored as zeros
//   without reading the buffer.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;    // lanes of a tile
constexpr int kTable = 512;  // phases whose weights are staged in shared memory

template <class T>
struct Geo {
  static constexpr int kVec = 16 / sizeof(T);             // elements of a 16-byte vector
  static constexpr int kFrameVecs = 128;                  // output vectors of a tile row
  static constexpr int kFrames = kFrameVecs * kVec;       // output frames of a tile
  static constexpr int kRowVecs = kFrameVecs + 4;         // input vectors a row holds
  static constexpr int kRow = kRowVecs * kVec;            // input frames a row holds
  static constexpr int kLoads = (kLanes * kRowVecs + kThreads - 1) / kThreads;
  static constexpr int kSubs = kThreads / kFrameVecs;     // lane rows computed at once
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const double* p, double (&v)[2]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// the left tap of output frame o (o >= 0)
__device__ __forceinline__ long long left_of(long long o, int from, int to) {
  return (o / to) * from + ((o % to) * from) / to;
}

struct Args {
  const void* data;  // [C, W] at row stride ls, frames contiguous
  int C;
  long long W, ls;
  void* out;  // [C, n], contiguous
  int n, from, to, nt;  // nt: output frames of a tile (a multiple of the vector)
  const void *w0, *w1;  // [to]
  const long long *out_o, *start, *in_end;
  const bool* drained;
  long long* out_o_new;
  long long* valid_out;
  bool* drained_new;
};

// the block's scalars, computed once by thread 0
struct Tile {
  long long start;  // the input frame of the tile's first left tap
  long long valid, n_full;
  int drain_ok, num0, j0, need;  // need: input frames the tile's taps span
};

template <class T>
__global__ void __launch_bounds__(kThreads)
resample_lerp_kernel(Args a) {
  using G = Geo<T>;
  constexpr int V = G::kVec;
  __shared__ __align__(16) T win[kLanes][G::kRow];
  __shared__ T sw0[kTable], sw1[kTable];
  __shared__ Tile tl;
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * a.nt;
  const int nt = min(a.nt, a.n - i0);
  const long long lane0 = (long long)blockIdx.y * kLanes;
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);

  if (tid == 0) {
    const long long out_o = *a.out_o, in_end = *a.in_end;
    const bool drained = *a.drained;
    const long long e1 = in_end - 1;  // the full lerps' last left tap, plus one
    const long long below = e1 > 0 ? (e1 * a.to + a.from - 1) / a.from : 0;
    const long long n_full = min(max(below - out_o, 0LL), (long long)a.n);
    const bool drain_ok = n_full < a.n && left_of(out_o + n_full, a.from, a.to) == in_end - 1;
    const long long valid = drained ? 0 : n_full + drain_ok;
    const long long o0 = out_o + i0;
    const long long j0 = o0 % a.to, q0 = o0 / a.to;
    const long long jf = j0 * a.from;
    tl.start = *a.start + q0 * a.from + jf / a.to;
    tl.valid = valid;
    tl.n_full = n_full;
    tl.drain_ok = drain_ok;
    tl.num0 = (int)(jf % a.to);
    tl.j0 = (int)j0;
    tl.need = (int)((tl.num0 + (long long)(nt - 1) * a.from) / a.to) + 2;
    if (blockIdx.x == 0 && blockIdx.y == 0) {
      *a.out_o_new = out_o + a.n;
      *a.valid_out = valid;
      *a.drained_new = drained || drain_ok || valid < a.n;
    }
  }
  const bool table = a.to <= kTable;
  if (table) {
    for (int k = tid; k < a.to; k += kThreads) {
      sw0[k] = w0[k];
      sw1[k] = w1[k];
    }
  }
  __syncthreads();
  const long long valid = tl.valid;
  const bool live = i0 < valid;  // a tile wholly past valid reads nothing
  const T* data = static_cast<const T*>(a.data);
  const unsigned long long ebase = (unsigned long long)(uintptr_t)data / sizeof(T);

  // the load: row r holds lane lane0 + r's frames from the 16-byte boundary
  // at or before tl.start, `mis` frames before it
  if (live) {
    T buf[G::kLoads][V];
#pragma unroll
    for (int m = 0; m < G::kLoads; ++m) {
      const int g = tid + m * kThreads;
      const int r = g / G::kRowVecs, v = g % G::kRowVecs;
      const long long l = lane0 + r;
      const int mis = (int)((ebase + l * a.ls + tl.start) % V);
      const bool want = r < kLanes && l < a.C && v * V < mis + tl.need;
      const long long f = tl.start - mis + (long long)V * v;
      if (want && f >= 0 && f + V <= a.W) {
        load_vec(data + l * a.ls + f, buf[m]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          buf[m][k] = want && f + k >= 0 && f + k < a.W ? data[l * a.ls + f + k] : T(0);
      }
    }
#pragma unroll
    for (int m = 0; m < G::kLoads; ++m) {
      const int g = tid + m * kThreads;
      const int r = g / G::kRowVecs, v = g % G::kRowVecs;
      if (r < kLanes) store_vec(&win[r][V * v], buf[m]);
    }
  }
  __syncthreads();

  // the compute: frames k .. k + V - 1 of the tile, lanes sub, sub + kSubs, ..
  const int fv = tid % G::kFrameVecs, sub = tid / G::kFrameVecs;
  const int k = V * fv;
  if (k >= nt) return;
  int rel[V];
  T a0[V], a1[V];
  bool keep[V], drain[V];
  {
    const int num = tl.num0 + k * a.from;  // < to + kFrames * from (checked at launch)
    int r = num / a.to, rem = num - r * a.to;
    int j = (tl.j0 + k) % a.to;
    const int fdiv = a.from / a.to, fmod = a.from % a.to;
    const T* t0 = table ? sw0 : w0;
    const T* t1 = table ? sw1 : w1;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const long long i = i0 + k + e;
      rel[e] = r;
      a0[e] = t0[j];
      a1[e] = t1[j];
      keep[e] = i < valid;
      drain[e] = tl.drain_ok && i == tl.n_full;
      r += fdiv;
      rem += fmod;
      if (rem >= a.to) {
        rem -= a.to;
        ++r;
      }
      if (++j == a.to) j = 0;
    }
  }
  T* out = static_cast<T*>(a.out);
  const bool vec_out = a.n % V == 0 && k + V <= nt;
  for (int rr = sub; rr < kLanes; rr += G::kSubs) {
    const long long l = lane0 + rr;
    if (l >= a.C) break;
    const int mis = (int)((ebase + l * a.ls + tl.start) % V);
    const T* row = &win[rr][mis];
    T y[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (live) {
        const T lv = row[rel[e]], rv = row[rel[e] + 1];
        const T s = add_rn(mul_rn(lv, a0[e]), mul_rn(rv, a1[e]));
        y[e] = keep[e] ? (drain[e] ? lv : s) : T(0);
      } else {
        y[e] = T(0);
      }
    }
    T* dst = out + l * a.n + i0 + k;
    if (vec_out) {
      store_vec(dst, y);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (k + e < nt) dst[e] = y[e];
    }
  }
}

template <class T>
int launch(const T* data, int C, long long W, long long ls, T* out, int n, int from, int to,
           const T* w0, const T* w1, const long long* out_o, const long long* start,
           const long long* in_end, const bool* drained, long long* out_o_new,
           long long* valid, bool* drained_new, cudaStream_t stream) {
  using G = Geo<T>;
  constexpr int V = G::kVec;
  if (C < 1 || W < 1 || ls < W || n < 1 || from < 1 || to < 1 ||
      (long long)to + (long long)G::kFrames * from >= (1LL << 31) ||
      ((uintptr_t)data % sizeof(T)) || ((uintptr_t)out % 16))
    return (int)cudaErrorInvalidValue;
  // the longest tile (a multiple of V) whose taps, from any phase, and the
  // offset to the 16-byte boundary fit a staged row
  int nt = G::kFrames;
  while (nt >= V && ((long long)(to - 1) + (long long)(nt - 1) * from) / to + 2 + (V - 1) >
                        G::kRow)
    nt -= V;
  if (nt < V) return (int)cudaErrorInvalidValue;
  const long long lane_tiles = (C + kLanes - 1) / kLanes;
  if (lane_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + nt - 1) / nt, (unsigned)lane_tiles);
  resample_lerp_kernel<T><<<grid, kThreads, 0, stream>>>(
      Args{data, C, W, ls, out, n, from, to, nt, w0, w1, out_o, start, in_end, drained,
           out_o_new, valid, drained_new});
  return (int)cudaGetLastError();
}

}  // namespace

// out [C, n] (contiguous, 16-byte aligned) <- the weight form over data
// [C, W] (frames contiguous, row stride ls) for the output frames out_o ..
// out_o + n - 1, taps from input frame start on, in_end frames left from it;
// w0, w1 [to]; out_o, start, in_end 0-dim int64 and drained 0-dim bool on
// the card; out_o_new, valid (int64) and drained_new (bool) fresh 0-dim
// tensors the pass writes
extern "C" int rt_resample_lerp(const float* data, int C, long long W, long long ls, float* out,
                                int n, int from, int to, const float* w0, const float* w1,
                                const long long* out_o, const long long* start,
                                const long long* in_end, const bool* drained,
                                long long* out_o_new, long long* valid, bool* drained_new,
                                void* stream) {
  return launch<float>(data, C, W, ls, out, n, from, to, w0, w1, out_o, start, in_end, drained,
                       out_o_new, valid, drained_new, (cudaStream_t)stream);
}

// the same on doubles (set_float64)
extern "C" int rt_resample_lerp_f64(const double* data, int C, long long W, long long ls,
                                    double* out, int n, int from, int to, const double* w0,
                                    const double* w1, const long long* out_o,
                                    const long long* start, const long long* in_end,
                                    const bool* drained, long long* out_o_new, long long* valid,
                                    bool* drained_new, void* stream) {
  return launch<double>(data, C, W, ls, out, n, from, to, w0, w1, out_o, start, in_end, drained,
                        out_o_new, valid, drained_new, (cudaStream_t)stream);
}

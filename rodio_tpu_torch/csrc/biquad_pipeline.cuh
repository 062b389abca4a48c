// The tiled, pipelined per-lane biquad shared by K1 and K4.
//
// A block owns up to 32 lanes and walks time in tiles of kTile steps held
// in shared memory as [t][lane]. Warp 0 runs the DF-I recurrence, one
// thread per lane, carries in registers, writing y over x in place. While
// it works on tile i, warps 1-7 drain tile i-1 (store it, or mix it) and
// fill tile i+1 (load it, or resample it), in a ring of three buffers, so
// the memory traffic hides behind the serial recurrence, which is what
// bounds these kernels: ~3 dependent rounded ops per sample on the y path.
// A fill issues all of a thread's loads into registers before it writes any
// of them to shared memory (batched), so they are in flight together
// rather than one memory latency each.
#pragma once

#include "precise_math.cuh"

namespace rt {

constexpr int kLanes = 32;     // lanes per block: one per thread of warp 0
constexpr int kTile = 64;      // time steps per tile
constexpr int kThreads = 256;  // warp 0 computes, warps 1-7 fill and drain
constexpr int kBufs = 3;

typedef float Tile[kTile][kLanes + 1];  // +1: no bank conflicts on columns

__device__ __forceinline__ int tile_len(long long T, int i) {
  return (int)min((long long)kTile, T - (long long)i * kTile);
}

// Elements e = sub, sub + nsub, ... < total: v = ld(e) for a batch of kBatch
// elements first, then st(e, v) for each. kBatch covers a whole tile per
// filling thread (kLanes * kTile / (kThreads - 32) elements). Neither may
// branch: ld loads raw values from clamped, always-valid addresses, and st
// turns them into the tile's value and stores it, sending an element that
// is out of range to the unused pad column (kLanes). A branch would let the
// compiler sink each load next to its use, one memory latency per element;
// straight-line code lets a batch's loads issue together and wait once.
constexpr int kBatch = (kLanes * kTile + kThreads - 33) / (kThreads - 32);

template <class Ld, class St>
__device__ __forceinline__ void batched(int sub, int nsub, int total, Ld ld,
                                        St st) {
  for (int base = sub; base < total; base += kBatch * nsub) {
    decltype(ld(0)) v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = ld(min(base + u * nsub, total - 1));
#pragma unroll
    for (int u = 0; u < kBatch; ++u) st(base + u * nsub, v[u]);
  }
}

// fill(tile_buf, i, sub_tid, n_sub) writes tile i's inputs;
// drain(tile_buf, i, sub_tid, n_sub) consumes tile i's outputs.
// carry = {x1, x2, y1, y2} of this thread's lane (warp 0, tid < nl).
template <class Fill, class Drain>
__device__ __forceinline__ void biquad_tiles(Tile* bufs, long long T, int nl,
                                             const BiquadCoef& k,
                                             float (&carry)[4], Fill fill,
                                             Drain drain) {
  const int tid = threadIdx.x;
  const int n_tiles = (int)((T + kTile - 1) / kTile);
  if (n_tiles == 0) return;
  fill(bufs[0], 0, tid, kThreads);
  __syncthreads();
  float x1 = carry[0], x2 = carry[1], y1 = carry[2], y2 = carry[3];
  for (int i = 0; i < n_tiles; ++i) {
    if (tid < 32) {
      if (tid < nl) {
        Tile& b = bufs[i % kBufs];
        const int tt = tile_len(T, i);
#pragma unroll 4
        for (int t = 0; t < tt; ++t) {
          const float xt = b[t][tid];
          const float yt = biquad_step(k, xt, x1, x2, y1, y2);
          b[t][tid] = yt;
          x2 = x1;
          x1 = xt;
          y2 = y1;
          y1 = yt;
        }
      }
    } else {
      if (i >= 1) drain(bufs[(i - 1) % kBufs], i - 1, tid - 32, kThreads - 32);
      if (i + 1 < n_tiles) fill(bufs[(i + 1) % kBufs], i + 1, tid - 32, kThreads - 32);
    }
    __syncthreads();
  }
  drain(bufs[(n_tiles - 1) % kBufs], n_tiles - 1, tid, kThreads);
  carry[0] = x1;
  carry[1] = x2;
  carry[2] = y1;
  carry[3] = y2;
}

}  // namespace rt

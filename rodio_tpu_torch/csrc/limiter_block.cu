// K3: the whole stereo master-bus limiter, blocked in time, in one block.
//
// Replaces rodio_tpu/ops/limiter_block.py limiter_master_pallas /
// _limiter_kernel, with the same algorithm and the same rounding order:
//
//   db    = soft-knee gain computer, precise log2       (elementwise)
//   integ = max(db, rel*integ' + (1-rel)*db)             (max-affine scan)
//   peak  = att*peak' + (1-att)*integ                    (linear scan)
//   y     = x * 2^(-0.05*log2(10) * coupled peak)        (elementwise)
//
// Time is cut into P chunks of Lc = T/P rows. One thread per (channel,
// chunk): pass 1 builds the chunk's local prefix maps of the integrator;
// log2 P Hillis-Steele rounds in shared memory compose them across chunks
// (B' = max(Bp, Ap*Bs + Cp), A' = Ap*As, C' = Ap*Cs + Cp); the carry-in
// uses the rel^(t+1) / att^(t+1) tables that the host builds in float64;
// pass 2 does the same for the peak envelope; pass 3 couples the channels
// (ch0 takes ch1's PREVIOUS sample's peak, ch1 both fresh) and applies the
// gain. The carries are taken at the true last sample, t = T-1.
//
// What bounds it on the H100: the elementwise work, ~60-80 instructions a
// sample (the precise log2 with its IEEE divide, the exp2), and the serial
// depth, Lc + log2 P steps per pass; the block is 2 x 12800 samples at the
// main path's shape, so bytes do not matter (100 KB in, 100 KB out).
//
// Design: a cluster of G = min(8, P) blocks of 512 threads, block b owning
// the chunks b*P/G .. (b+1)*P/G - 1 of both channels, so the elementwise
// stages spread over G SMs. Each block runs the dB gain computer over its
// samples, every thread a sample in 512, so the reads are coalesced, a
// batch of loads in flight at a time; it writes d into a per-chunk array
// D[2P/G][Lc | 1] (an odd row stride, so the chunk threads of a scan step
// read distinct banks), in shared memory when it fits (~13 KB at [2, 12800],
// P = 128) and otherwise in a global scratch that the caller allocates
// (rt_limiter_master_scratch_floats). Passes 1 and 2 run on its 2P/G chunk
// threads and read D; pass 2 rebuilds the integrator's local maps from d
// (the same ops, so the same values) instead of keeping them, and writes
// the peak's local prefix over d. After each pass every chunk's map is
// written into every block of the cluster (distributed shared memory), and
// each block composes all 2P of them in the same Hillis-Steele order, so
// every block holds the same carries. Pass 3 is elementwise again, over
// the block's samples: each sample's peaks from its chunk's carry-in and D,
// the coupling, the exp2 and the gain.
//
// The f64 instance (set_float64; the JAX kernel runs in its input dtype
// under interpret mode with f64 power tables, limiter_block.py) is the
// same kernel on C = double: D, the maps and the parameters f64, every op
// an f64 op rounded alone, and the f64 exp2/log2 of precise_math.cuh. D
// takes twice the bytes, so a block's chunks move to the global scratch at
// half the f32 block length (kStageMax counts bytes; at [2, 12800], P =
// 128, D is 26 KB).
#include <cooperative_groups.h>

#include "precise_math.cuh"

namespace {

template <class C>
struct LimParams {
  C att, rel, ca, cr, att_lc, rel_lc;
  C threshold, knee_width, inv_knee_8;
  C log2_to_db, db_to_log2;
};

constexpr int kThreads3 = 512;
constexpr int kMaxW = 256;          // 2P chunks at most
constexpr int kMaxCluster = 8;      // blocks of a cluster (the portable most)
constexpr int kBatch3 = 4;          // loads in flight per thread
constexpr size_t kStageMax = 200 * 1024;  // a block's D in shared memory up to this

// D's row stride for chunks of Lc samples: odd
__host__ __device__ inline int chunk_ld(int Lc) { return Lc | 1; }

inline int cluster_blocks(int P) { return P < kMaxCluster ? P : kMaxCluster; }

// floats of one block's D; it lives in shared memory when they fit in
// kStageMax bytes
inline size_t d_floats(int T, int P) {
  return (size_t)2 * (P / cluster_blocks(P)) * chunk_ld(T / P);
}

// soft-knee gain computer (precise_math.cuh)
template <class C>
__device__ __forceinline__ C gain_db(C x, const LimParams<C>& pr) {
  return rt::soft_knee_db(x, pr.threshold, pr.knee_width, pr.inv_knee_8,
                          pr.log2_to_db);
}

// f(ql, t, xi) for sample t of every local chunk ql < nq of the block
// (x at index(ql, t)), kBatch3 loads of x issued before any is used
template <class C, class Index, class F>
__device__ __forceinline__ void each_sample(const C* __restrict__ x,
                                            int nq, int Lc, Index index, F f) {
  const int nb = nq * Lc;
  for (int base = threadIdx.x; base < nb; base += kThreads3 * kBatch3) {
    int ql[kBatch3], t[kBatch3];
    C v[kBatch3];
#pragma unroll
    for (int u = 0; u < kBatch3; ++u) {
      const int i = min(base + u * kThreads3, nb - 1);
      ql[u] = i / Lc;
      t[u] = i - ql[u] * Lc;
      v[u] = x[index(ql[u], t[u])];
    }
#pragma unroll
    for (int u = 0; u < kBatch3; ++u)
      if (base + u * kThreads3 < nb) f(ql[u], t[u], v[u]);
  }
}

// the inclusive Hillis-Steele combine of every chunk's map within its
// channel, by threads tid < W = 2P, in place in a, b (max-affine; null for
// the linear maps) and cc
template <class C>
__device__ __forceinline__ void combine(C* a, C* b, C* cc, int P) {
  using namespace rt;
  const int tid = threadIdx.x, p = tid % P;
  const bool on = tid < 2 * P;
  C A = on ? a[tid] : C(0), B = on && b ? b[tid] : C(0), Cv = on ? cc[tid] : C(0);
  for (int k = 1; k < P; k <<= 1) {
    C nA = A, nB = B, nC = Cv;
    if (on && p >= k) {
      if (b) nB = maxn(B, add(mul(A, b[tid - k]), Cv));
      nC = add(mul(A, cc[tid - k]), Cv);
      nA = mul(A, a[tid - k]);
    }
    __syncthreads();
    A = nA;
    B = nB;
    Cv = nC;
    if (on) {
      a[tid] = A;
      if (b) b[tid] = B;
      cc[tid] = Cv;
    }
    __syncthreads();
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads3, 1) limiter_master_kernel(
    const C* __restrict__ x, C* __restrict__ y,
    const C* __restrict__ integ0, const C* __restrict__ peak0,
    C* __restrict__ integ_out, C* __restrict__ peak_out,
    const C* __restrict__ relpow, const C* __restrict__ attpow,
    C* scratch, int T, int P, LimParams<C> pr) {
  using namespace rt;
  namespace cg = cooperative_groups;
  constexpr C kBig = C(3.0e38);
  extern __shared__ float4 sh4[];
  __shared__ C sA[kMaxW], sB[kMaxW], sC[kMaxW], tA[kMaxW], tC[kMaxW], sV[kMaxW];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int Pb = P / G, Wb = 2 * Pb;  // chunks of a channel, of the block
  const int Lc = T / P, ldc = chunk_ld(Lc);
  C* D = scratch ? scratch + (size_t)rank * Wb * ldc : reinterpret_cast<C*>(sh4);
  const int tid = threadIdx.x;
  // chain thread tid < Wb: channel c, chunk p of it, q of all 2P
  const bool chain = tid < Wb;
  const int c = tid / Pb, p = rank * Pb + tid % Pb, q = c * P + p;
  C* dq = D + (size_t)tid * ldc;
  // local chunk ql (channel ql / Pb, chunk rank*Pb + ql % Pb) at sample t
  auto x_index = [&](int ql, int t) {
    return (ql / Pb) * T + (rank * Pb + ql % Pb) * Lc + t;
  };
  cluster.sync();  // every block of the cluster runs before any remote write

  // the dB gain computer over the block's samples
  each_sample(x, Wb, Lc, x_index, [&](int ql, int t, C xi) {
    D[(size_t)ql * ldc + t] = gain_db(xi, pr);
  });
  __syncthreads();

  // pass 1: local prefix maps of the integrator (max-affine), written into
  // every block of the cluster
  if (chain) {
    C B = -kBig, Cv = C(0);
    for (int t = 0; t < Lc; ++t) {
      const C d = dq[t], crd = mul(pr.cr, d);
      B = maxn(d, add(mul(pr.rel, B), crd));
      Cv = add(mul(pr.rel, Cv), crd);
    }
    for (int r = 0; r < G; ++r) {
      cluster.map_shared_rank(sA, r)[q] = pr.rel_lc;
      cluster.map_shared_rank(sB, r)[q] = B;
      cluster.map_shared_rank(sC, r)[q] = Cv;
    }
  }
  cluster.sync();
  combine(sA, sB, sC, P);  // integ
  C v_integ = C(0);
  if (chain) {
    const C i0 = integ0[c];
    v_integ = p == 0 ? i0 : maxn(sB[q - 1], add(mul(sA[q - 1], i0), sC[q - 1]));
  }

  // pass 2: the integrator again from d with its carry applied; local maps
  // of the peak envelope (linear), written over d and into every block
  if (chain) {
    C Bt = -kBig, Ct = C(0), integ = C(0), Cp = C(0);
    for (int t = 0; t < Lc; ++t) {
      const C d = dq[t], crd = mul(pr.cr, d);
      Bt = maxn(d, add(mul(pr.rel, Bt), crd));
      Ct = add(mul(pr.rel, Ct), crd);
      integ = maxn(Bt, add(mul(relpow[t], v_integ), Ct));
      Cp = add(mul(pr.att, Cp), mul(pr.ca, integ));
      dq[t] = Cp;
    }
    if (p == P - 1) integ_out[c] = integ;  // the carry at t = T - 1
    for (int r = 0; r < G; ++r) {
      cluster.map_shared_rank(tA, r)[q] = pr.att_lc;
      cluster.map_shared_rank(tC, r)[q] = Cp;
    }
  }
  cluster.sync();  // the last remote access
  combine(tA, (C*)nullptr, tC, P);  // peak
  if (tid < 2 * P) {
    const C p0 = peak0[tid / P];
    sV[tid] = tid % P == 0 ? p0 : add(mul(tA[tid - 1], p0), tC[tid - 1]);
  }
  __syncthreads();

  // pass 3: every sample's peaks of both channels, the stereo coupling (ch0
  // takes ch1's PREVIOUS sample's peak, ch1 both fresh) and the gain
  auto peak_at = [&](int ch, int pl, int t) {  // channel ch, local chunk pl
    return add(mul(attpow[t], sV[ch * P + rank * Pb + pl]),
               D[(size_t)(ch * Pb + pl) * ldc + t]);
  };
  each_sample(x, Wb, Lc, x_index, [&](int ql, int t, C xi) {
    const int pl = ql % Pb;
    const C pk0 = peak_at(0, pl, t);
    const C other = ql >= Pb ? peak_at(1, pl, t)
                                 : t > 0 ? peak_at(1, pl, t - 1)
                                         : sV[P + rank * Pb + pl];
    y[x_index(ql, t)] = mul(xi, exp2_precise(mul(maxn(pk0, other), -pr.db_to_log2)));
  });
  if (rank == G - 1 && tid < 2)  // the carries at t = T - 1
    peak_out[tid] = peak_at(tid, Pb - 1, Lc - 1);
}

// values of global scratch for [2, T] in chunks of T / P, or 0 where the
// blocks stage them in shared memory
template <class C>
int scratch_elems(int T, int P) {
  if (P < 1 || T < P) return 0;
  const size_t f = d_floats(T, P);
  return f * sizeof(C) <= kStageMax ? 0 : (int)(f * cluster_blocks(P));
}

template <class C>
int limiter_master(const C* x, C* y, const C* integ0, const C* peak0,
                   C* integ_out, C* peak_out, const C* relpow,
                   const C* attpow, C* scratch, int T, int P, C att, C rel,
                   C ca, C cr, C att_lc, C rel_lc, C threshold,
                   C knee_width, C inv_knee_8, C log2_to_db, C db_to_log2,
                   void* stream) {
  if (P < 1 || 2 * P > kMaxW || (P & (P - 1)) || T < P || T % P)
    return (int)cudaErrorInvalidValue;
  const bool staged = scratch_elems<C>(T, P) == 0;
  if (!staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const LimParams<C> pr{att,       rel,        ca,         cr,
                        att_lc,    rel_lc,     threshold,  knee_width,
                        inv_knee_8, log2_to_db, db_to_log2};
  const size_t shmem = staged ? d_floats(T, P) * sizeof(C) : 0;
  if (shmem > 48 * 1024) {  // more than the default needs opting in
    const cudaError_t err = cudaFuncSetAttribute(
        limiter_master_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = cluster_blocks(P);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(kThreads3);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  C* scr = staged ? nullptr : scratch;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, limiter_master_kernel<C>, x, y, integ0, peak0, integ_out, peak_out,
      relpow, attpow, scr, T, P, pr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// floats of global scratch that rt_limiter_master needs for [2, T] in
// chunks of T / P, or 0 where its blocks stage them in shared memory
extern "C" int rt_limiter_master_scratch_floats(int T, int P) {
  return scratch_elems<float>(T, P);
}

extern "C" int rt_limiter_master(
    const float* x, float* y, const float* integ0, const float* peak0,
    float* integ_out, float* peak_out, const float* relpow,
    const float* attpow, float* scratch, int T, int P, float att, float rel,
    float ca, float cr, float att_lc, float rel_lc, float threshold,
    float knee_width, float inv_knee_8, float log2_to_db, float db_to_log2,
    void* stream) {
  return limiter_master(x, y, integ0, peak0, integ_out, peak_out, relpow, attpow,
                        scratch, T, P, att, rel, ca, cr, att_lc, rel_lc, threshold,
                        knee_width, inv_knee_8, log2_to_db, db_to_log2, stream);
}

// K3's f64 instance: the doubles of its global scratch, and the kernel on
// f64 samples, carries, power tables and parameters
extern "C" int rt_limiter_master_f64_scratch(int T, int P) {
  return scratch_elems<double>(T, P);
}

extern "C" int rt_limiter_master_f64(
    const double* x, double* y, const double* integ0, const double* peak0,
    double* integ_out, double* peak_out, const double* relpow,
    const double* attpow, double* scratch, int T, int P, double att,
    double rel, double ca, double cr, double att_lc, double rel_lc,
    double threshold, double knee_width, double inv_knee_8,
    double log2_to_db, double db_to_log2, void* stream) {
  return limiter_master(x, y, integ0, peak0, integ_out, peak_out, relpow, attpow,
                        scratch, T, P, att, rel, ca, cr, att_lc, rel_lc, threshold,
                        knee_width, inv_knee_8, log2_to_db, db_to_log2, stream);
}

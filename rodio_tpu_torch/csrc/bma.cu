// K8: y_t = max(x_t, a*y_{t-1} + (1-a)*x_t) over <= 8 rows, blocked in time.
//
// Replaces rodio_tpu/ops/limiter_block.py blocked_max_affine_const /
// _bma_kernel: the AGC's instant-attack, slow-release peak detector
// (src/source/agc.rs:397-407) on its decomposed path. The TPU kernel's
// blocked order is kept step for step: time is cut into P chunks of
// Lc = M/P; one thread per (row, chunk) builds the chunk's local prefix
// maps (B = max(d, a*B + (1-a)*d), C = a*C + (1-a)*d); log2 P
// Hillis-Steele rounds in shared memory compose them across the chunks of
// a row (B' = max(Bp, Ap*Bs + Cp), C' = Ap*Cs + Cp, A' = Ap*As); the
// carry-in v_in then gives y = max(B_t, a^(t+1)*v_in + C_t). The power
// table a^(t+1) is the caller's (one table for the kernel and its plain
// version), and a = pow[0], a^Lc = pow[Lc-1], so a live release knob is
// data.
//
// What bounds it on the H100: the serial depth Lc + log2 P (64 + 7 on the
// AGC's [1, 8192] block at P = 128), on one block of rows*P <= 1024
// threads; bytes are few. The prefix rows (2 x Lc x rows*P floats) live in
// a global scratch read side by side, and stay in L2 (as K3's).
#include "precise_math.cuh"

namespace {

constexpr float kBig = 3.0e38f;

__global__ void bma_kernel(const float* __restrict__ x,
                           const float* __restrict__ v0,
                           const float* __restrict__ pw,
                           float* __restrict__ y, float* __restrict__ scratch,
                           int M, int P) {
  using namespace rt;
  extern __shared__ float sh[];
  const int W = blockDim.x;  // rows * P
  float* sA = sh;
  float* sB = sh + W;
  float* sC = sh + 2 * W;
  const int tid = threadIdx.x;
  const int r = tid / P, p = tid % P;
  const int Lc = M / P;
  float* b_scr = scratch;
  float* c_scr = scratch + (size_t)Lc * W;
  const float* xc = x + (size_t)r * M + (size_t)p * Lc;
  const float a = pw[0];
  const float ca = sub(1.0f, a);

  // pass 1: local prefix maps of the chunk
  float B = -kBig, Cv = 0.0f;
  for (int t = 0; t < Lc; ++t) {
    const float d = xc[t];
    B = maxn(d, add(mul(a, B), mul(ca, d)));
    Cv = add(mul(a, Cv), mul(ca, d));
    b_scr[(size_t)t * W + tid] = B;
    c_scr[(size_t)t * W + tid] = Cv;
  }

  // chunk combine: inclusive Hillis-Steele within the row
  float A = pw[Lc - 1];
  sA[tid] = A;
  sB[tid] = B;
  sC[tid] = Cv;
  __syncthreads();
  for (int k = 1; k < P; k <<= 1) {
    float nA = A, nB = B, nC = Cv;
    if (p >= k) {
      const float As = sA[tid - k], Bs = sB[tid - k], Cs = sC[tid - k];
      nB = maxn(B, add(mul(A, Bs), Cv));
      nC = add(mul(A, Cs), Cv);
      nA = mul(A, As);
    }
    __syncthreads();
    A = nA;
    B = nB;
    Cv = nC;
    sA[tid] = A;
    sB[tid] = B;
    sC[tid] = Cv;
    __syncthreads();
  }
  const float vr = v0[r];
  const float v_in =
      p == 0 ? vr : maxn(sB[tid - 1], add(mul(sA[tid - 1], vr), sC[tid - 1]));

  // pass 2: the carry-in applied
  float* yc = y + (size_t)r * M + (size_t)p * Lc;
  for (int t = 0; t < Lc; ++t) {
    const size_t i = (size_t)t * W + tid;
    yc[t] = maxn(b_scr[i], add(mul(pw[t], v_in), c_scr[i]));
  }
}

}  // namespace

extern "C" int rt_blocked_max_affine(const float* x, const float* v0,
                                     const float* pw, float* y,
                                     float* scratch, int rows, int M, int P,
                                     void* stream) {
  if (rows < 1 || rows > 8 || P < 1 || P > 128 || (P & (P - 1)) || M % P ||
      M < P)
    return (int)cudaErrorInvalidValue;
  const int threads = rows * P;
  const size_t shmem = 3 * threads * sizeof(float);
  bma_kernel<<<1, threads, shmem, (cudaStream_t)stream>>>(x, v0, pw, y,
                                                          scratch, M, P);
  return (int)cudaGetLastError();
}

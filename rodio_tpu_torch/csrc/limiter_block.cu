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
// What bounds it on the H100: the serial depth, Lc + log2 P steps per
// pass, and the precise log2/exp2 per sample; the block is 2 x 12800
// samples, so bytes do not matter. One block of 2P <= 256 threads runs it
// on one SM; the prefix rows (3 x Lc x 2P floats) live in a global scratch
// that the rows of a step read side by side, and stay in L2.
#include "precise_math.cuh"

namespace {

struct LimParams {
  float att, rel, ca, cr, att_lc, rel_lc;
  float threshold, knee_width, inv_knee_8;
  float log2_to_db, db_to_log2;
};

constexpr float kBig = 3.0e38f;

// soft-knee gain computer (rodio_tpu/effects/limit.py limiter_gain_db)
__device__ __forceinline__ float gain_db(float x, const LimParams& pr) {
  using namespace rt;
  const float bias = sub(mul(log2_precise(add(fabsf(x), TINY)), pr.log2_to_db),
                         pr.threshold);
  const float kb = mul(bias, 2.0f);
  const float xk = add(kb, pr.knee_width);
  const float quad = mul(mul(xk, xk), pr.inv_knee_8);
  return kb < -pr.knee_width ? 0.0f
                             : (fabsf(kb) <= pr.knee_width ? quad : bias);
}

__global__ void limiter_master_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const float* __restrict__ integ0, const float* __restrict__ peak0,
    float* __restrict__ integ_out, float* __restrict__ peak_out,
    const float* __restrict__ relpow, const float* __restrict__ attpow,
    float* __restrict__ scratch, int T, int P, LimParams pr) {
  using namespace rt;
  extern __shared__ float sh[];
  const int W = 2 * P;
  float* sA = sh;
  float* sB = sh + W;
  float* sC = sh + 2 * W;
  float* sV = sh + 3 * W;
  const int tid = threadIdx.x;
  const int c = tid / P, p = tid % P;
  const int Lc = T / P;
  float* b_scr = scratch;
  float* c_scr = scratch + (size_t)Lc * W;
  float* cp_scr = scratch + (size_t)2 * Lc * W;
  const float* xc = x + (size_t)c * T + (size_t)p * Lc;

  // pass 1: local prefix maps of the integrator (max-affine)
  float B = -kBig, Cv = 0.0f;
  for (int t = 0; t < Lc; ++t) {
    const float d = gain_db(xc[t], pr);
    B = maxn(d, add(mul(pr.rel, B), mul(pr.cr, d)));
    Cv = add(mul(pr.rel, Cv), mul(pr.cr, d));
    b_scr[(size_t)t * W + tid] = B;
    c_scr[(size_t)t * W + tid] = Cv;
  }

  // chunk combine (integ): inclusive Hillis-Steele within the channel
  float A = pr.rel_lc;
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
  const float i0 = integ0[c];
  const float v_integ =
      p == 0 ? i0 : maxn(sB[tid - 1], add(mul(sA[tid - 1], i0), sC[tid - 1]));
  __syncthreads();

  // pass 2: integ carry applied; local maps of the peak envelope (linear)
  float Cp = 0.0f;
  for (int t = 0; t < Lc; ++t) {
    const size_t r = (size_t)t * W + tid;
    const float integ = maxn(b_scr[r], add(mul(relpow[t], v_integ), c_scr[r]));
    Cp = add(mul(pr.att, Cp), mul(pr.ca, integ));
    cp_scr[r] = Cp;
  }

  // chunk combine (peak)
  float A2 = pr.att_lc, C2 = Cp;
  sA[tid] = A2;
  sC[tid] = C2;
  __syncthreads();
  for (int k = 1; k < P; k <<= 1) {
    float nA = A2, nC = C2;
    if (p >= k) {
      nC = add(mul(A2, sC[tid - k]), C2);
      nA = mul(A2, sA[tid - k]);
    }
    __syncthreads();
    A2 = nA;
    C2 = nC;
    sA[tid] = A2;
    sC[tid] = C2;
    __syncthreads();
  }
  const float p0 = peak0[c];
  sV[tid] = p == 0 ? p0 : add(mul(sA[tid - 1], p0), sC[tid - 1]);
  __syncthreads();

  // pass 3: peaks of both channels, stereo coupling, gain
  const float vp0 = sV[p], vp1 = sV[P + p];
  float prev1 = vp1, pk0 = 0.0f, pk1 = 0.0f;
  float* yc = y + (size_t)c * T + (size_t)p * Lc;
  for (int t = 0; t < Lc; ++t) {
    const size_t r = (size_t)t * W;
    pk0 = add(mul(attpow[t], vp0), cp_scr[r + p]);
    pk1 = add(mul(attpow[t], vp1), cp_scr[r + P + p]);
    const float mp = c == 0 ? maxn(pk0, prev1) : maxn(pk0, pk1);
    yc[t] = mul(xc[t], exp2_precise(mul(mp, -pr.db_to_log2)));
    prev1 = pk1;
  }
  if (p == P - 1) {  // carries at t = T - 1
    const size_t r = (size_t)(Lc - 1) * W + tid;
    integ_out[c] =
        maxn(b_scr[r], add(mul(relpow[Lc - 1], v_integ), c_scr[r]));
    peak_out[c] = c == 0 ? pk0 : pk1;
  }
}

}  // namespace

extern "C" int rt_limiter_master(
    const float* x, float* y, const float* integ0, const float* peak0,
    float* integ_out, float* peak_out, const float* relpow,
    const float* attpow, float* scratch, int T, int P, float att, float rel,
    float ca, float cr, float att_lc, float rel_lc, float threshold,
    float knee_width, float inv_knee_8, float log2_to_db, float db_to_log2,
    void* stream) {
  const LimParams pr{att,       rel,        ca,         cr,
                     att_lc,    rel_lc,     threshold,  knee_width,
                     inv_knee_8, log2_to_db, db_to_log2};
  const int threads = 2 * P;
  const size_t shmem = 4 * threads * sizeof(float);
  limiter_master_kernel<<<1, threads, shmem, (cudaStream_t)stream>>>(
      x, y, integ0, peak0, integ_out, peak_out, relpow, attpow, scratch, T, P,
      pr);
  return (int)cudaGetLastError();
}

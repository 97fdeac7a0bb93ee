// K3: transducer alpha recursion, forward.
//
// Replaces rnnt_tpu/ops/lattice_pallas.py:120 _alpha_kernel (launcher
// _alpha_pallas:170): alpha[t, u] = LSE(alpha[t-1, u] + lp_blank[t-1, u],
// alpha[t, u-1] + lp_label[t, u-1]) with alpha[0, 0] = 0, written for every
// (t, u), and nll[b] = -(alpha + lp_blank) at (t_len - 1, u_len).
//
// What bounds it on an H100: latency, not bytes.  At (B 4, T 504, U 65) it
// moves ~1.6 MB (~0.5 us at 3.35 TB/s) but has 504 dependent rows, each a
// scan over U in the (LSE, +) semiring.  Design: one warp per sample, no
// shared memory and no __syncthreads.  Each lane owns KPL consecutive
// columns; a row is (1) each lane composing the affine maps
// x -> LSE(c[u], x + e[u]) of its columns sequentially, (2) a 5-round
// shuffle scan of those composites across the warp, (3) each lane
// replaying its columns from the incoming value.  The next row's inputs
// are loaded into registers while the current row computes, hiding the
// memory latency behind the scan.
//
// Log-zero is the finite NEG = -1e30 and the LSE is unguarded, as in the
// Pallas kernel: when both sides are log-zero the result stays ~NEG, and
// sums of up to U NEGs stay far inside float range.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b);
  return m + logf(expf(a - m) + expf(b - m));
}

template <int KPL>
__device__ __forceinline__ void load_row(const float* __restrict__ lpb,
                                         const float* __restrict__ lpl,
                                         int t, int U, int u0, float* cb,
                                         float* ce) {
  const float* rb = lpb + (size_t)t * U;
  const float* rl = lpl + (size_t)t * U;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int u = u0 + j;
    cb[j] = u < U ? rb[u] : 0.f;
    ce[j] = (u >= 1 && u < U) ? rl[u - 1] : NEG;  // e[u] = lp_label[t, u-1]
  }
}

template <int KPL>
__global__ void __launch_bounds__(32)
alpha_fwd_kernel(const float* __restrict__ lp_blank,
                 const float* __restrict__ lp_label,
                 const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                 float* __restrict__ alpha, float* __restrict__ nll, int T,
                 int U) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int u0 = lane * KPL;
  const size_t base = (size_t)b * T * U;
  const float* lpb = lp_blank + base;
  const float* lpl = lp_label + base;
  float* out = alpha + base;
  const int t_last = t_lens[b] - 1;
  const int u_last = u_lens[b];

  float carry[KPL];        // alpha[t-1, u] + lp_blank[t-1, u]
  float cb[KPL], ce[KPL];  // this row's lp_blank[t, u] and e[u]
  float ll = 0.f;
  load_row<KPL>(lpb, lpl, 0, U, u0, cb, ce);

  for (int t = 0; t < T; ++t) {
    float nb[KPL], ne[KPL];
    if (t + 1 < T) load_row<KPL>(lpb, lpl, t + 1, U, u0, nb, ne);

    float c[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      c[j] = t == 0 ? (u0 + j == 0 ? 0.f : NEG) : carry[j];

    // (1) this lane's composite map (A, bv): x -> LSE(x + A, bv).
    float A = 0.f, bv = NEG;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      if (u0 + j < U) {
        bv = lse(bv + ce[j], c[j]);
        A += ce[j];
      }
    }
    // (2) inclusive scan of the composites over lanes: left (A1, b1) then
    // right (A2, b2) is (A1 + A2, LSE(b1 + A2, b2)).
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float A_l = __shfl_up_sync(FULL, A, off);
      const float b_l = __shfl_up_sync(FULL, bv, off);
      if (lane >= off) {
        bv = lse(b_l + A, bv);
        A = A_l + A;
      }
    }
    // alpha[t, u0 - 1]: the lanes to the left applied to log-zero (column
    // 0 takes nothing from the left, so their composite's bv is the value).
    float a = __shfl_up_sync(FULL, bv, 1);
    if (lane == 0) a = NEG;

    // (3) replay this lane's columns from the incoming value.
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int u = u0 + j;
      if (u < U) {
        a = lse(c[j], a + ce[j]);
        out[(size_t)t * U + u] = a;
        carry[j] = a + cb[j];
        if (t == t_last && u == u_last) ll = carry[j];
      }
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      cb[j] = nb[j];
      ce[j] = ne[j];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ll += __shfl_xor_sync(FULL, ll, off);
  if (lane == 0) nll[b] = -ll;
}

template <int KPL>
cudaError_t launch(const float* lpb, const float* lpl, const int* tl,
                   const int* ul, float* alpha, float* nll, int B, int T,
                   int U, cudaStream_t stream) {
  alpha_fwd_kernel<KPL><<<B, 32, 0, stream>>>(lpb, lpl, tl, ul, alpha, nll,
                                              T, U);
  return cudaGetLastError();
}

}  // namespace

// lp_blank, lp_label, alpha: (B, T, U) float32 contiguous; t_lens, u_lens
// (B,) int32 with 1 <= t_len <= T and 0 <= u_len < U; nll (B,) float32.
// U <= 1024.  Returns cudaGetLastError() after the launch.
extern "C" int rnnt_alpha_fwd(const void* lp_blank, const void* lp_label,
                              const void* t_lens, const void* u_lens,
                              void* alpha, void* nll, int B, int T, int U,
                              void* stream) {
  if (B <= 0 || T <= 0 || U <= 0) return 0;
  const float* lpb = static_cast<const float*>(lp_blank);
  const float* lpl = static_cast<const float*>(lp_label);
  const int* tl = static_cast<const int*>(t_lens);
  const int* ul = static_cast<const int*>(u_lens);
  float* a = static_cast<float*>(alpha);
  float* n = static_cast<float*>(nll);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_lane = (U + 31) / 32;
  cudaError_t err;
  if (per_lane <= 1) err = launch<1>(lpb, lpl, tl, ul, a, n, B, T, U, s);
  else if (per_lane <= 2) err = launch<2>(lpb, lpl, tl, ul, a, n, B, T, U, s);
  else if (per_lane <= 4) err = launch<4>(lpb, lpl, tl, ul, a, n, B, T, U, s);
  else if (per_lane <= 8) err = launch<8>(lpb, lpl, tl, ul, a, n, B, T, U, s);
  else if (per_lane <= 16) err = launch<16>(lpb, lpl, tl, ul, a, n, B, T, U, s);
  else if (per_lane <= 32) err = launch<32>(lpb, lpl, tl, ul, a, n, B, T, U, s);
  else return (int)cudaErrorInvalidValue;
  return (int)err;
}

// K4: transducer beta recursion and the lattice gradients (backward of K3).
//
// Replaces rnnt_tpu/ops/lattice_pallas.py:353 _beta_kernel (launcher
// _beta_pallas:397, call :408).  For each sample, rows t = t_len-1 down to 0:
//   beta_next[u] = (t == t_len-1) ? (u == u_len ? 0 : NEG) : beta[t+1, u]
//   beta[t, u]   = LSE(lp_blank[t, u] + beta_next[u],
//                      lp_label[t, u] + beta[t, u+1]),   beta[t, U] = NEG
//   glpb[t, u] = -g * exp(alpha[t, u] + lp_blank[t, u] + beta_next[u] - ll)
//   glpl[t, u] = -g * exp(alpha[t, u] + lp_label[t, u] + beta[t, u+1] - ll)
// with ll = -nll.  Rows t >= t_len get zero gradients: the Pallas kernel
// masks the exponent there (padded rows hold finite junk whose exp could
// overflow); here those rows are never read, only zero-filled.
//
// What bounds it on an H100: bytes in principle — it reads lp_blank,
// lp_label and alpha and writes two gradients, 5 x 4 bytes per cell:
// 2.6 MB at (B 4, T 504, U 65), 0.78 us at 3.35 TB/s; 20.6 MB at the long
// case (4, 1000, 257), 6.1 us.  As with K3 the real limit is the latency of
// t_len dependent rows.  Design: K3's in reverse.  One warp per sample, no
// shared memory, no __syncthreads.  Each lane owns KPL consecutive columns;
// a row is (1) each lane composing the affine maps
// x -> LSE(d[u], e[u] + x) of its columns right to left, (2) a 5-round
// __shfl_down_sync suffix scan of the composites (the combine of
// _suffix_row_scan, lattice_pallas.py:98-115), (3) each lane replaying its
// columns from the value entering from its right, writing both gradients.
// The next row (t - 1: lp_blank, lp_label, alpha) is loaded into registers
// while the current row computes.
//
// Log-zero is the finite NEG = -1e30 and the LSE is unguarded, as in the
// Pallas kernel and in K3.

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
                                         const float* __restrict__ alpha,
                                         int t, int U, int u0, float* cb,
                                         float* ce, float* ca) {
  const size_t o = (size_t)t * U;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int u = u0 + j;
    const bool in = u < U;
    cb[j] = in ? lpb[o + u] : 0.f;
    ce[j] = in ? lpl[o + u] : NEG;
    ca[j] = in ? alpha[o + u] : NEG;
  }
}

template <int KPL>
__global__ void __launch_bounds__(32)
beta_bwd_kernel(const float* __restrict__ lp_blank,
                const float* __restrict__ lp_label,
                const float* __restrict__ alpha,
                const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                const float* __restrict__ nll, const float* __restrict__ g,
                float* __restrict__ glpb, float* __restrict__ glpl, int T,
                int U) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int u0 = lane * KPL;
  const size_t base = (size_t)b * T * U;
  const float* lpb = lp_blank + base;
  const float* lpl = lp_label + base;
  const float* al = alpha + base;
  float* ob = glpb + base;
  float* ol = glpl + base;
  const int t_len = min(max(t_lens[b], 0), T);
  const int u_len = u_lens[b];
  const float ll = -nll[b];
  const float gb = g[b];

  for (size_t i = (size_t)t_len * U + lane; i < (size_t)T * U; i += 32) {
    ob[i] = 0.f;
    ol[i] = 0.f;
  }
  if (t_len == 0) return;

  float next[KPL];         // beta_next[u]: the seed, then beta[t + 1]
  float cb[KPL], ce[KPL], ca[KPL];  // this row's lp_blank, lp_label, alpha
#pragma unroll
  for (int j = 0; j < KPL; ++j) next[j] = u0 + j == u_len ? 0.f : NEG;
  load_row<KPL>(lpb, lpl, al, t_len - 1, U, u0, cb, ce, ca);

  for (int t = t_len - 1; t >= 0; --t) {
    float nb[KPL], ne[KPL], na[KPL];
    if (t > 0) load_row<KPL>(lpb, lpl, al, t - 1, U, u0, nb, ne, na);

    float d[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) d[j] = cb[j] + next[j];

    // (1) this lane's composite (A, bv): x -> LSE(x + A, bv), its columns
    // applied right to left starting from the identity (0, NEG).
    float A = 0.f, bv = NEG;
#pragma unroll
    for (int j = KPL - 1; j >= 0; --j) {
      if (u0 + j < U) {
        bv = lse(d[j], ce[j] + bv);
        A += ce[j];
      }
    }
    // (2) inclusive suffix scan over lanes: mine (A1, b1) after the lanes
    // to the right (A2, b2) is (A1 + A2, LSE(b1, A1 + b2)).
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float A_r = __shfl_down_sync(FULL, A, off);
      const float b_r = __shfl_down_sync(FULL, bv, off);
      if (lane + off < 32) {
        bv = lse(bv, A + b_r);
        A = A + A_r;
      }
    }
    // beta[t, u0 + KPL]: the lanes to the right applied to beta[t, U] = NEG.
    float x = __shfl_down_sync(FULL, bv, 1);
    if (lane == 31) x = NEG;

    // (3) replay this lane's columns right to left; x is beta[t, u + 1].
    float* rb = ob + (size_t)t * U;
    float* rl = ol + (size_t)t * U;
#pragma unroll
    for (int j = KPL - 1; j >= 0; --j) {
      const int u = u0 + j;
      if (u < U) {
        rl[u] = -gb * expf(ca[j] + ce[j] + x - ll);
        rb[u] = -gb * expf(ca[j] + cb[j] + next[j] - ll);
        x = lse(d[j], ce[j] + x);
        next[j] = x;
      }
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      cb[j] = nb[j];
      ce[j] = ne[j];
      ca[j] = na[j];
    }
  }
}

template <int KPL>
cudaError_t launch(const float* lpb, const float* lpl, const float* al,
                   const int* tl, const int* ul, const float* nll,
                   const float* g, float* glpb, float* glpl, int B, int T,
                   int U, cudaStream_t stream) {
  beta_bwd_kernel<KPL><<<B, 32, 0, stream>>>(lpb, lpl, al, tl, ul, nll, g,
                                             glpb, glpl, T, U);
  return cudaGetLastError();
}

}  // namespace

// lp_blank, lp_label, alpha, glpb, glpl: (B, T, U) float32 contiguous;
// t_lens, u_lens (B,) int32 with 1 <= t_len <= T and 0 <= u_len < U; nll
// and g (B,) float32.  U <= 1024.  Returns cudaGetLastError() after the
// launch.
extern "C" int rnnt_beta_bwd(const void* lp_blank, const void* lp_label,
                             const void* alpha, const void* t_lens,
                             const void* u_lens, const void* nll,
                             const void* g, void* glpb, void* glpl, int B,
                             int T, int U, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0) return 0;
  const float* lpb = static_cast<const float*>(lp_blank);
  const float* lpl = static_cast<const float*>(lp_label);
  const float* al = static_cast<const float*>(alpha);
  const int* tl = static_cast<const int*>(t_lens);
  const int* ul = static_cast<const int*>(u_lens);
  const float* n = static_cast<const float*>(nll);
  const float* gg = static_cast<const float*>(g);
  float* ob = static_cast<float*>(glpb);
  float* ol = static_cast<float*>(glpl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_lane = (U + 31) / 32;
  cudaError_t err;
  if (per_lane <= 1) err = launch<1>(lpb, lpl, al, tl, ul, n, gg, ob, ol, B, T, U, s);
  else if (per_lane <= 2) err = launch<2>(lpb, lpl, al, tl, ul, n, gg, ob, ol, B, T, U, s);
  else if (per_lane <= 4) err = launch<4>(lpb, lpl, al, tl, ul, n, gg, ob, ol, B, T, U, s);
  else if (per_lane <= 8) err = launch<8>(lpb, lpl, al, tl, ul, n, gg, ob, ol, B, T, U, s);
  else if (per_lane <= 16) err = launch<16>(lpb, lpl, al, tl, ul, n, gg, ob, ol, B, T, U, s);
  else if (per_lane <= 32) err = launch<32>(lpb, lpl, al, tl, ul, n, gg, ob, ol, B, T, U, s);
  else return (int)cudaErrorInvalidValue;
  return (int)err;
}

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
// a row is the __shfl_down_sync suffix scan of lattice_rows.cuh (beta_row:
// the combine of _suffix_row_scan, lattice_pallas.py:98-115), each lane
// writing both gradients as it replays its columns.  The next row (t - 1:
// lp_blank, lp_label, alpha) is loaded into registers while the current row
// computes.

#include "lattice_rows.cuh"

namespace {

using lattice::NEG;

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
  lattice::load_beta_row<KPL>(lpb, lpl, al, t_len - 1, U, u0, cb, ce, ca);

  for (int t = t_len - 1; t >= 0; --t) {
    float nb[KPL], ne[KPL], na[KPL];
    if (t > 0) lattice::load_beta_row<KPL>(lpb, lpl, al, t - 1, U, u0, nb, ne, na);

    float d[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) d[j] = cb[j] + next[j];

    float* rb = ob + (size_t)t * U;
    float* rl = ol + (size_t)t * U;
    lattice::beta_row<KPL>(d, ce, u0, U, lane, [&](int j, float up, float beta) {
      const int u = u0 + j;
      rl[u] = -gb * expf(ca[j] + ce[j] + up - ll);
      rb[u] = -gb * expf(ca[j] + cb[j] + next[j] - ll);
      next[j] = beta;
    });
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      cb[j] = nb[j];
      ce[j] = ne[j];
      ca[j] = na[j];
    }
  }
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
  return lattice::dispatch_kpl(U, [&](auto kpl) {
    beta_bwd_kernel<decltype(kpl)::value>
        <<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(lp_blank),
            static_cast<const float*>(lp_label),
            static_cast<const float*>(alpha), static_cast<const int*>(t_lens),
            static_cast<const int*>(u_lens), static_cast<const float*>(nll),
            static_cast<const float*>(g), static_cast<float*>(glpb),
            static_cast<float*>(glpl), T, U);
    return cudaGetLastError();
  });
}

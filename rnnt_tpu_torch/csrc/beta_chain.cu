// K7: the beta recursion and the lattice gradients on one T-shard (the
// chain's backward stage).
//
// Replaces rnnt_tpu/ops/lattice_pallas.py:272 _beta_chain_kernel (launcher
// _beta_chain_pallas:321, call :335).  It computes what K4 computes, on
// local rows r = T-1 down to 0 that sit at global rows t = t0 + r:
//   beta_next[u] = (t == t_len-1) ? (u == u_len ? 0 : NEG) : beta[r+1, u]
//   beta[r, u]   = LSE(lp_blank[r, u] + beta_next[u],
//                      lp_label[r, u] + beta[r, u+1]),   beta[r, U] = NEG
//   glpb[r, u] = -g * exp(alpha[r, u] + lp_blank[r, u] + beta_next[u] - ll)
//   glpl[r, u] = -g * exp(alpha[r, u] + lp_label[r, u] + beta[r, u+1] - ll)
// where beta[T, u] is carry_in, the next shard's carry_out, and ll is the
// log-likelihood (minus the NLL).  Rows at global t >= t_len get zero
// gradients (the reference masks the exponent there, :298-309); here they
// are zero-filled and never read.  carry_out is beta at the shard's first
// row, the previous shard's beta_next; for a sample whose t_len <= t0 no
// row of the shard is live and carry_out is NEG (the previous shard seeds
// its own row t_len - 1 and never reads it).
//
// What bounds it on an H100: latency, as for K4.  At one shard of the eval
// lattice (B 4, T 252, U 65) it reads three and writes two (B, T, U) float32
// arrays, ~1.3 MB (~0.4 us at 3.35 TB/s), but runs up to 252 dependent
// rows.  Design: K4's, row for row (one warp per sample, lattice_rows.cuh's
// beta_row, the next row prefetched into registers), starting from the
// seed or the carry at the shard's last live row.

#include "lattice_rows.cuh"

namespace {

using lattice::NEG;

template <int KPL>
__global__ void __launch_bounds__(32)
beta_chain_kernel(const float* __restrict__ lp_blank,
                  const float* __restrict__ lp_label,
                  const float* __restrict__ alpha,
                  const int* __restrict__ t_lens,
                  const int* __restrict__ u_lens,
                  const float* __restrict__ ll_in, const float* __restrict__ g,
                  const float* __restrict__ carry_in,
                  float* __restrict__ glpb, float* __restrict__ glpl,
                  float* __restrict__ carry_out, int T, int U, int t0) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int u0 = lane * KPL;
  const size_t base = (size_t)b * T * U;
  const float* lpb = lp_blank + base;
  const float* lpl = lp_label + base;
  const float* al = alpha + base;
  float* ob = glpb + base;
  float* ol = glpl + base;
  const int t_len = t_lens[b];
  const int r_end = min(max(t_len - t0, 0), T);  // live rows: r < r_end
  const int u_len = u_lens[b];
  const float ll = ll_in[b];
  const float gb = g[b];

  for (size_t i = (size_t)r_end * U + lane; i < (size_t)T * U; i += 32) {
    ob[i] = 0.f;
    ol[i] = 0.f;
  }
  float next[KPL];  // beta_next[u]: the seed or the carry, then beta[r + 1]
  const bool seeded = t0 + r_end == t_len;  // the shard holds row t_len - 1
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int u = u0 + j;
    next[j] = seeded ? (u == u_len ? 0.f : NEG)
                     : (u < U ? carry_in[(size_t)b * U + u] : NEG);
  }
  if (r_end == 0) {
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      if (u0 + j < U) carry_out[(size_t)b * U + u0 + j] = NEG;
    return;
  }

  float cb[KPL], ce[KPL], ca[KPL];  // this row's lp_blank, lp_label, alpha
  lattice::load_beta_row<KPL>(lpb, lpl, al, r_end - 1, U, u0, cb, ce, ca);
  for (int r = r_end - 1; r >= 0; --r) {
    float nb[KPL], ne[KPL], na[KPL];
    if (r > 0) lattice::load_beta_row<KPL>(lpb, lpl, al, r - 1, U, u0, nb, ne, na);

    float d[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) d[j] = cb[j] + next[j];

    float* rb = ob + (size_t)r * U;
    float* rl = ol + (size_t)r * U;
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
#pragma unroll
  for (int j = 0; j < KPL; ++j)
    if (u0 + j < U) carry_out[(size_t)b * U + u0 + j] = next[j];
}

}  // namespace

// lp_blank, lp_label, alpha, glpb, glpl: (B, T, U) float32 contiguous, the
// shard's rows (global rows t0 .. t0 + T - 1); t_lens, u_lens (B,) int32
// with t_len >= 1 and 0 <= u_len < U; ll (the log-likelihood) and g (B,)
// float32; carry_in, carry_out (B, U) float32; t0 >= 0.  U <= 1024.
// Returns cudaGetLastError() after the launch.
extern "C" int rnnt_beta_chain(const void* lp_blank, const void* lp_label,
                               const void* alpha, const void* t_lens,
                               const void* u_lens, const void* ll,
                               const void* g, const void* carry_in,
                               void* glpb, void* glpl, void* carry_out, int B,
                               int T, int U, int t0, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0) return 0;
  return lattice::dispatch_kpl(U, [&](auto kpl) {
    beta_chain_kernel<decltype(kpl)::value>
        <<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(lp_blank),
            static_cast<const float*>(lp_label),
            static_cast<const float*>(alpha), static_cast<const int*>(t_lens),
            static_cast<const int*>(u_lens), static_cast<const float*>(ll),
            static_cast<const float*>(g), static_cast<const float*>(carry_in),
            static_cast<float*>(glpb), static_cast<float*>(glpl),
            static_cast<float*>(carry_out), T, U, t0);
    return cudaGetLastError();
  });
}

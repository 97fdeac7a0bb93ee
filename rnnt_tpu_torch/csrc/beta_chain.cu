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
// arrays, ~1.3 MB (~0.4 us at 3.35 TB/s); its critical path is r_end + U - 1
// dependent LSEs, r_end = clamp(t_len - t0, 0, T) the shard's live rows.
// Design: K4's sweep (lattice_wave.cuh, beta_sweep<KPL, true>) over the
// live rows, its bnext registers starting from the seed where the shard
// holds row t_len - 1 and from carry_in elsewhere, and stored to carry_out
// after the last diagonal.

#include "lattice_wave.cuh"

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
  return lattice::launch_beta<true>(lp_blank, lp_label, alpha, t_lens, u_lens, ll, g,
                                    carry_in, glpb, glpl, carry_out, B, T, U, t0, stream);
}

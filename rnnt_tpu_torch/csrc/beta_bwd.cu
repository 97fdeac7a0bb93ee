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
// case (4, 1000, 257), 6.1 us.  The real limit is the critical path of
// t_len + U - 1 dependent LSEs.  Design: the beta sweep of lattice_wave.cuh
// (beta_sweep<KPL, false>), K3's wavefront mirrored: the block sweeps the
// diagonals d = (t_len-1) + (U-1) down to 0, one LSE and one barrier a
// diagonal, lp_blank, lp_label and alpha staged through the ring (196,608
// bytes at U = 1024).  K7 (beta_chain.cu) is the same sweep on one T-shard.

#include "lattice_wave.cuh"

// lp_blank, lp_label, alpha, glpb, glpl: (B, T, U) float32 contiguous;
// t_lens, u_lens (B,) int32 with 1 <= t_len <= T and 0 <= u_len < U; nll
// and g (B,) float32.  U <= 1024.  Returns cudaGetLastError() after the
// launch.
extern "C" int rnnt_beta_bwd(const void* lp_blank, const void* lp_label,
                             const void* alpha, const void* t_lens,
                             const void* u_lens, const void* nll,
                             const void* g, void* glpb, void* glpl, int B,
                             int T, int U, void* stream) {
  return lattice::launch_beta<false>(lp_blank, lp_label, alpha, t_lens, u_lens, nll, g,
                                     nullptr, glpb, glpl, nullptr, B, T, U, 0, stream);
}

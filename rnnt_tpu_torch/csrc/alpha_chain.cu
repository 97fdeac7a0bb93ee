// K6: the alpha recursion on one T-shard of the lattice (the chain's
// forward stage).
//
// Replaces rnnt_tpu/ops/lattice_pallas.py:204 _alpha_chain_kernel (launcher
// _alpha_chain_pallas:247, call :256), the building block of the
// sequence-parallel lattice (ops/lattice_tshard.py).  It computes what K3
// computes, on local rows r = 0 .. T-1 that sit at global rows t = t0 + r:
//   c[u]        = (t == 0) ? (u == 0 ? 0 : NEG) : carry[u]
//   alpha[r, u] = LSE(c[u], alpha[r, u-1] + lp_label[r, u-1])
//   carry[u]    = alpha[r, u] + lp_blank[r, u]
// where the carry entering row 0 is carry_in, the previous shard's
// carry_out.  carry_out is the carry after the shard's last row, and
// ll_part[b] = (alpha + lp_blank) at (t_len - 1, u_len) when this shard
// holds global row t_len - 1, else 0 (the reference's llmask summed over U).
//
// What bounds it on an H100: latency, as for K3.  At one shard of the eval
// lattice (B 4, T 252, U 65) it moves ~0.8 MB (~0.24 us at 3.35 TB/s); its
// critical path is T + U - 1 = 316 dependent LSEs.  Design: K3's sweep
// (lattice_wave.cuh, alpha_sweep<KPL, true>), its carry registers starting
// from carry_in (the seed at t0 = 0) and stored to carry_out after the
// last diagonal.

#include "lattice_wave.cuh"

// lp_blank, lp_label, alpha: (B, T, U) float32 contiguous, the shard's rows
// (global rows t0 .. t0 + T - 1); t_lens, u_lens (B,) int32 with t_len >= 1
// and 0 <= u_len < U; carry_in, carry_out (B, U) float32; ll_part (B,)
// float32; t0 >= 0.  U <= 1024.  Returns cudaGetLastError() after the launch.
extern "C" int rnnt_alpha_chain(const void* lp_blank, const void* lp_label,
                                const void* t_lens, const void* u_lens,
                                const void* carry_in, void* alpha,
                                void* ll_part, void* carry_out, int B, int T,
                                int U, int t0, void* stream) {
  return lattice::launch_alpha<true>(lp_blank, lp_label, t_lens, u_lens, carry_in, alpha,
                                     ll_part, carry_out, B, T, U, t0, stream);
}

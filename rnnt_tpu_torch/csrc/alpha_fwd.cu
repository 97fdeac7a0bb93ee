// K3: transducer alpha recursion, forward.
//
// Replaces rnnt_tpu/ops/lattice_pallas.py:120 _alpha_kernel (launcher
// _alpha_pallas:170): alpha[t, u] = LSE(alpha[t-1, u] + lp_blank[t-1, u],
// alpha[t, u-1] + lp_label[t, u-1]) with alpha[0, 0] = 0, written for every
// (t, u) including rows t >= t_len, and nll[b] = -(alpha + lp_blank) at
// (t_len - 1, u_len).  Log-zero is the finite NEG and the LSE unguarded
// (lattice_wave.cuh).
//
// What bounds it on an H100: latency, not bytes.  At (B 4, T 504, U 65) it
// moves ~1.6 MB (~0.5 us at 3.35 TB/s); its critical path is T + U - 1 =
// 568 dependent LSEs (1,256 at (4, 1000, 257)).  Design: the alpha sweep of
// lattice_wave.cuh (alpha_sweep<KPL, false>), an anti-diagonal wavefront:
// one block per sample, a compute lane per column and a loader warp per
// compute warp; one LSE, one shuffle and one barrier a diagonal.  K6
// (alpha_chain.cu) is the same sweep on one T-shard.
//
// Also here: rnnt_lse_chain, a one-warp chain of dependent LSEs that
// chip_smoke.py times for the critical-path bound (the latency of one
// diagonal's LSE on the card).

#include "lattice_wave.cuh"

namespace {

__global__ void __launch_bounds__(32)
lse_chain_kernel(float a, float b, int n, float* __restrict__ out) {
  float x = threadIdx.x * 1e-3f;
  for (int i = 0; i < n; ++i) x = lattice::lse_wave(x + a, b);
  out[threadIdx.x] = x;
}

}  // namespace

// lp_blank, lp_label, alpha: (B, T, U) float32 contiguous; t_lens, u_lens
// (B,) int32 with 1 <= t_len <= T and 0 <= u_len < U; nll (B,) float32.
// U <= 1024.  Returns cudaGetLastError() after the launch.
extern "C" int rnnt_alpha_fwd(const void* lp_blank, const void* lp_label,
                              const void* t_lens, const void* u_lens,
                              void* alpha, void* nll, int B, int T, int U,
                              void* stream) {
  return lattice::launch_alpha<false>(lp_blank, lp_label, t_lens, u_lens, nullptr, alpha,
                                      nll, nullptr, B, T, U, 0, stream);
}

// One warp, n dependent steps x = lse(x + a, b); out (32,) float32.
extern "C" int rnnt_lse_chain(float a, float b, int n, void* out, void* stream) {
  lse_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

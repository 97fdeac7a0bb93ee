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
// lattice (B 4, T 252, U 65) it moves ~0.8 MB (~0.24 us at 3.35 TB/s) but
// runs 252 dependent rows, each a shuffle scan over U.  Design: K3's, row
// for row (one warp per sample, lattice_rows.cuh's alpha_row, the next row
// prefetched into registers), with the seed tested at the global row and
// the carry loaded from and stored to (B, U) rows.

#include "lattice_rows.cuh"

namespace {

using lattice::NEG;

template <int KPL>
__global__ void __launch_bounds__(32)
alpha_chain_kernel(const float* __restrict__ lp_blank,
                   const float* __restrict__ lp_label,
                   const int* __restrict__ t_lens,
                   const int* __restrict__ u_lens,
                   const float* __restrict__ carry_in,
                   float* __restrict__ alpha, float* __restrict__ ll_part,
                   float* __restrict__ carry_out, int T, int U, int t0) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int u0 = lane * KPL;
  const size_t base = (size_t)b * T * U;
  const float* lpb = lp_blank + base;
  const float* lpl = lp_label + base;
  float* out = alpha + base;
  const int t_last = t_lens[b] - 1;
  const int u_last = u_lens[b];

  float carry[KPL];        // alpha[r-1, u] + lp_blank[r-1, u]
  float cb[KPL], ce[KPL];  // this row's lp_blank[r, u] and e[u]
#pragma unroll
  for (int j = 0; j < KPL; ++j)
    carry[j] = u0 + j < U ? carry_in[(size_t)b * U + u0 + j] : NEG;
  float ll = 0.f;
  lattice::load_alpha_row<KPL>(lpb, lpl, 0, U, u0, cb, ce);

  for (int r = 0; r < T; ++r) {
    const int t = t0 + r;
    float nb[KPL], ne[KPL];
    if (r + 1 < T) lattice::load_alpha_row<KPL>(lpb, lpl, r + 1, U, u0, nb, ne);

    float c[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      c[j] = t == 0 ? (u0 + j == 0 ? 0.f : NEG) : carry[j];

    lattice::alpha_row<KPL>(c, ce, u0, U, lane, [&](int j, float a) {
      const int u = u0 + j;
      out[(size_t)r * U + u] = a;
      carry[j] = a + cb[j];
      if (t == t_last && u == u_last) ll = carry[j];
    });
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      cb[j] = nb[j];
      ce[j] = ne[j];
    }
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j)
    if (u0 + j < U) carry_out[(size_t)b * U + u0 + j] = carry[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ll += __shfl_xor_sync(lattice::FULL, ll, off);
  if (lane == 0) ll_part[b] = ll;
}

}  // namespace

// lp_blank, lp_label, alpha: (B, T, U) float32 contiguous, the shard's rows
// (global rows t0 .. t0 + T - 1); t_lens, u_lens (B,) int32 with t_len >= 1
// and 0 <= u_len < U; carry_in, carry_out (B, U) float32; ll_part (B,)
// float32; t0 >= 0.  U <= 1024.  Returns cudaGetLastError() after the launch.
extern "C" int rnnt_alpha_chain(const void* lp_blank, const void* lp_label,
                                const void* t_lens, const void* u_lens,
                                const void* carry_in, void* alpha,
                                void* ll_part, void* carry_out, int B, int T,
                                int U, int t0, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0) return 0;
  return lattice::dispatch_kpl(U, [&](auto kpl) {
    alpha_chain_kernel<decltype(kpl)::value>
        <<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(lp_blank),
            static_cast<const float*>(lp_label),
            static_cast<const int*>(t_lens), static_cast<const int*>(u_lens),
            static_cast<const float*>(carry_in), static_cast<float*>(alpha),
            static_cast<float*>(ll_part), static_cast<float*>(carry_out), T, U,
            t0);
    return cudaGetLastError();
  });
}

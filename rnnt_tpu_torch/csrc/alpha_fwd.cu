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
// columns; a row is the shuffle scan of lattice_rows.cuh (alpha_row), shared
// with K4, K6 and K7.  The next row's inputs are loaded into registers while
// the current row computes, hiding the memory latency behind the scan.

#include "lattice_rows.cuh"

namespace {

using lattice::NEG;

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
  lattice::load_alpha_row<KPL>(lpb, lpl, 0, U, u0, cb, ce);

  for (int t = 0; t < T; ++t) {
    float nb[KPL], ne[KPL];
    if (t + 1 < T) lattice::load_alpha_row<KPL>(lpb, lpl, t + 1, U, u0, nb, ne);

    float c[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      c[j] = t == 0 ? (u0 + j == 0 ? 0.f : NEG) : carry[j];

    lattice::alpha_row<KPL>(c, ce, u0, U, lane, [&](int j, float a) {
      const int u = u0 + j;
      out[(size_t)t * U + u] = a;
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
  for (int off = 16; off > 0; off >>= 1)
    ll += __shfl_xor_sync(lattice::FULL, ll, off);
  if (lane == 0) nll[b] = -ll;
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
  return lattice::dispatch_kpl(U, [&](auto kpl) {
    alpha_fwd_kernel<decltype(kpl)::value>
        <<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(lp_blank),
            static_cast<const float*>(lp_label),
            static_cast<const int*>(t_lens), static_cast<const int*>(u_lens),
            static_cast<float*>(alpha), static_cast<float*>(nll), T, U);
    return cudaGetLastError();
  });
}

// K3: transducer alpha recursion, forward.
//
// Replaces rnnt_tpu/ops/lattice_pallas.py:120 _alpha_kernel (launcher
// _alpha_pallas:170): alpha[t, u] = LSE(alpha[t-1, u] + lp_blank[t-1, u],
// alpha[t, u-1] + lp_label[t, u-1]) with alpha[0, 0] = 0, written for every
// (t, u) including rows t >= t_len, and nll[b] = -(alpha + lp_blank) at
// (t_len - 1, u_len).  Log-zero is the finite NEG and the LSE unguarded
// (lattice_rows.cuh).
//
// What bounds it on an H100: latency, not bytes.  At (B 4, T 504, U 65) it
// moves ~1.6 MB (~0.5 us at 3.35 TB/s); its critical path is T + U - 1 =
// 568 dependent LSEs (1,256 at (4, 1000, 257)).  Design: the anti-diagonal
// wavefront of lattice_wave.cuh, one block per sample, a compute lane per
// column and a loader warp per compute warp; one LSE, one shuffle and one
// barrier a diagonal.  Lane u keeps carry = alpha[t-1, u] + lp_blank[t-1, u]
// in a register (the seed alpha[0, 0] = 0 before row 0) and takes
// x = alpha[t, u-1] + lp_label[t, u-1] from its left neighbour.  lp_blank
// and lp_label arrive through the strip-wise cp.async ring; alpha
// overwrites lp_blank's slot and goes back to global memory a strip row at
// a time.  The LSE is lattice::lse_wave (__expf/__logf; its error is in
// lattice_wave.cuh).
//
// Also here: rnnt_lse_chain, a one-warp chain of dependent LSEs that
// chip_smoke.py times for the critical-path bound (the latency of one
// diagonal's LSE on the card).

#include <climits>

#include "lattice_wave.cuh"

namespace {

using lattice::NEG;
using lattice::PREFETCH;
using lattice::RING;
using lattice::STRIP;

template <int KPL>
__global__ void __launch_bounds__(1024)
alpha_fwd_kernel(const float* __restrict__ lp_blank,
                 const float* __restrict__ lp_label,
                 const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                 float* __restrict__ alpha, float* __restrict__ nll, int T,
                 int U, int nw) {
  extern __shared__ float smem[];
  const unsigned row_bytes = 4u * nw * 32 * KPL;  // one ring row, all columns
  // Shared addresses: ring_b holds lp_blank, then alpha; ring_l lp_label;
  // xch [2][nw] each warp's last x.  Column c of ring row k is at
  // ring + k * row_bytes + 4 c.
  const unsigned ring_b = lattice::smem_addr(smem);
  const unsigned ring_l = ring_b + RING * row_bytes;
  const unsigned xch = ring_l + RING * row_bytes;
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const size_t base = (size_t)b * T * U;
  const int d_end = T - 1 + (U - 1) / STRIP * STRIP + STRIP;  // last write back
  auto ring_row = [&](int row) { return (unsigned)(row & (RING - 1)) * row_bytes; };

  if (w >= nw) {
    // Loader warp: loads the row each strip of compute warp w - nw reaches
    // PREFETCH diagonals on.
    for (int d = -PREFETCH; d <= d_end; ++d) {
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int c = (w - nw) * 32 * KPL + 32 * j + lane;
        const int r = d + PREFETCH - c / STRIP * STRIP;
        const bool load = c < U && (unsigned)r < (unsigned)T;
        const size_t o = base + (size_t)min(max(r, 0), T - 1) * U + min(c, U - 1);
        const unsigned k = ring_row(r) + 4u * c;
        lattice::cp_async4_if(load, ring_b + k, lp_blank + o);
        lattice::cp_async4_if(load, ring_l + k, lp_label + o);
      }
      lattice::cp_async_commit();
      lattice::cp_async_wait_ring();
      __syncthreads();
    }
    return;
  }

  // Compute warp: lane owns columns c[j] = w * 32 * KPL + 32 j + lane.
  int c[KPL], s0[KPL], d_nll[KPL];
  bool col[KPL];
  long long wo[KPL];  // the element of alpha this column writes back next
  // carry: alpha[t-1, u] + lp_blank[t-1, u] (the seed before row 0); x:
  // alpha[t, u] + lp_label[t, u] of the last diagonal; pb, pl: this
  // diagonal's lp_blank and lp_label.
  float carry[KPL], x[KPL], pb[KPL], pl[KPL];
  const int t_last = t_lens[b] - 1;
  const int u_last = u_lens[b];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    c[j] = w * 32 * KPL + 32 * j + lane;
    s0[j] = c[j] / STRIP * STRIP;
    col[j] = c[j] < U;
    d_nll[j] = c[j] == u_last ? t_last + c[j] : INT_MIN;
    wo[j] = base + (long long)(-PREFETCH - s0[j] - STRIP) * U + c[j];
    carry[j] = c[j] == 0 ? 0.f : NEG;
    x[j] = pb[j] = pl[j] = NEG;
  }
  for (int d = -PREFETCH; d <= d_end; ++d) {
    // The chain: x of column c - 1 on the last diagonal, one LSE.
    float sh[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) sh[j] = __shfl_sync(lattice::FULL, x[j], (lane + 31) % 32);
    const float edge = w > 0 ? lattice::lds(xch + 4u * (((d + 1) & 1) * nw + w - 1)) : NEG;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int t = d - c[j];
      const float left = lane > 0 ? sh[j] : (j > 0 ? sh[j - 1] : edge);
      const float a = lattice::lse_wave(carry[j], left);
      const bool live = col[j] && (unsigned)t < (unsigned)T;
      carry[j] = live ? a + pb[j] : carry[j];
      x[j] = live ? a + pl[j] : NEG;
      lattice::sts_if(live, ring_b + ring_row(t) + 4u * c[j], a);
      if (d == d_nll[j]) nll[b] = -(a + pb[j]);
    }
    if (lane == 31) lattice::sts(xch + 4u * ((d & 1) * nw + w), x[KPL - 1]);
    // Off the chain: write back the row each strip finished last diagonal.
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int tw = d - s0[j] - STRIP;
      const float v = lattice::lds(ring_b + ring_row(tw) + 4u * c[j]);
      if (col[j] && (unsigned)tw < (unsigned)T) alpha[wo[j]] = v;
      wo[j] += U;
    }
    __syncthreads();
    // The next diagonal's inputs, into registers.
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const unsigned k = ring_row(d + 1 - c[j]) + 4u * c[j];
      pb[j] = lattice::lds(ring_b + k);
      pl[j] = lattice::lds(ring_l + k);
    }
  }
}

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
  if (B <= 0 || T <= 0 || U <= 0) return 0;
  return lattice::dispatch_wave(U, [&](auto kpl, int nw) {
    constexpr int KPL = decltype(kpl)::value;
    const size_t smem = lattice::wave_smem_bytes(nw * 32 * KPL, nw, 2);
    const cudaError_t err = lattice::allow_smem(alpha_fwd_kernel<KPL>, smem);
    if (err != cudaSuccess) return err;
    alpha_fwd_kernel<KPL><<<B, 2 * 32 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lp_blank), static_cast<const float*>(lp_label),
        static_cast<const int*>(t_lens), static_cast<const int*>(u_lens),
        static_cast<float*>(alpha), static_cast<float*>(nll), T, U, nw);
    return cudaGetLastError();
  });
}

// One warp, n dependent steps x = lse(x + a, b); out (32,) float32.
extern "C" int rnnt_lse_chain(float a, float b, int n, void* out, void* stream) {
  lse_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

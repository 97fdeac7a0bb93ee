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
// t_len + U - 1 dependent LSEs.  Design: K3's wavefront (lattice_wave.cuh)
// mirrored: the block sweeps the diagonals d = (t_len-1) + (U-1) down to 0,
// lane u computes cell (d - u, u) from beta_next (its own register) and
// beta[t, u+1] from its right neighbour (a shuffle, or shared memory across
// a warp edge), with one barrier a diagonal.  The two exps of a cell are
// off the chain; they take __expf, as the LSE (lattice::lse_wave) takes
// __expf/__logf (errors in lattice_wave.cuh).  lp_blank, lp_label and alpha
// arrive through the strip-wise cp.async ring (three arrays: 196,608 bytes
// of ring at U = 1024); the gradients overwrite lp_blank's and lp_label's
// slots and go back to global memory a strip row at a time.

#include "lattice_wave.cuh"

namespace {

using lattice::NEG;
using lattice::PREFETCH;
using lattice::RING;
using lattice::STRIP;

template <int KPL>
__global__ void __launch_bounds__(1024)
beta_bwd_kernel(const float* __restrict__ lp_blank,
                const float* __restrict__ lp_label,
                const float* __restrict__ alpha,
                const int* __restrict__ t_lens, const int* __restrict__ u_lens,
                const float* __restrict__ nll, const float* __restrict__ g,
                float* __restrict__ glpb, float* __restrict__ glpl, int T,
                int U, int nw) {
  extern __shared__ float smem[];
  const unsigned row_bytes = 4u * nw * 32 * KPL;  // one ring row, all columns
  // Shared addresses: ring_b holds lp_blank, then glpb; ring_l lp_label,
  // then glpl; ring_a alpha; xch [2][nw] each warp's first beta.
  const unsigned ring_b = lattice::smem_addr(smem);
  const unsigned ring_l = ring_b + RING * row_bytes;
  const unsigned ring_a = ring_l + RING * row_bytes;
  const unsigned xch = ring_a + RING * row_bytes;
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const size_t base = (size_t)b * T * U;
  const int t_len = min(max(t_lens[b], 0), T);
  auto ring_row = [&](int row) { return (unsigned)(row & (RING - 1)) * row_bytes; };

  for (size_t i = base + (size_t)t_len * U + threadIdx.x; i < base + (size_t)T * U;
       i += blockDim.x) {
    glpb[i] = 0.f;
    glpl[i] = 0.f;
  }
  if (t_len == 0) return;
  // Row r is loaded PREFETCH diagonals before its strip's last column
  // (s0 + STRIP - 1, the first to reach it) does; the sweep starts with the
  // first such load and ends with the write back of row 0.
  const int d_start = t_len - 1 + (U - 1) / STRIP * STRIP + STRIP - 1 + PREFETCH;

  if (w >= nw) {
    // Loader warp: loads the row each strip of compute warp w - nw reaches
    // PREFETCH diagonals on.
    for (int d = d_start; d >= -1; --d) {
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int c = (w - nw) * 32 * KPL + 32 * j + lane;
        const int r = d - PREFETCH - c / STRIP * STRIP - (STRIP - 1);
        const bool load = c < U && (unsigned)r < (unsigned)t_len;
        const size_t o = base + (size_t)min(max(r, 0), T - 1) * U + min(c, U - 1);
        const unsigned k = ring_row(r) + 4u * c;
        lattice::cp_async4_if(load, ring_b + k, lp_blank + o);
        lattice::cp_async4_if(load, ring_l + k, lp_label + o);
        lattice::cp_async4_if(load, ring_a + k, alpha + o);
      }
      lattice::cp_async_commit();
      lattice::cp_async_wait_ring();
      __syncthreads();
    }
    return;
  }

  // Compute warp: lane owns columns c[j] = w * 32 * KPL + 32 j + lane.
  int c[KPL], s0[KPL];
  bool col[KPL];
  long long wo[KPL];  // the element of the gradients this column writes back next
  // bnext: beta_next[u]; y: beta of the last diagonal; pb, pl, pa: this
  // diagonal's lp_blank, lp_label and alpha.
  float bnext[KPL], y[KPL], pb[KPL], pl[KPL], pa[KPL];
  const int u_len = u_lens[b];
  const float ll = -nll[b];
  const float gb = g[b];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    c[j] = w * 32 * KPL + 32 * j + lane;
    s0[j] = c[j] / STRIP * STRIP;
    col[j] = c[j] < U;
    wo[j] = base + (long long)(d_start - s0[j] + 1) * U + c[j];
    bnext[j] = c[j] == u_len ? 0.f : NEG;
    y[j] = pb[j] = pl[j] = pa[j] = NEG;
  }
  for (int d = d_start; d >= -1; --d) {
    // The chain: beta of column c + 1 on the last diagonal, one LSE.
    float sh[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) sh[j] = __shfl_sync(lattice::FULL, y[j], (lane + 1) % 32);
    const float edge = w + 1 < nw ? lattice::lds(xch + 4u * (((d + 1) & 1) * nw + w + 1)) : NEG;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int t = d - c[j];
      const float right = lane < 31 ? sh[j] : (j + 1 < KPL ? sh[j + 1] : edge);
      const float beta = lattice::lse_wave(pb[j] + bnext[j], pl[j] + right);
      const bool live = col[j] && (unsigned)t < (unsigned)t_len;
      const unsigned k = ring_row(t) + 4u * c[j];
      lattice::sts_if(live, ring_b + k, -gb * __expf(pa[j] + pb[j] + bnext[j] - ll));
      lattice::sts_if(live, ring_l + k, -gb * __expf(pa[j] + pl[j] + right - ll));
      y[j] = live ? beta : NEG;
      bnext[j] = live ? beta : bnext[j];
    }
    if (lane == 0) lattice::sts(xch + 4u * ((d & 1) * nw + w), y[0]);
    // Off the chain: write back the row each strip finished last diagonal.
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int tw = d - s0[j] + 1;
      const unsigned k = ring_row(tw) + 4u * c[j];
      const float vb = lattice::lds(ring_b + k);
      const float vl = lattice::lds(ring_l + k);
      if (col[j] && (unsigned)tw < (unsigned)t_len) {
        glpb[wo[j]] = vb;
        glpl[wo[j]] = vl;
      }
      wo[j] -= U;
    }
    __syncthreads();
    // The next diagonal's inputs, into registers.
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const unsigned k = ring_row(d - 1 - c[j]) + 4u * c[j];
      pb[j] = lattice::lds(ring_b + k);
      pl[j] = lattice::lds(ring_l + k);
      pa[j] = lattice::lds(ring_a + k);
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
  return lattice::dispatch_wave(U, [&](auto kpl, int nw) {
    constexpr int KPL = decltype(kpl)::value;
    const size_t smem = lattice::wave_smem_bytes(nw * 32 * KPL, nw, 3);
    const cudaError_t err = lattice::allow_smem(beta_bwd_kernel<KPL>, smem);
    if (err != cudaSuccess) return err;
    beta_bwd_kernel<KPL><<<B, 2 * 32 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lp_blank), static_cast<const float*>(lp_label),
        static_cast<const float*>(alpha), static_cast<const int*>(t_lens),
        static_cast<const int*>(u_lens), static_cast<const float*>(nll),
        static_cast<const float*>(g), static_cast<float*>(glpb),
        static_cast<float*>(glpl), T, U, nw);
    return cudaGetLastError();
  });
}

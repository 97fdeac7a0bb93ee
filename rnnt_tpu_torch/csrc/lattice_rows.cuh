// Row-scan device code of the T-sharded chain kernels K6 (alpha_chain.cu,
// replaces rnnt_tpu/ops/lattice_pallas.py:204 _alpha_chain_kernel) and K7
// (beta_chain.cu, replaces :272 _beta_chain_kernel), and the LSE that the
// wavefront of K3 and K4 (lattice_wave.cuh) shares with them.
//
// One warp holds one sample's lattice row; lane l owns the KPL consecutive
// columns u0 = l * KPL .. u0 + KPL - 1.  A row of either recursion is
// (1) each lane composing the affine maps of its columns sequentially in the
// (LSE, +) semiring, (2) a 5-round shuffle scan of those composites across
// the warp, (3) each lane replaying its columns from the value entering from
// its neighbour, handing each column's result to the caller's ``emit``.
// What bounds it on an H100 is latency: ~13 dependent LSEs a row (KPL = 4
// at U = 65), ~1.6 us a row.  K3 and K4 left it for the wavefront, one LSE
// a diagonal; moving K6 and K7 there too is queued.
//
// Log-zero is the finite NEG = -1e30 and the LSE is unguarded, as in the
// Pallas kernels: when both sides are log-zero the result stays ~NEG, and
// sums of up to T + U NEGs stay far inside float range.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace lattice {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b);
  return m + logf(expf(a - m) + expf(b - m));
}

// The alpha recursion's inputs of row t: cb[j] = lp_blank[t, u] and
// ce[j] = e[u] = lp_label[t, u-1] (NEG at u = 0 and past U).
template <int KPL>
__device__ __forceinline__ void load_alpha_row(const float* __restrict__ lpb,
                                               const float* __restrict__ lpl,
                                               int t, int U, int u0,
                                               float* cb, float* ce) {
  const float* rb = lpb + (size_t)t * U;
  const float* rl = lpl + (size_t)t * U;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int u = u0 + j;
    cb[j] = u < U ? rb[u] : 0.f;
    ce[j] = (u >= 1 && u < U) ? rl[u - 1] : NEG;
  }
}

// The beta recursion's inputs of row t: lp_blank, lp_label and alpha.
template <int KPL>
__device__ __forceinline__ void load_beta_row(const float* __restrict__ lpb,
                                              const float* __restrict__ lpl,
                                              const float* __restrict__ alpha,
                                              int t, int U, int u0, float* cb,
                                              float* ce, float* ca) {
  const size_t o = (size_t)t * U;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int u = u0 + j;
    const bool in = u < U;
    cb[j] = in ? lpb[o + u] : 0.f;
    ce[j] = in ? lpl[o + u] : NEG;
    ca[j] = in ? alpha[o + u] : NEG;
  }
}

// One alpha row: a[u] = LSE(c[u], a[u-1] + ce[u]) with a[-1] = NEG;
// emit(j, a[u0 + j]) for each of this lane's columns below U, left to right.
template <int KPL, class Emit>
__device__ __forceinline__ void alpha_row(const float* c, const float* ce,
                                          int u0, int U, int lane, Emit emit) {
  // (1) this lane's composite map (A, bv): x -> LSE(x + A, bv).
  float A = 0.f, bv = NEG;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    if (u0 + j < U) {
      bv = lse(bv + ce[j], c[j]);
      A += ce[j];
    }
  }
  // (2) inclusive scan of the composites over lanes: left (A1, b1) then
  // right (A2, b2) is (A1 + A2, LSE(b1 + A2, b2)).
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float A_l = __shfl_up_sync(FULL, A, off);
    const float b_l = __shfl_up_sync(FULL, bv, off);
    if (lane >= off) {
      bv = lse(b_l + A, bv);
      A = A_l + A;
    }
  }
  // a[u0 - 1]: the lanes to the left applied to log-zero (column 0 takes
  // nothing from the left, so their composite's bv is the value).
  float a = __shfl_up_sync(FULL, bv, 1);
  if (lane == 0) a = NEG;
  // (3) replay this lane's columns from the incoming value.
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    if (u0 + j < U) {
      a = lse(c[j], a + ce[j]);
      emit(j, a);
    }
  }
}

// One beta row: beta[u] = LSE(d[u], ce[u] + beta[u+1]) with beta[U] = NEG;
// emit(j, beta[u0 + j + 1], beta[u0 + j]) for each of this lane's columns
// below U, right to left.
template <int KPL, class Emit>
__device__ __forceinline__ void beta_row(const float* d, const float* ce,
                                         int u0, int U, int lane, Emit emit) {
  // (1) this lane's composite (A, bv): x -> LSE(x + A, bv), its columns
  // applied right to left starting from the identity (0, NEG).
  float A = 0.f, bv = NEG;
#pragma unroll
  for (int j = KPL - 1; j >= 0; --j) {
    if (u0 + j < U) {
      bv = lse(d[j], ce[j] + bv);
      A += ce[j];
    }
  }
  // (2) inclusive suffix scan over lanes: mine (A1, b1) after the lanes
  // to the right (A2, b2) is (A1 + A2, LSE(b1, A1 + b2)).
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float A_r = __shfl_down_sync(FULL, A, off);
    const float b_r = __shfl_down_sync(FULL, bv, off);
    if (lane + off < 32) {
      bv = lse(bv, A + b_r);
      A = A + A_r;
    }
  }
  // beta[u0 + KPL]: the lanes to the right applied to beta[U] = NEG.
  float x = __shfl_down_sync(FULL, bv, 1);
  if (lane == 31) x = NEG;
  // (3) replay this lane's columns right to left; x is beta[u + 1].
#pragma unroll
  for (int j = KPL - 1; j >= 0; --j) {
    if (u0 + j < U) {
      const float up = x;
      x = lse(d[j], ce[j] + x);
      emit(j, up, x);
    }
  }
}

// Columns per lane: call launch(std::integral_constant<int, KPL>) with the
// smallest KPL in {1, 2, 4, ..., 32} that gives 32 lanes U columns; U > 1024
// is cudaErrorInvalidValue.
template <class Launch>
int dispatch_kpl(int U, Launch launch) {
  const int per_lane = (U + 31) / 32;
  if (per_lane <= 1) return (int)launch(std::integral_constant<int, 1>{});
  if (per_lane <= 2) return (int)launch(std::integral_constant<int, 2>{});
  if (per_lane <= 4) return (int)launch(std::integral_constant<int, 4>{});
  if (per_lane <= 8) return (int)launch(std::integral_constant<int, 8>{});
  if (per_lane <= 16) return (int)launch(std::integral_constant<int, 16>{});
  if (per_lane <= 32) return (int)launch(std::integral_constant<int, 32>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace lattice

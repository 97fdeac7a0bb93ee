// The anti-diagonal wavefront of the lattice DPs: one alpha sweep and one
// beta sweep, each a kernel template on `bool Chain`, behind four C entry
// points.  Chain = false: K3 (alpha_fwd.cu, replaces
// rnnt_tpu/ops/lattice_pallas.py:120 _alpha_kernel) and K4 (beta_bwd.cu,
// replaces :353 _beta_kernel) on the whole lattice.  Chain = true: K6
// (alpha_chain.cu, replaces :204 _alpha_chain_kernel) and K7
// (beta_chain.cu, replaces :272 _beta_chain_kernel) on one T-shard of it,
// the stages of the sequence-parallel lattice (ops/lattice_tshard.py).
//
// What bounds the lattice DP on an H100 is latency, not bytes.  alpha[t, u]
// depends on alpha[t-1, u] and alpha[t, u-1] (beta, mirrored, on t+1 and
// u+1), so every cell of one anti-diagonal t + u = d depends only on
// diagonal d - 1 (d + 1 for beta): the critical path is T + U - 1 dependent
// LSEs, against ~13 a row, T rows, for a row scan.  One block holds one
// sample and sweeps its diagonals; each compute lane owns one column (two
// past U = 512) and does one LSE a diagonal on the chain: the neighbour's
// value of the last diagonal by shuffle (across a warp edge through shared
// memory), one LSE, one add, then one __syncthreads a diagonal.  Warps:
// dispatch_wave.  The diagonal's loop is branch-free (predicated stores and
// copies), and shared memory is addressed through 32-bit shared-window
// addresses, so the compiler keeps the chain short.
//
// Memory.  A lane walks down its column, U floats a row apart, and the
// cells of one diagonal sit U - 1 floats apart: read straight from global
// memory, every access would be a sector of its own.  So the inputs are
// staged, and the outputs written back, by strips of STRIP = 8 columns
// (one 32-byte sector of a row): the 8 lanes of a strip's loader warp load
// the same row together with predicated 4-byte cp.async, PREFETCH
// diagonals before the strip's first column reaches it, into a per-column
// ring of RING rows in shared memory; the loader waits for its own copies
// of PREFETCH - 1 diagonals ago, and the barrier hands them to the compute
// lanes, which read them into registers one diagonal before use.  A cell's
// output overwrites its input slot, and the strip writes a row back to
// global memory together, one diagonal after its last column finished it.
// A row lives in the ring from its load (PREFETCH + 7 diagonals before its
// last use) to its write back (8 diagonals after its first use):
// RING - PREFETCH > STRIP keeps a slot's write back and its reload on
// different diagonals, a barrier apart.  Both bounds count diagonals from
// the row's own first and last use, whatever the lattice's height, so they
// hold as well on a T-shard with fewer rows than columns.  Shared memory:
// arrays x RING x columns x 4 bytes, 196,608 bytes for the beta sweep at
// U = 1024 (U_MAX).  cp.async moves 4 bytes: the main path's U (65, 257)
// is odd, so rows are not 16-byte aligned; a strip's row costs at most two
// sectors.
//
// The chain stages differ from K3 and K4 only at the sweep's two ends,
// compiled in by `Chain` (so K3's and K4's loops carry no test of it):
// the carry registers start from carry_in (the neighbouring shard's
// carry_out) instead of the seed where the shard does not hold the seeded
// row, and end in carry_out; the rows are local, r = t - t0; the alpha
// sweep's output at (t_len - 1, u_len) is ll_part, not negated, and 0 when
// the shard does not hold row t_len - 1.
//
// Log-zero is the finite NEG and the LSE is unguarded, as in the Pallas
// kernels: when both sides are log-zero the result stays ~NEG, and sums of
// up to T + U NEGs stay far inside float range.  The LSE (lse_wave) is
// max + log(1 + exp(-|a - b|)) on the MUFU approximations __expf and
// __logf: one exp and one log a step, 41 ns a dependent step on an H100
// against 84 ns for an LSE of two accurate expf and an accurate logf.
// Measured against the plain versions (float32) on an H100 it moves K3's
// largest error from 5.5e-4 to 6.1e-4 at (4, 504, 65) (1.6e-3 both ways at
// (4, 1000, 257)) and K4's from 3.7e-4 to 4.3e-4 (1.5e-3 both ways),
// inside K3_TOL and K4_TOL (chip_smoke.py) unchanged.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <type_traits>

namespace lattice {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int STRIP = 8;      // columns whose row segment is one sector
constexpr int RING = 16;      // rows a column keeps in shared memory
constexpr int PREFETCH = 7;   // diagonals a row is loaded ahead of its use
static_assert(RING - PREFETCH > STRIP, "a slot is reloaded before its write back");
static_assert((RING & (RING - 1)) == 0, "RING is a power of two");

// Shared memory through 32-bit shared-window addresses, taken once before
// the diagonal loop: with generic pointers into dynamic shared memory the
// compiler re-derives the window base (S2R SR_CgaCtaId) inside the loop,
// on the chain.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float lds(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v));
}
__device__ __forceinline__ void sts_if(bool pred, unsigned a, float v) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p st.shared.f32 [%0], %1;\n}\n" ::"r"(a),
      "f"(v), "r"((int)pred));
}

// 4 bytes from global to shared memory when `pred`; the instruction is
// predicated, not branched around, so the compiler can schedule it into
// the gaps of the loader warp's stream.
__device__ __forceinline__ void cp_async4_if(bool pred, unsigned smem, const float* gmem) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(smem),
      "l"(gmem), "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until this thread's loads of PREFETCH - 1 diagonals ago have landed:
// a row is read into registers one diagonal before the one that needs it.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PREFETCH - 1) : "memory");
}

// The wavefront's LSE, on its critical path (see the note above).  Two NEGs
// give NEG + log 2; a NEG against a live value gives the live value.
__device__ __forceinline__ float lse_wave(float a, float b) {
  return fmaxf(a, b) + __logf(1.f + __expf(-fabsf(a - b)));
}

// Warps of a wavefront block: nw compute warps, lane l of warp w owning the
// KPL columns c = w * 32 * KPL + 32 j + l (j < KPL), and nw loader warps,
// loader warp nw + w issuing the cp.async loads of compute warp w's
// columns, so that a warp that stores to global memory never waits on
// cp.async loads of its own (with both in one warp, the stores stalled
// behind the copies and cost more than the copies and stores apart).  One
// column a lane (nw = ceil(U / 32)) measured fastest:
// three columns a lane in one warp took 1.2x as long at U = 65, two
// columns a lane in two warps 1.5x;
// the chain's per-diagonal work spreads over the SM's four sub-partitions.
// Past U = 512 two columns a lane keep the block at 1024 threads.  Calls
// launch(std::integral_constant<int, KPL>, nw); U > 1024 is
// cudaErrorInvalidValue.
template <class Launch>
int dispatch_wave(int U, Launch launch) {
  const int warps = (U + 31) / 32;
  if (warps > 32) return (int)cudaErrorInvalidValue;
  if (warps <= 16) return (int)launch(std::integral_constant<int, 1>{}, warps);
  return (int)launch(std::integral_constant<int, 2>{}, (warps + 1) / 2);
}

// Dynamic shared memory of a block of ncol columns and nw warps: `arrays`
// staged arrays of RING rows plus the double-buffered warp-boundary row.
inline size_t wave_smem_bytes(int ncol, int nw, int arrays) {
  return ((size_t)arrays * RING * ncol + 2 * nw) * sizeof(float);
}

// Let `kernel` take `bytes` of dynamic shared memory when that is past the
// 48 KB default; returns the CUDA error.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The alpha sweep (K3, K6) over local rows r = 0 .. T-1 of one sample a
// block: alpha[r, u] = LSE(carry[u], alpha[r, u-1] + lp_label[r, u-1]),
// carry[u] = alpha[r, u] + lp_blank[r, u] after row r.  Lane u keeps carry
// in a register and takes x = alpha[r, u-1] + lp_label[r, u-1] from its
// left neighbour.  lp_blank and lp_label arrive through the ring; alpha
// overwrites lp_blank's slot and goes back to global memory a strip row at
// a time.  The carry entering row 0 is the seed alpha[0, 0] = 0 (K3, and
// K6 at t0 = 0) or carry_in (K6 elsewhere); ll_out[b] is -(alpha +
// lp_blank) at (t_len - 1, u_len) for K3 (the NLL) and +(alpha + lp_blank)
// there for K6, 0 when the shard does not hold row t_len - 1 (ll_part);
// K6 stores the carry after row T - 1 to carry_out.
template <int KPL, bool Chain>
__global__ void __launch_bounds__(1024)
alpha_sweep(const float* __restrict__ lp_blank, const float* __restrict__ lp_label,
            const int* __restrict__ t_lens, const int* __restrict__ u_lens,
            const float* __restrict__ carry_in, float* __restrict__ alpha,
            float* __restrict__ ll_out, float* __restrict__ carry_out, int T, int U,
            int nw, int t0) {
  extern __shared__ float smem[];
  const unsigned row_bytes = 4u * nw * 32 * KPL;  // one ring row, all columns
  // Shared addresses: ring_b holds lp_blank, then alpha; ring_l lp_label;
  // xch [2][nw] each warp's last x.  Column c of ring row k is at
  // ring + k * row_bytes + 4 c.
  const unsigned ring_b = smem_addr(smem);
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
        cp_async4_if(load, ring_b + k, lp_blank + o);
        cp_async4_if(load, ring_l + k, lp_label + o);
      }
      cp_async_commit();
      cp_async_wait_ring();
      __syncthreads();
    }
    return;
  }

  // Compute warp: lane owns columns c[j] = w * 32 * KPL + 32 j + lane.
  int c[KPL], s0[KPL], d_ll[KPL];
  bool col[KPL];
  long long wo[KPL];  // the element of alpha this column writes back next
  // carry: alpha[r-1, u] + lp_blank[r-1, u] (the seed or carry_in before
  // row 0); x: alpha[r, u] + lp_label[r, u] of the last diagonal; pb, pl:
  // this diagonal's lp_blank and lp_label.
  float carry[KPL], x[KPL], pb[KPL], pl[KPL];
  const int t_last = t_lens[b] - 1 - (Chain ? t0 : 0);  // the local row of t_len - 1
  const int u_last = u_lens[b];
  const bool held = !Chain || (unsigned)t_last < (unsigned)T;
  const bool seed = !Chain || t0 == 0;
  if (Chain && !held && threadIdx.x == 0) ll_out[b] = 0.f;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    c[j] = w * 32 * KPL + 32 * j + lane;
    s0[j] = c[j] / STRIP * STRIP;
    col[j] = c[j] < U;
    d_ll[j] = held && c[j] == u_last ? t_last + c[j] : INT_MIN;
    wo[j] = base + (long long)(-PREFETCH - s0[j] - STRIP) * U + c[j];
    carry[j] = seed ? (c[j] == 0 ? 0.f : NEG)
                    : (col[j] ? carry_in[(size_t)b * U + c[j]] : NEG);
    x[j] = pb[j] = pl[j] = NEG;
  }
  for (int d = -PREFETCH; d <= d_end; ++d) {
    // The chain: x of column c - 1 on the last diagonal, one LSE.
    float sh[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) sh[j] = __shfl_sync(FULL, x[j], (lane + 31) % 32);
    const float edge = w > 0 ? lds(xch + 4u * (((d + 1) & 1) * nw + w - 1)) : NEG;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int t = d - c[j];
      const float left = lane > 0 ? sh[j] : (j > 0 ? sh[j - 1] : edge);
      const float a = lse_wave(carry[j], left);
      const bool live = col[j] && (unsigned)t < (unsigned)T;
      carry[j] = live ? a + pb[j] : carry[j];
      x[j] = live ? a + pl[j] : NEG;
      sts_if(live, ring_b + ring_row(t) + 4u * c[j], a);
      if (d == d_ll[j]) ll_out[b] = Chain ? a + pb[j] : -(a + pb[j]);
    }
    if (lane == 31) sts(xch + 4u * ((d & 1) * nw + w), x[KPL - 1]);
    // Off the chain: write back the row each strip finished last diagonal.
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int tw = d - s0[j] - STRIP;
      const float v = lds(ring_b + ring_row(tw) + 4u * c[j]);
      if (col[j] && (unsigned)tw < (unsigned)T) alpha[wo[j]] = v;
      wo[j] += U;
    }
    __syncthreads();
    // The next diagonal's inputs, into registers.
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const unsigned k = ring_row(d + 1 - c[j]) + 4u * c[j];
      pb[j] = lds(ring_b + k);
      pl[j] = lds(ring_l + k);
    }
  }
  if (Chain) {
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      if (col[j]) carry_out[(size_t)b * U + c[j]] = carry[j];
  }
}

// The beta sweep (K4, K7) over local rows r = r_end - 1 down to 0, r_end =
// clamp(t_len - t0, 0, T) the shard's live rows (t0 = 0 for K4):
//   beta[r, u] = LSE(lp_blank[r, u] + bnext[u], lp_label[r, u] + beta[r, u+1])
//   glpb[r, u] = -g * exp(alpha[r, u] + lp_blank[r, u] + bnext[u] - ll)
//   glpl[r, u] = -g * exp(alpha[r, u] + lp_label[r, u] + beta[r, u+1] - ll)
// with beta[r, U] = NEG and bnext = beta[r + 1] below row r_end - 1; above
// it the seed (0 at u_len) where the shard holds row t_len - 1, else
// carry_in (K7: the next shard's carry_out).  The sweep runs the
// diagonals d = (r_end - 1) + (U - 1) down to 0; lane u keeps bnext in a
// register and takes beta[r, u+1] from its right neighbour.  The two exps
// of a cell are off the chain (__expf).  lp_blank, lp_label and alpha
// arrive through the ring; the gradients overwrite lp_blank's and
// lp_label's slots and go back a strip row at a time; rows r >= r_end get
// zero gradients (the Pallas kernels mask the exponent there) and are
// never read.  ll_in is the NLL for K4 (ll = -nll) and the log-likelihood
// for K7.  K7 stores beta at row 0 to carry_out, NEG when r_end = 0.
template <int KPL, bool Chain>
__global__ void __launch_bounds__(1024)
beta_sweep(const float* __restrict__ lp_blank, const float* __restrict__ lp_label,
           const float* __restrict__ alpha, const int* __restrict__ t_lens,
           const int* __restrict__ u_lens, const float* __restrict__ ll_in,
           const float* __restrict__ g, const float* __restrict__ carry_in,
           float* __restrict__ glpb, float* __restrict__ glpl,
           float* __restrict__ carry_out, int T, int U, int nw, int t0) {
  extern __shared__ float smem[];
  const unsigned row_bytes = 4u * nw * 32 * KPL;  // one ring row, all columns
  // Shared addresses: ring_b holds lp_blank, then glpb; ring_l lp_label,
  // then glpl; ring_a alpha; xch [2][nw] each warp's first beta.
  const unsigned ring_b = smem_addr(smem);
  const unsigned ring_l = ring_b + RING * row_bytes;
  const unsigned ring_a = ring_l + RING * row_bytes;
  const unsigned xch = ring_a + RING * row_bytes;
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const size_t base = (size_t)b * T * U;
  const int t_len = t_lens[b];
  const int r_end = min(max(t_len - (Chain ? t0 : 0), 0), T);
  auto ring_row = [&](int row) { return (unsigned)(row & (RING - 1)) * row_bytes; };

  for (size_t i = base + (size_t)r_end * U + threadIdx.x; i < base + (size_t)T * U;
       i += blockDim.x) {
    glpb[i] = 0.f;
    glpl[i] = 0.f;
  }
  if (r_end == 0) {
    if (Chain)
      for (int i = threadIdx.x; i < U; i += blockDim.x) carry_out[(size_t)b * U + i] = NEG;
    return;
  }
  // Row r is loaded PREFETCH diagonals before its strip's last column
  // (s0 + STRIP - 1, the first to reach it) does; the sweep starts with the
  // first such load and ends with the write back of row 0.
  const int d_start = r_end - 1 + (U - 1) / STRIP * STRIP + STRIP - 1 + PREFETCH;

  if (w >= nw) {
    // Loader warp: loads the row each strip of compute warp w - nw reaches
    // PREFETCH diagonals on.
    for (int d = d_start; d >= -1; --d) {
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int c = (w - nw) * 32 * KPL + 32 * j + lane;
        const int r = d - PREFETCH - c / STRIP * STRIP - (STRIP - 1);
        const bool load = c < U && (unsigned)r < (unsigned)r_end;
        const size_t o = base + (size_t)min(max(r, 0), T - 1) * U + min(c, U - 1);
        const unsigned k = ring_row(r) + 4u * c;
        cp_async4_if(load, ring_b + k, lp_blank + o);
        cp_async4_if(load, ring_l + k, lp_label + o);
        cp_async4_if(load, ring_a + k, alpha + o);
      }
      cp_async_commit();
      cp_async_wait_ring();
      __syncthreads();
    }
    return;
  }

  // Compute warp: lane owns columns c[j] = w * 32 * KPL + 32 j + lane.
  int c[KPL], s0[KPL];
  bool col[KPL];
  long long wo[KPL];  // the element of the gradients this column writes back next
  // bnext: beta[r + 1, u] (the seed or carry_in above row r_end - 1); y:
  // beta of the last diagonal; pb, pl, pa: this diagonal's lp_blank,
  // lp_label and alpha.
  float bnext[KPL], y[KPL], pb[KPL], pl[KPL], pa[KPL];
  const int u_len = u_lens[b];
  const float ll = Chain ? ll_in[b] : -ll_in[b];
  const float gb = g[b];
  const bool seeded = !Chain || t0 + r_end == t_len;  // the shard holds row t_len - 1
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    c[j] = w * 32 * KPL + 32 * j + lane;
    s0[j] = c[j] / STRIP * STRIP;
    col[j] = c[j] < U;
    wo[j] = base + (long long)(d_start - s0[j] + 1) * U + c[j];
    bnext[j] = seeded ? (c[j] == u_len ? 0.f : NEG)
                      : (col[j] ? carry_in[(size_t)b * U + c[j]] : NEG);
    y[j] = pb[j] = pl[j] = pa[j] = NEG;
  }
  for (int d = d_start; d >= -1; --d) {
    // The chain: beta of column c + 1 on the last diagonal, one LSE.
    float sh[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) sh[j] = __shfl_sync(FULL, y[j], (lane + 1) % 32);
    const float edge = w + 1 < nw ? lds(xch + 4u * (((d + 1) & 1) * nw + w + 1)) : NEG;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int t = d - c[j];
      const float right = lane < 31 ? sh[j] : (j + 1 < KPL ? sh[j + 1] : edge);
      const float beta = lse_wave(pb[j] + bnext[j], pl[j] + right);
      const bool live = col[j] && (unsigned)t < (unsigned)r_end;
      const unsigned k = ring_row(t) + 4u * c[j];
      sts_if(live, ring_b + k, -gb * __expf(pa[j] + pb[j] + bnext[j] - ll));
      sts_if(live, ring_l + k, -gb * __expf(pa[j] + pl[j] + right - ll));
      y[j] = live ? beta : NEG;
      bnext[j] = live ? beta : bnext[j];
    }
    if (lane == 0) sts(xch + 4u * ((d & 1) * nw + w), y[0]);
    // Off the chain: write back the row each strip finished last diagonal.
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int tw = d - s0[j] + 1;
      const unsigned k = ring_row(tw) + 4u * c[j];
      const float vb = lds(ring_b + k);
      const float vl = lds(ring_l + k);
      if (col[j] && (unsigned)tw < (unsigned)r_end) {
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
      pb[j] = lds(ring_b + k);
      pl[j] = lds(ring_l + k);
      pa[j] = lds(ring_a + k);
    }
  }
  if (Chain) {
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      if (col[j]) carry_out[(size_t)b * U + c[j]] = bnext[j];
  }
}

// Launch the alpha sweep on B blocks (one a sample) on `stream`; K3 passes
// null carries and t0 = 0.  Returns the CUDA error of the launch.
template <bool Chain>
int launch_alpha(const void* lp_blank, const void* lp_label, const void* t_lens,
                 const void* u_lens, const void* carry_in, void* alpha, void* ll_out,
                 void* carry_out, int B, int T, int U, int t0, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0) return 0;
  return dispatch_wave(U, [&](auto kpl, int nw) {
    constexpr int KPL = decltype(kpl)::value;
    const size_t smem = wave_smem_bytes(nw * 32 * KPL, nw, 2);
    const cudaError_t err = allow_smem(alpha_sweep<KPL, Chain>, smem);
    if (err != cudaSuccess) return err;
    alpha_sweep<KPL, Chain><<<B, 2 * 32 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lp_blank), static_cast<const float*>(lp_label),
        static_cast<const int*>(t_lens), static_cast<const int*>(u_lens),
        static_cast<const float*>(carry_in), static_cast<float*>(alpha),
        static_cast<float*>(ll_out), static_cast<float*>(carry_out), T, U, nw, t0);
    return cudaGetLastError();
  });
}

// Launch the beta sweep on B blocks on `stream`; K4 passes null carries
// and t0 = 0.  Returns the CUDA error of the launch.
template <bool Chain>
int launch_beta(const void* lp_blank, const void* lp_label, const void* alpha,
                const void* t_lens, const void* u_lens, const void* ll_in, const void* g,
                const void* carry_in, void* glpb, void* glpl, void* carry_out, int B, int T,
                int U, int t0, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0) return 0;
  return dispatch_wave(U, [&](auto kpl, int nw) {
    constexpr int KPL = decltype(kpl)::value;
    const size_t smem = wave_smem_bytes(nw * 32 * KPL, nw, 3);
    const cudaError_t err = allow_smem(beta_sweep<KPL, Chain>, smem);
    if (err != cudaSuccess) return err;
    beta_sweep<KPL, Chain><<<B, 2 * 32 * nw, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lp_blank), static_cast<const float*>(lp_label),
        static_cast<const float*>(alpha), static_cast<const int*>(t_lens),
        static_cast<const int*>(u_lens), static_cast<const float*>(ll_in),
        static_cast<const float*>(g), static_cast<const float*>(carry_in),
        static_cast<float*>(glpb), static_cast<float*>(glpl),
        static_cast<float*>(carry_out), T, U, nw, t0);
    return cudaGetLastError();
  });
}

}  // namespace lattice

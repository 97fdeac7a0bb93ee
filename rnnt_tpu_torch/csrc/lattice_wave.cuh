// Anti-diagonal wavefront shared by K3 (alpha_fwd.cu, replaces
// rnnt_tpu/ops/lattice_pallas.py:120 _alpha_kernel) and K4 (beta_bwd.cu,
// replaces :353 _beta_kernel).  K6 and K7 keep the row scans of
// lattice_rows.cuh.
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
// different diagonals, a barrier apart.  Shared memory: arrays x RING x
// columns x 4 bytes, 196,608 bytes for K4 at U = 1024 (U_MAX).  cp.async
// moves 4 bytes: the main path's U (65, 257) is odd, so rows are not
// 16-byte aligned; a strip's row costs at most two sectors.
//
// The LSE (lse_wave) is max + log(1 + exp(-|a - b|)) on the MUFU
// approximations __expf and __logf: one exp and one log a step, 41 ns a
// dependent step on an H100 against 84 ns for lattice::lse's two accurate
// exps and accurate log.  Measured against the plain versions (float32)
// on an H100 it moves K3's largest error from 5.5e-4 to 6.1e-4 at (4, 504,
// 65) (1.6e-3 both ways at (4, 1000, 257)) and K4's from 3.7e-4 to 4.3e-4
// (1.5e-3 both ways), inside K3_TOL and K4_TOL (chip_smoke.py) unchanged.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "lattice_rows.cuh"

namespace lattice {

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

}  // namespace lattice

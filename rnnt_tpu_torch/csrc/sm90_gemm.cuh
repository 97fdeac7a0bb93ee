// sm90_gemm.cuh: one TMA-fed, warp-specialised wgmma GEMM mainloop for
// Hopper (sm_90a), shared by the kernels that multiply bf16 tiles.
//
// Users: K2, the fused joint backward (joint_bwd.cu), runs its three
// products on it (dl = h.W, dh = dl.W^T, dW = h^T.dl); K1, the fused joint
// forward (joint_fwd.cu), runs h.W over every V tile of a row tile with a
// logsumexp in registers (the walking hook below).
//
// One CTA (CTAS of them an SM) computes a BM x BN tile (BM = 128) of
// C = A . B in float32 over k-blocks of BK = 64:
//   - the producer (warps 8-11 at one CTA an SM, which give up registers
//     with setmaxnreg; warp 8 alone at two) has one thread issue TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle) into a ring of STAGES
//     stages, each guarded by a "full" mbarrier (transaction bytes) and an
//     "empty" one (one arrival per consumer warp);
//   - warps 0-7 (two consumer warpgroups, 64 rows each) take registers and
//     run wgmma.mma_async m64nBNk16 (bf16 in, f32 accumulators) on the
//     stage that has landed, keeping one wgmma group in flight while they
//     release the stage before it;
//   - then the accumulator tile goes to shared memory (float, row-major,
//     LDP = BN + 8 floats a row, over the drained ring) and the problem's
//     epilogue reads it there, so that its global traffic is coalesced.
// Operands are staged as 8 KB boxes of 64 x 64 bf16 (one 128-byte swizzle
// row of 64 elements by 64 rows): A as 2 boxes (one per consumer
// warpgroup), B as BN / 64.  Each operand is K-major (a box row is 64 k of
// one m or n; the tensor's rows are m or n) or MN-major (a box row is 64 m
// or n of one k; the tensor's rows are k): the `P::A_MN` / `P::B_MN` flags
// choose wgmma's transpose bit and the descriptor.  TMA zero-fills what
// lies outside a tensor, so ragged edges need no masking in the mainloop.
//
// A problem P supplies: constexpr BN (128 or 256), STAGES, CTAS (1 or 2),
// A_MN, B_MN, SCRATCH; `Params`; a `Tile` from `P::tile(params)` (from
// blockIdx) with its `k_blocks`; `P::load_a(map, params, tile, kb, j, dst,
// bar)` for box j < 2 and `P::load_b(...)` for j < BN / 64, each one TMA
// load of k-block kb; and `P::epilogue(params, tile, float* acc_tile,
// float* scratch, tid)`, run by the 256 consumer threads on the tile in
// shared memory (which it may overwrite), with `consumer_sync()` and
// P::SCRATCH floats of `scratch` past the tile.
//
// The walking hook: a problem that defines a type `State` has each block
// walk `tile.n_tiles` tiles (`P::nth(tile, i)`, e.g. the N tiles of one
// row tile), the loads of one tile after the other's through the same
// ring, so that the next tile's loads overlap this tile's epilogue, and
// hands each finished accumulator to `P::reg_epilogue(params, tile_i, acc,
// state, tid)` in the registers of the wgmma fragment (m64nBNk16:
// acc[4j + e] at row warp*16 + lane/4 and acc[4j + 2 + e] at row + 8 of
// the warpgroup's 64, column j*8 + 2*(lane%4) + e).  `state` (a
// `P::State`, one per consumer thread) lives across the walk.  No
// shared-memory tile: the ring is never drained.
//
// Host side: `encode_map` builds a CUtensorMap with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint so that nothing links libcuda;
// `launch_gemm` sizes the shared memory and launches.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int BOX = 64;                        // a box is BOX x BOX bf16
constexpr int BOX_BYTES = BOX * BOX * 2;       // 8 KB
constexpr int CONSUMERS = 256;                 // two warpgroups

// Threads of a block: the consumers and a producer warpgroup at one block
// an SM, where setmaxnreg moves its registers to the consumers (168 at
// launch -> 40 and 232); a lone producer warp at two, where 2 x 288
// threads fit the register file without setmaxnreg.  setmaxnreg.inc
// waits for registers its block has freed, so the counts must balance:
// with one producer warp ptxas launched at 168 (or 96) registers, and
// .inc to 232 never returned.
template <class P>
__host__ __device__ constexpr int threads() {
  return CONSUMERS + (P::CTAS == 1 ? 128 : 32);
}

__host__ __device__ constexpr int ldp(int bn) { return bn + 8; }

// True for a problem with the walking hook (a `State` type).
template <class P, class = void>
struct walks_n : std::false_type {};
template <class P>
struct walks_n<P, std::void_t<typename P::State>> : std::true_type {};

// ------------------------------ device side ------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Named barrier 1 over the 256 consumer threads (the producer never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The operand of one m64/nBN x k16 step kk (0..3) of a staged k-block.
// K-major: rows of 128 bytes (64 k), 8-row groups 1024 bytes apart; k16
// steps 32 bytes along the row.  MN-major: boxes of 64 k rows x 64 m/n,
// 8-k groups 1024 bytes apart (SBO), 64-wide m/n blocks one box (8 KB)
// apart (LBO); k16 steps 16 rows = 2048 bytes.
template <bool MN>
__device__ __forceinline__ uint64_t operand_desc(const bf16* tile, int kk) {
  if (MN) return sw128_desc(reinterpret_cast<const char*>(tile) + kk * 2048, BOX_BYTES, 1024);
  return sw128_desc(reinterpret_cast<const char*>(tile) + kk * 32, 16, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N f32, the m64nNk16 fragment layout) += A . B, operands from the
// descriptors; TA / TB: 1 for an MN-major operand (wgmma's transpose bit).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128<TA, TB>(d, da, db);
  else
    wgmma_m64n256<TA, TB>(d, da, db);
}

// Bytes of the ring or of the epilogue's tile and scratch, whichever is
// larger (the epilogue reuses the drained ring; a walking problem keeps
// its tiles in registers); the barriers follow.
template <class P>
__host__ __device__ constexpr int body_bytes() {
  constexpr int ring = P::STAGES * (2 + P::BN / BOX) * BOX_BYTES;
  constexpr int epi = walks_n<P>::value ? 0 : (BM * ldp(P::BN) + P::SCRATCH) * 4;
  return ring > epi ? ring : epi;
}

// The nt-th tile a block walks (the block's one tile for a problem
// without the walking hook).
template <class P>
__device__ __forceinline__ typename P::Tile nth_tile(const typename P::Tile& t, int nt) {
  if constexpr (walks_n<P>::value)
    return P::nth(t, nt);
  else
    return t;
}

// One N tile's k loop on the consumers, its ring slots starting at it0
// (the running count over the block's tiles): one wgmma group in flight
// while the stage before it is released (one arrival per warp).  Returns
// with every group complete and every stage of the tile released.
template <class P>
__device__ __forceinline__ void mma_k_loop(float (&acc)[P::BN / 2], const bf16* a_s,
                                           const bf16* b_s, uint64_t* full,
                                           uint64_t* empty, int it0, int n_k) {
  constexpr int STAGES = P::STAGES;
  constexpr int A_ELEMS = 2 * BOX * BOX;
  constexpr int B_ELEMS = P::BN / BOX * BOX * BOX;
  const int wg = threadIdx.x / 128;
  const bool lead = threadIdx.x % 32 == 0;
  for (int kb = 0; kb < n_k; ++kb) {
    const int it = it0 + kb;
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const bf16* a = a_s + s * A_ELEMS + wg * BOX * BOX;
    const bf16* b = b_s + s * B_ELEMS;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tile<P::BN, P::A_MN ? 1 : 0, P::B_MN ? 1 : 0>(
          acc, operand_desc<P::A_MN>(a, kk), operand_desc<P::B_MN>(b, kk));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (kb > 0 && lead) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (n_k > 0 && lead) mbar_arrive(&empty[(it0 + n_k - 1) % STAGES]);
}

template <class P>
__global__ void __launch_bounds__(threads<P>(), P::CTAS)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const typename P::Params prm) {
  constexpr int BN = P::BN;
  constexpr int STAGES = P::STAGES;
  constexpr int A_BYTES = 2 * BOX_BYTES;
  constexpr int B_BYTES = BN / BOX * BOX_BYTES;
  extern __shared__ unsigned char smem_raw[];
  // The swizzle pattern repeats every 1024 bytes: align the ring to it.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = reinterpret_cast<bf16*>(smem + STAGES * A_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + body_bytes<P>());
  uint64_t* empty = full + STAGES;

  const typename P::Tile tile = P::tile(prm);
  const int n_k = tile.k_blocks;
  int n_n = 1;
  if constexpr (walks_n<P>::value) n_n = tile.n_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer: one thread keeps the ring full.
    if constexpr (P::CTAS == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      int it = 0;  // ring slots used, over the block's tiles
      for (int nt = 0; nt < n_n; ++nt) {
        const typename P::Tile t = nth_tile<P>(tile, nt);
        for (int kb = 0; kb < n_k; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
          bf16* a = a_s + s * (A_BYTES / 2);
          bf16* b = b_s + s * (B_BYTES / 2);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            P::load_a(&map_a, prm, t, kb, j, a + j * BOX * BOX, &full[s]);
#pragma unroll
          for (int j = 0; j < BN / BOX; ++j)
            P::load_b(&map_b, prm, t, kb, j, b + j * BOX * BOX, &full[s]);
        }
      }
    }
  } else {
    if constexpr (P::CTAS == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    if constexpr (walks_n<P>::value) {
      // Every tile in turn: its k loop, then its epilogue from the
      // registers while the producer refills the ring with the next's.
      typename P::State st;
      float acc[BN / 2];
      for (int i = 0; i < n_n; ++i) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
        mma_k_loop<P>(acc, a_s, b_s, full, empty, i * n_k, n_k);
        P::reg_epilogue(prm, P::nth(tile, i), acc, st, threadIdx.x);
      }
    } else {
      const int lane = threadIdx.x % 32;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      mma_k_loop<P>(acc, a_s, b_s, full, empty, 0, n_k);

      // The accumulator tile to shared memory, over the drained ring.
      consumer_sync();
      float* tile_s = reinterpret_cast<float*>(smem);
      {
        const int wg = threadIdx.x / 128;
        const int w = (threadIdx.x % 128) / 32;
        const int r = wg * 64 + w * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = j * 8 + (lane % 4) * 2;
          *reinterpret_cast<float2*>(tile_s + r * ldp(BN) + c) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(tile_s + (r + 8) * ldp(BN) + c) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      consumer_sync();
      P::epilogue(prm, tile, tile_s, tile_s + BM * ldp(BN), threadIdx.x);
    }
  }
}

// -------------------------------- host side --------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first), byte strides of dims
// 1.., boxes of BOX (innermost) x box[1..] elements, 128-byte swizzle,
// zero fill outside.  Returns false when the driver refuses it (a base or
// stride that is not a multiple of 16 bytes, a dim too large).
inline bool encode_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                       const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t bx[5], es[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    es[i] = 1;
    if (i > 0) s[i - 1] = strides[i - 1];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), d, s, bx,
            es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class P>
constexpr size_t smem_bytes() {
  return 1024 + body_bytes<P>() + 2 * P::STAGES * 8;
}

// Launch P's GEMM on `grid`; returns the CUDA error.
template <class P>
cudaError_t launch_gemm(const CUtensorMap& map_a, const CUtensorMap& map_b,
                        const typename P::Params& prm, dim3 grid, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<P>();
  static_assert(bytes * P::CTAS <= 232448, "the GEMM's shared memory exceeds an SM's");
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  gemm_kernel<P><<<grid, threads<P>(), bytes, stream>>>(map_a, map_b, prm);
  return cudaGetLastError();
}

}  // namespace sm90

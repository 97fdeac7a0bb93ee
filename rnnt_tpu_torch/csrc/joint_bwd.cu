// K2: fused RNN-T joint, backward.
//
// Replaces rnnt_tpu/ops/transducer_pallas.py:155 _bwd_kernel (launcher
// _bwd_pallas:280, call :333).  For every lattice cell (row) r = (b, t, u):
//   h_r   = act(enc[b, t] + pred[b, u])               (bf16, as K1 rounds it;
//           act = tanh, or ReLU for act = 1)
//   p_r   = exp(h_r . W + bias - lse_r)                (softmax from K1's lse)
//   dl_r  = g_lse_r p_r + g_blank_r 1[blank] + g_label_r 1[label_r],
//           clamped to +-grad_clamp when grad_clamp > 0
//   dh_r  = dl_r . W^T,  dpre_r = dh_r act'(h_r): (1 - h_r^2), or [h_r > 0]
//   denc[b, t] = sum_u dpre,  dpred[b, u] = sum_t dpre,
//   dW = sum_r h_r^T dl_r,  db = sum_r dl_r
// dl enters both products in bf16 (the TPU kernel casts it to W's dtype),
// db sums it in float32; all products accumulate in float32.
//
// Vocabulary slice, as in K1: W and bias may hold the columns of global ids
// [v0, v0 + V); a label or blank id outside them adds nothing to dl, and
// lse is the merged lse of the whole vocabulary (parallel/partition.py), so
// p_r is the global softmax on this slice's columns.  denc and dpred are
// then this slice's shares (the caller sums them over the slices); dW and
// db are the slice's own columns.  v0 = 0 over the whole V is the unsliced
// kernel.
//
// What bounds it on an H100: operations.  Three products of 2*N*H*V flops,
// N = B*T*U1: 8.2e11 flop at (4, 504, 65, 1024, 1024), 0.83 ms at 989
// TFLOP/s bf16; 2.1e11 at the banded (128, 16, 16) patches, 0.21 ms.
//
// Design.  The TPU kernel walks its grid in order and carries dW, db and
// dpred in VMEM from step to step; Hopper's blocks run in parallel, and a
// row tile's dh at H = 1024 in f32 does not fit in a block's shared memory.
// So K2 is four kernels on the stream, each parallel over its own output,
// around two bf16 workspaces written once: h (N, Hp) and dl (N, Vp), Hp and
// Vp the widths rounded up to 8 so that every row is a whole number of
// 16-byte TMA units (2 x 268 MB at the eval shape).  The three products
// are one GEMM mainloop (sm90_gemm.cuh: one producer thread issuing TMA
// loads into an mbarrier ring, two consumer warpgroups on wgmma, the tile
// handed to the epilogue through shared memory) with three problems that
// differ in their tensor maps, tile sizes and epilogues.  dl and dh have
// K = H or V = 1024, 16 k-blocks a 128 x 128 tile, so a block's pipeline
// fill and epilogue weigh as much as its mainloop: they run two blocks an
// SM (3 stages each), one hiding the other's.  dW has long k loops and
// runs one 128 x 256 block an SM (4 stages).
//   h pass:  h = bf16(tanh(bf16(enc + pred))), 16 bytes a thread, by the
//     device function K1 uses too (joint_h.cuh): tanh is
//     evaluated once per lattice element (the old dW pass redid it for
//     every tile of V), and no pass keeps an h tile in shared memory, so
//     no width caps H.
//   dl pass: logits = h . W (A = h, K-major; B = W as stored, MN-major);
//     the epilogue forms dl in place of the logits, stores it in bf16 with
//     coalesced stores (zero in the padding columns) and adds the
//     tile's column sums into db, one fp32 atomic per column per tile.
//   dh pass: dh = dl . W^T over lattice patches of 16 t x 8 u: the A tile
//     is two TMA boxes of a 4-D map over dl viewed as (B, T, U1, Vp), zero
//     past T and U1; B = W's rows, K-major.  The epilogue reads h once,
//     forms dpre = dh (1 - h^2) and sums it over the patch's u (denc) and t
//     (dpred) in shared memory, then adds the sums with coalesced fp32
//     atomics (16 + 8 rows of 128 per tile).
//   dW pass: dW = h^T . dl (A = h, MN-major; B = dl, MN-major) over the
//     32 output tiles at the eval widths, the rows split so that the grid
//     fills the SMs once (4 ways: 128 blocks); each block adds its tile
//     with coalesced fp32 atomics.
// Atomics make the order of the sums change from run to run, so every
// comparison with the plain version is a tolerance.

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "joint_h.cuh"
#include "sm90_gemm.cuh"

namespace {

using sm90::BK;
using sm90::BM;
using sm90::BOX;
using sm90::bf16;
using sm90::ldp;

// ------------------------------- h pass -------------------------------

// h = bf16(tanh(bf16(enc + pred))), rounded as K1 rounds it (joint_h.cuh).
__global__ void __launch_bounds__(256)
h_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ pred,
         bf16* __restrict__ h, int T, int U1, int Hp, int act) {
  joint::h_rows(enc, pred, h, T, U1, Hp, act);
}

// ------------------------------- dl pass -------------------------------

struct DlPass {
  static constexpr int BN = 128;
  static constexpr int STAGES = 3;
  // Two blocks an SM: one block's pipeline fill and epilogue run under
  // the other's mainloop (16 k-blocks a tile at V or H = 1024).
  static constexpr int CTAS = 2;
  static constexpr bool A_MN = false;  // h rows, 64 k of H each
  static constexpr bool B_MN = true;   // W (H, V) as stored: rows are k
  static constexpr int GROUPS = sm90::CONSUMERS / (BN / 8);  // row groups
  static constexpr int SCRATCH = GROUPS * BN;                // column sums
  struct Params {
    const float* bias;
    const int* labels;
    const float *lse, *g_blank, *g_label, *g_lse;
    bf16* dl;
    float* db;
    long long n_rows;
    int T, U1, V, Vp, blank, v0, k_blocks, n_nt;  // blank: a local column
    float clamp;
  };
  struct Tile {
    long long m0;
    int n0, k_blocks;
  };
  // Blocks walk V first, so the V tiles of one row tile (which share its
  // h rows) run together.
  static __device__ Tile tile(const Params& p) {
    return {(long long)(blockIdx.x / p.n_nt) * BM, (int)(blockIdx.x % p.n_nt) * BN,
            p.k_blocks};
  }
  static __device__ void load_a(const CUtensorMap* map, const Params&, const Tile& t,
                                int kb, int j, bf16* dst, uint64_t* bar) {
    sm90::tma_load_2d(dst, map, bar, kb * BK, (int)(t.m0 + j * BOX));
  }
  static __device__ void load_b(const CUtensorMap* map, const Params&, const Tile& t,
                                int kb, int j, bf16* dst, uint64_t* bar) {
    sm90::tma_load_2d(dst, map, bar, t.n0 + j * BOX, kb * BK);
  }
  // Thread = 8 columns x every GROUPS-th row of the tile; the rows' scalars
  // are loaded together first, so that their latencies overlap.
  static __device__ void epilogue(const Params& p, const Tile& t, float* acc,
                                  float* scratch, int tid) {
    constexpr int ROWS = BM / GROUPS;
    const int cc = (tid % (BN / 8)) * 8;
    const int c0 = t.n0 + cc;
    const int r0 = tid / (BN / 8);
    float bias[8], csum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      bias[e] = c0 + e < p.V ? p.bias[c0 + e] : 0.f;
      csum[e] = 0.f;
    }
    float lse[ROWS], gl[ROWS], gb[ROWS], ga[ROWS];
    int lab[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long row = t.m0 + r0 + i * GROUPS;
      const bool ok = row < p.n_rows;
      const int rw = ok ? (int)row : 0;  // the host keeps rows below 2^31
      lse[i] = ok ? p.lse[rw] : 0.f;
      gl[i] = ok ? p.g_lse[rw] : 0.f;
      gb[i] = ok ? p.g_blank[rw] : 0.f;
      ga[i] = ok ? p.g_label[rw] : 0.f;
      // The local column; one outside [0, V) matches no column below.
      lab[i] = ok ? p.labels[rw / (p.T * p.U1) * p.U1 + rw % p.U1] - p.v0 : -1;
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = r0 + i * GROUPS;
      const long long row = t.m0 + r;
      if (row >= p.n_rows || c0 >= p.Vp) continue;
      const float4 x0 = *reinterpret_cast<const float4*>(acc + r * ldp(BN) + cc);
      const float4 x1 = *reinterpret_cast<const float4*>(acc + r * ldp(BN) + cc + 4);
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      uint4 out;
      bf16* o8 = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + e;
        float v = 0.f;
        if (c < p.V) {
          v = gl[i] * expf(x[e] + bias[e] - lse[i]);
          if (c == p.blank) v += gb[i];
          if (c == lab[i]) v += ga[i];
          if (p.clamp > 0.f) v = fminf(fmaxf(v, -p.clamp), p.clamp);
        }
        csum[e] += v;
        o8[e] = __float2bfloat16(v);
      }
      *reinterpret_cast<uint4*>(p.dl + row * p.Vp + c0) = out;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) scratch[(tid / (BN / 8)) * BN + cc + e] = csum[e];
    sm90::consumer_sync();
    if (tid < BN && t.n0 + tid < p.V) {
      float s = 0.f;
      for (int g = 0; g < GROUPS; ++g) s += scratch[g * BN + tid];
      atomicAdd(p.db + t.n0 + tid, s);
    }
  }
};

// ------------------------------- dh pass -------------------------------

constexpr int PT = 16;  // patch: PT t x PU u = BM rows, row = t_local * PU + u_local
constexpr int PU = 8;

struct DhPass {
  static constexpr int BN = 128;
  static constexpr int STAGES = 3;
  static constexpr int CTAS = 2;  // as DlPass's
  static constexpr bool A_MN = false;  // dl rows, 64 k of V each
  static constexpr bool B_MN = false;  // W's rows h, 64 k of V each
  static constexpr int SCRATCH = 0;
  struct Params {
    const bf16* h;
    float *denc, *dpred;
    int T, U1, Hp, k_blocks, n_t, n_u, n_ht, act;
  };
  struct Tile {
    int b, t0, u0, h0, k_blocks;
  };
  // Blocks walk H first, so the H tiles of one patch (which share its dl
  // rows) run together.
  static __device__ Tile tile(const Params& p) {
    const int q = blockIdx.x / p.n_ht;
    return {q / (p.n_t * p.n_u), (q / p.n_u) % p.n_t * PT, q % p.n_u * PU,
            (int)(blockIdx.x % p.n_ht) * BN, p.k_blocks};
  }
  static __device__ void load_a(const CUtensorMap* map, const Params&, const Tile& t,
                                int kb, int j, bf16* dst, uint64_t* bar) {
    sm90::tma_load_4d(dst, map, bar, kb * BK, t.u0, t.t0 + j * (PT / 2), t.b);
  }
  static __device__ void load_b(const CUtensorMap* map, const Params&, const Tile& t,
                                int kb, int j, bf16* dst, uint64_t* bar) {
    sm90::tma_load_2d(dst, map, bar, kb * BK, t.h0 + j * BOX);
  }
  static __device__ void epilogue(const Params& p, const Tile& t, float* acc, float*,
                                  int tid) {
    // dpre = dh (1 - h^2) in place; thread = 4 columns (a float4, so that
    // a warp's accesses cover one row without bank conflicts, its h read 8
    // bytes a lane) of every GROUPS-th row, 8 rows' h loads issued first.
    // Rows off the lattice hold dh = 0 (TMA zero-filled their dl).
    constexpr int GROUPS = sm90::CONSUMERS / (BN / 4);
    constexpr int ROWS = BM / GROUPS;
    constexpr int BATCH = 8;
    const int cc = (tid % (BN / 4)) * 4;
    const int r0 = tid / (BN / 4);
#pragma unroll
    for (int i0 = 0; i0 < ROWS; i0 += BATCH) {
      uint2 hv[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int r = r0 + (i0 + i) * GROUPS;
        const int tt = t.t0 + r / PU, u = t.u0 + r % PU;
        hv[i] = make_uint2(0u, 0u);
        if (tt < p.T && u < p.U1 && t.h0 + cc < p.Hp) {
          const long long row = ((long long)t.b * p.T + tt) * p.U1 + u;
          hv[i] = *reinterpret_cast<const uint2*>(p.h + row * p.Hp + t.h0 + cc);
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const bf16* h4 = reinterpret_cast<const bf16*>(&hv[i]);
        float4* a = reinterpret_cast<float4*>(acc + (r0 + (i0 + i) * GROUPS) * ldp(BN) + cc);
        float4 v = *a;
        v.x *= joint::joint_dact(__bfloat162float(h4[0]), p.act);
        v.y *= joint::joint_dact(__bfloat162float(h4[1]), p.act);
        v.z *= joint::joint_dact(__bfloat162float(h4[2]), p.act);
        v.w *= joint::joint_dact(__bfloat162float(h4[3]), p.act);
        *a = v;
      }
    }
    sm90::consumer_sync();
    // Sums over the patch's u (denc) and t (dpred); thread = column x group.
    constexpr int G = sm90::CONSUMERS / BN;
    const int c = tid % BN, g = tid / BN;
    if (t.h0 + c >= p.Hp) return;
    for (int i = g * (PT / G); i < (g + 1) * (PT / G); ++i) {
      const int tt = t.t0 + i;
      if (tt >= p.T) break;
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < PU; ++u) s += acc[(i * PU + u) * ldp(BN) + c];
      atomicAdd(p.denc + ((long long)t.b * p.T + tt) * p.Hp + t.h0 + c, s);
    }
    for (int u = g * (PU / G); u < (g + 1) * (PU / G); ++u) {
      if (t.u0 + u >= p.U1) break;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PT; ++i) s += acc[(i * PU + u) * ldp(BN) + c];
      atomicAdd(p.dpred + ((long long)t.b * p.U1 + t.u0 + u) * p.Hp + t.h0 + c, s);
    }
  }
};

// ------------------------------- dW pass -------------------------------

struct DwPass {
  static constexpr int BN = 256;
  static constexpr int STAGES = 4;
  static constexpr int CTAS = 1;  // long k loops: the fill is paid once
  static constexpr bool A_MN = true;  // h (N, Hp): rows are k
  static constexpr bool B_MN = true;  // dl (N, Vp): rows are k
  static constexpr int SCRATCH = 0;
  struct Params {
    float* dw;
    long long n_rows, rows_per_split;
    int Hp, Vp, n_vt;
  };
  struct Tile {
    long long k0;
    int m0, n0, k_blocks;
  };
  static __device__ Tile tile(const Params& p) {
    const long long k0 = (long long)blockIdx.y * p.rows_per_split;
    const long long rest = p.n_rows - k0;
    const long long len = rest < p.rows_per_split ? rest : p.rows_per_split;
    return {k0, (int)blockIdx.x / p.n_vt * BM, (int)blockIdx.x % p.n_vt * BN,
            (int)((len + BK - 1) / BK)};
  }
  static __device__ void load_a(const CUtensorMap* map, const Params&, const Tile& t,
                                int kb, int j, bf16* dst, uint64_t* bar) {
    sm90::tma_load_2d(dst, map, bar, t.m0 + j * BOX, (int)(t.k0 + kb * BK));
  }
  static __device__ void load_b(const CUtensorMap* map, const Params&, const Tile& t,
                                int kb, int j, bf16* dst, uint64_t* bar) {
    sm90::tma_load_2d(dst, map, bar, t.n0 + j * BOX, (int)(t.k0 + kb * BK));
  }
  static __device__ void epilogue(const Params& p, const Tile& t, float* acc, float*,
                                  int tid) {
    const int c = tid % BN;
    if (t.n0 + c >= p.Vp) return;
    for (int r = tid / BN; r < BM && t.m0 + r < p.Hp; r += sm90::CONSUMERS / BN)
      atomicAdd(p.dw + (long long)(t.m0 + r) * p.Vp + t.n0 + c, acc[r * ldp(BN) + c]);
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// enc (B, T, Hp), pred (B, U1, Hp), w (Hp, Vp): bf16 contiguous, zero past
// the model's H and V (Hp, Vp multiples of 8); bias (V,) float32; labels
// (B, U1) int32; lse, g_blank, g_label, g_lse (B, T, U1) float32; h_ws
// (B*T*U1, Hp) and dl_ws (B*T*U1, Vp) bf16 workspaces.  denc (B, T, Hp),
// dpred (B, U1, Hp), dw (Hp, Vp), db (V,): float32, ZEROED by the caller
// (the passes add into them).  blank and the labels are global ids; W and
// bias hold the columns of ids [v0, v0 + V).  grad_clamp <= 0: no clamp.
// act: joint::ACT_TANH or ACT_RELU.
// Every bf16 pointer 16-byte aligned.  Returns the first CUDA error of the
// launches, or cudaErrorInvalidValue for a layout the tensor maps cannot
// take.
extern "C" int rnnt_joint_bwd(const void* enc, const void* pred, const void* w,
                              const void* bias, const void* labels, const void* lse,
                              const void* g_blank, const void* g_label,
                              const void* g_lse, void* h_ws, void* dl_ws, void* denc,
                              void* dpred, void* dw, void* db, int B, int T, int U1,
                              int Hp, int V, int Vp, int blank, int v0, float grad_clamp,
                              int act, void* stream) {
  const long long n_rows = (long long)B * T * U1;
  if (n_rows <= 0 || V <= 0 || Hp <= 0) return 0;
  // TMA coordinates and the grids are 32-bit.
  if (n_rows >= (1LL << 31) / 8 || Hp % 8 || Vp % 8 || Vp < V || v0 < 0 ||
      (act != joint::ACT_TANH && act != joint::ACT_RELU) || !aligned16(enc) ||
      !aligned16(pred) ||
      !aligned16(w) || !aligned16(h_ws) || !aligned16(dl_ws))
    return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* h = static_cast<bf16*>(h_ws);
  bf16* dl = static_cast<bf16*>(dl_ws);

  // 0. h, once.
  h_kernel<<<(unsigned)(B * T), 256, 0, s>>>(static_cast<const bf16*>(enc),
                                             static_cast<const bf16*>(pred), h, T, U1, Hp,
                                             act);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // The tensor maps: h and dl as 2-D (row-major), W, and dl as (B, T, U1, Vp).
  const uint32_t box2[2] = {BOX, BOX};
  const uint32_t box4[4] = {BOX, PU, PT / 2, 1};
  CUtensorMap map_h, map_w, map_dl, map_dl4;
  const uint64_t dims_h[2] = {(uint64_t)Hp, (uint64_t)n_rows};
  const uint64_t str_h[1] = {(uint64_t)Hp * 2};
  const uint64_t dims_w[2] = {(uint64_t)Vp, (uint64_t)Hp};
  const uint64_t str_w[1] = {(uint64_t)Vp * 2};
  const uint64_t dims_dl[2] = {(uint64_t)Vp, (uint64_t)n_rows};
  const uint64_t dims_dl4[4] = {(uint64_t)Vp, (uint64_t)U1, (uint64_t)T, (uint64_t)B};
  const uint64_t str_dl4[3] = {(uint64_t)Vp * 2, (uint64_t)U1 * Vp * 2,
                               (uint64_t)T * U1 * Vp * 2};
  if (!sm90::encode_map(&map_h, h, 2, dims_h, str_h, box2) ||
      !sm90::encode_map(&map_w, w, 2, dims_w, str_w, box2) ||
      !sm90::encode_map(&map_dl, dl, 2, dims_dl, str_w, box2) ||
      !sm90::encode_map(&map_dl4, dl, 4, dims_dl4, str_dl4, box4))
    return (int)cudaErrorInvalidValue;

  // 1. dl and db.
  const int n_nt = (Vp + DlPass::BN - 1) / DlPass::BN;
  DlPass::Params dlp{static_cast<const float*>(bias), static_cast<const int*>(labels),
                     static_cast<const float*>(lse), static_cast<const float*>(g_blank),
                     static_cast<const float*>(g_label), static_cast<const float*>(g_lse),
                     dl, static_cast<float*>(db), n_rows, T, U1, V, Vp, blank - v0, v0,
                     (Hp + BK - 1) / BK, n_nt, grad_clamp};
  err = sm90::launch_gemm<DlPass>(map_h, map_w, dlp,
                                  dim3((unsigned)((n_rows + BM - 1) / BM * n_nt)), s);
  if (err != cudaSuccess) return (int)err;

  // 2. dh -> denc, dpred, over (16 t x 8 u) patches.
  DhPass::Params dhp{h, static_cast<float*>(denc), static_cast<float*>(dpred), T, U1, Hp,
                     (Vp + BK - 1) / BK, (T + PT - 1) / PT, (U1 + PU - 1) / PU,
                     (Hp + DhPass::BN - 1) / DhPass::BN, act};
  const long long patches = (long long)B * dhp.n_t * dhp.n_u;
  err = sm90::launch_gemm<DhPass>(map_dl4, map_w, dhp,
                                  dim3((unsigned)(patches * dhp.n_ht)), s);
  if (err != cudaSuccess) return (int)err;

  // 3. dW, the rows split so that the grid fills the SMs about once.
  const int n_vt = (Vp + DwPass::BN - 1) / DwPass::BN;
  const int tiles = (Hp + BM - 1) / BM * n_vt;
  long long splits = std::max(1, n_sm / tiles);
  splits = std::min(splits, std::max(1LL, n_rows / (8 * BK)));
  long long per = (n_rows + splits - 1) / splits;
  per = (per + BK - 1) / BK * BK;
  splits = (n_rows + per - 1) / per;
  DwPass::Params dwp{static_cast<float*>(dw), n_rows, per, Hp, Vp, n_vt};
  return (int)sm90::launch_gemm<DwPass>(map_h, map_dl, dwp,
                                        dim3((unsigned)tiles, (unsigned)splits), s);
}

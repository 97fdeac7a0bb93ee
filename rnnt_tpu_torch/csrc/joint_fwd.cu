// K1: fused RNN-T joint, forward.
//
// Replaces rnnt_tpu/ops/transducer_pallas.py:65 _fwd_kernel (launcher
// _fwd_pallas:99, call :114).  For every lattice cell (row) r = (b, t, u):
//   h_r    = tanh(enc[b, t] + pred[b, u])            (bf16, joint_h.cuh)
//   logits = h_r . W + bias                           (fp32 sums)
//   lse[b, t, u]   = logsumexp over V of logits
//   blank[b, t, u] = logits[blank]
//   label[b, t, u] = logits[labels[b, u]]
// The (B, T, U1, V) logits never reach device memory: the outputs are three
// (B, T, U1) float32 arrays.  The label column is read from int32 ids and
// the blank index where the TPU kernel takes one-hot operands.
//
// Vocabulary slice.  W and bias may be a tensor-parallel rank's V columns
// of a wider vocabulary, starting at global id v0: a label or blank id
// counts in column id - v0 when that lies in [0, V), and a slice that owns
// neither writes 0 for that logit (the TPU kernel's V-sharded one-hots give
// the same zeros).  The lse is then the slice's; the caller merges the
// slices' outputs (parallel/partition.py).  v0 = 0 over the whole V is the
// unsliced kernel, bit for bit.
//
// What bounds it on an H100: operations.  2*B*T*U1*H*V flops: 2.75e11 at
// (4, 504, 65, 1024, 1024), 0.28 ms at 989 TFLOP/s dense bf16, against
// ~1.6 MB of output.
//
// Design.  Two kernels on the stream.
//   h pass: h = bf16(tanh(bf16(enc + pred))) into a bf16 workspace (N, Hp),
//     N = B*T*U1, Hp = H rounded up to 8, by the device function K2's h
//     pass uses (joint_h.cuh), so that K2's softmax, formed against this
//     kernel's lse, sums to 1.
//   lse pass: h . W on the TMA-fed, warp-specialised wgmma mainloop K2's
//     products share (sm90_gemm.cuh), through its walking hook: one block
//     (one an SM) per 128-row tile walks every 256-wide V tile (16
//     k-blocks each at H = 1024), the (V tile, k-block) pairs streaming
//     through one 4-stage ring, so that the next V tile's loads land
//     while this tile's epilogue runs.
//     The epilogue works on the wgmma accumulator in registers: each
//     thread holds 2 rows x 64 columns of the tile, a row's columns spread
//     over the 4 lanes of a quad.  It adds the bias (-inf past V, so
//     padding columns leave the max and the sum), takes the tile's row max
//     over the quad (two shuffles), rescales the thread's running sum of
//     exp2((x - max) log2 e) and adds the tile's terms, and keeps the
//     blank and label logits where its columns hold them.  After a row
//     tile's last V tile the quad sums its shares: lse = max + log(sum).
// No shared-memory round trip of the tile and no merge pass; W (2 MB) and
// the row tile's h stay in L2 across the V walk.  Rows are indexed in 32
// bits; the wrapper and the entry point refuse N >= 2^28.
//
// Measured and not kept (PERF.md): two blocks an SM on 128-wide V
// tiles; two 128-wide accumulators with the next V tile's first k-blocks
// issued under this tile's epilogue (ptxas injected a wgmma wait there,
// and 128-wide tiles ran the products slower); a persistent grid walking
// several row tiles a block (no faster); a 3-stage ring; exps as one
// ex2.approx.ftz each (no faster).

#include <math.h>
#include <stdint.h>

#include "joint_h.cuh"
#include "sm90_gemm.cuh"

namespace {

using sm90::BK;
using sm90::BM;
using sm90::BOX;
using sm90::bf16;

// ------------------------------- h pass -------------------------------

__global__ void __launch_bounds__(256)
fwd_h_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ pred,
             bf16* __restrict__ h, int T, int U1, int Hp) {
  joint::h_rows(enc, pred, h, T, U1, Hp);
}

// ------------------------------- lse pass -------------------------------

struct LsePass {
  static constexpr int BN = 256;
  static constexpr int STAGES = 4;
  static constexpr int CTAS = 1;
  static constexpr bool A_MN = false;  // h rows, 64 k of H each
  static constexpr bool B_MN = true;   // W (Hp, Vp) as stored: rows are k
  static constexpr int SCRATCH = 0;
  static constexpr float LOG2E = 1.4426950408889634f;
  struct Params {
    const float* bias;
    const int* labels;
    float *lse, *blank_out, *label_out;
    long long n_rows;
    int T, U1, V, blank, v0, k_blocks, n_vt;  // blank: a local column or -1
  };
  // Block b walks the V tiles of row tile b.
  struct Tile {
    long long m0;
    int n0, k_blocks, n_tiles;
  };
  // The thread's two rows: the running max over the V tiles so far (the
  // same in the quad's 4 lanes), its share of the sum of exp(x - max),
  // the blank and label logits where its columns held them (0 elsewhere),
  // and the row's label column (-1 past the lattice or outside the slice).
  struct State {
    float m[2], s[2], blank[2], label[2];
    int lab[2];
  };

  static __device__ Tile tile(const Params& p) {
    return {(long long)blockIdx.x * BM, 0, p.k_blocks, p.n_vt};
  }
  static __device__ Tile nth(const Tile& t, int i) {
    return {t.m0, i * BN, t.k_blocks, t.n_tiles};
  }
  static __device__ void load_a(const CUtensorMap* map, const Params&, const Tile& t,
                                int kb, int j, bf16* dst, uint64_t* bar) {
    sm90::tma_load_2d(dst, map, bar, kb * BK, (int)(t.m0 + j * BOX));
  }
  static __device__ void load_b(const CUtensorMap* map, const Params&, const Tile& t,
                                int kb, int j, bf16* dst, uint64_t* bar) {
    sm90::tma_load_2d(dst, map, bar, t.n0 + j * BOX, kb * BK);
  }

  // Row of the tile that acc[0] of thread tid belongs to (the other is + 8).
  static __device__ __forceinline__ int first_row(int tid) {
    return (tid / 128) * 64 + (tid % 128) / 32 * 16 + (tid % 32) / 4;
  }

  // A row tile's first V tile: the state of its rows.
  static __device__ __forceinline__ void begin(const Params& p, const Tile& t, State& st,
                                               int tid) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = t.m0 + first_row(tid) + 8 * r;
      st.m[r] = -INFINITY;
      st.s[r] = 0.f;
      st.blank[r] = 0.f;
      st.label[r] = 0.f;
      st.lab[r] = -1;
      if (row < p.n_rows) {
        const int rw = (int)row;  // the host keeps rows below 2^28
        const int col = p.labels[rw / (p.T * p.U1) * p.U1 + rw % p.U1] - p.v0;
        st.lab[r] = col >= 0 && col < p.V ? col : -1;
      }
    }
  }

  // Where column `col` lies among this thread's: its j (acc[4j + e] and
  // acc[4j + 2 + e]) and e, or j = -1 when another lane or tile holds it.
  static __device__ __forceinline__ void locate(int col, int c_first, int& j, int& e) {
    const int d = col - c_first;
    j = (d >= 0 && d < BN && (d & 7) < 2) ? d >> 3 : -1;
    e = d & 1;
  }

  static __device__ __forceinline__ void reg_epilogue(const Params& p, const Tile& t,
                                                      float (&acc)[BN / 2], State& st,
                                                      int tid) {
    if (t.n0 == 0) begin(p, t, st, tid);
    const int c_first = t.n0 + 2 * (tid % 4);  // the column of acc[0]
    int jb, eb, jl0, el0, jl1, el1;
    locate(p.blank, c_first, jb, eb);
    locate(st.lab[0], c_first, jl0, el0);
    locate(st.lab[1], c_first, jl1, el1);
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c_first + j * 8;
      float2 b;
      if (c + 1 < p.V) {
        b = __ldg(reinterpret_cast<const float2*>(p.bias + c));
      } else {
        b.x = c < p.V ? __ldg(p.bias + c) : -INFINITY;
        b.y = -INFINITY;
      }
      acc[4 * j] += b.x;
      acc[4 * j + 1] += b.y;
      acc[4 * j + 2] += b.x;
      acc[4 * j + 3] += b.y;
      mt0 = fmaxf(mt0, fmaxf(acc[4 * j], acc[4 * j + 1]));
      mt1 = fmaxf(mt1, fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
      if (j == jb) {
        st.blank[0] = eb ? acc[4 * j + 1] : acc[4 * j];
        st.blank[1] = eb ? acc[4 * j + 3] : acc[4 * j + 2];
      }
      if (j == jl0) st.label[0] = el0 ? acc[4 * j + 1] : acc[4 * j];
      if (j == jl1) st.label[1] = el1 ? acc[4 * j + 3] : acc[4 * j + 2];
    }
    // Every V tile holds a column below V, so the new max is finite.
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 1));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 1));
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, 2));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, 2));
    const float m0 = fmaxf(st.m[0], mt0), m1 = fmaxf(st.m[1], mt1);
    // exp2(-inf) = 0: the first tile's rescale of an empty sum.
    float s0 = st.s[0] * exp2f((st.m[0] - m0) * LOG2E);
    float s1 = st.s[1] * exp2f((st.m[1] - m1) * LOG2E);
    st.m[0] = m0;
    st.m[1] = m1;
    const float n0 = -m0 * LOG2E, n1 = -m1 * LOG2E;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s0 += exp2f(fmaf(acc[4 * j], LOG2E, n0)) + exp2f(fmaf(acc[4 * j + 1], LOG2E, n0));
      s1 += exp2f(fmaf(acc[4 * j + 2], LOG2E, n1)) + exp2f(fmaf(acc[4 * j + 3], LOG2E, n1));
    }
    st.s[0] = s0;
    st.s[1] = s1;
    if (t.n0 + BN >= p.V) finish(p, t, st, tid);
  }

  // A row tile's last V tile: the quad sums its shares, lse = max + log(sum).
  static __device__ __forceinline__ void finish(const Params& p, const Tile& t, State& st,
                                                int tid) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = st.s[r], bl = st.blank[r], lb = st.label[r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        bl += __shfl_xor_sync(0xffffffffu, bl, off);
        lb += __shfl_xor_sync(0xffffffffu, lb, off);
      }
      const long long row = t.m0 + first_row(tid) + 8 * r;
      if (tid % 4 == 0 && row < p.n_rows) {
        p.lse[row] = st.m[r] + logf(s);
        p.blank_out[row] = bl;
        p.label_out[row] = lb;
      }
    }
  }
};

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// enc (B, T, Hp), pred (B, U1, Hp), w (Hp, Vp): bf16 contiguous, zero past
// the model's H and V (Hp, Vp multiples of 8), 16-byte aligned; bias (V,)
// float32, 8-byte aligned; labels (B, U1) int32; h_ws (B*T*U1, Hp) bf16
// workspace, 16-byte aligned; lse, blank_out, label_out (B, T, U1)
// float32.  blank and the labels are global ids; W and bias hold the
// columns of ids [v0, v0 + V).  Returns the first CUDA error of the two
// launches, or cudaErrorInvalidValue for a layout or size the kernels do
// not take.
extern "C" int rnnt_joint_fwd(const void* enc, const void* pred, const void* w,
                              const void* bias, const void* labels, void* h_ws, void* lse,
                              void* blank_out, void* label_out, int B, int T, int U1,
                              int Hp, int V, int Vp, int blank, int v0, void* stream) {
  const long long n_rows = (long long)B * T * U1;
  if (n_rows <= 0 || V <= 0 || Hp <= 0) return 0;
  if (n_rows >= (1LL << 31) / 8 || Hp % 8 || Vp % 8 || Vp < V || blank < 0 || v0 < 0 ||
      !aligned(enc, 16) || !aligned(pred, 16) || !aligned(w, 16) || !aligned(h_ws, 16) ||
      !aligned(bias, 8))
    return (int)cudaErrorInvalidValue;
  const int blank_col = blank - v0 >= 0 && blank - v0 < V ? blank - v0 : -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* h = static_cast<bf16*>(h_ws);

  fwd_h_kernel<<<(unsigned)(B * T), 256, 0, s>>>(static_cast<const bf16*>(enc),
                                                 static_cast<const bf16*>(pred), h, T, U1,
                                                 Hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const uint32_t box[2] = {BOX, BOX};
  const uint64_t dims_h[2] = {(uint64_t)Hp, (uint64_t)n_rows};
  const uint64_t str_h[1] = {(uint64_t)Hp * 2};
  const uint64_t dims_w[2] = {(uint64_t)Vp, (uint64_t)Hp};
  const uint64_t str_w[1] = {(uint64_t)Vp * 2};
  CUtensorMap map_h, map_w;
  if (!sm90::encode_map(&map_h, h, 2, dims_h, str_h, box) ||
      !sm90::encode_map(&map_w, w, 2, dims_w, str_w, box))
    return (int)cudaErrorInvalidValue;
  LsePass::Params prm{static_cast<const float*>(bias), static_cast<const int*>(labels),
                      static_cast<float*>(lse), static_cast<float*>(blank_out),
                      static_cast<float*>(label_out), n_rows, T, U1, V, blank_col, v0,
                      (Hp + BK - 1) / BK, (V + LsePass::BN - 1) / LsePass::BN};
  return (int)sm90::launch_gemm<LsePass>(map_h, map_w, prm,
                                         dim3((unsigned)((n_rows + BM - 1) / BM)), s);
}

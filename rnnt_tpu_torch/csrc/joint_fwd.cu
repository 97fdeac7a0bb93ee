// K1: fused RNN-T joint, forward.
//
// Replaces rnnt_tpu/ops/transducer_pallas.py:65 _fwd_kernel (launcher
// _fwd_pallas:99, call :114).  For every lattice cell (b, t, u):
//   h      = tanh(enc[b, t] + pred[b, u])            (bf16, as in torch)
//   logits = h . W + bias                             (fp32 sums)
//   lse[b, t, u]   = logsumexp over V of logits
//   blank[b, t, u] = logits[blank]
//   label[b, t, u] = logits[labels[b, u]]
// The (B, T, U1, V) logits never reach device memory: the outputs are three
// (B, T, U1) float32 arrays.  The label column is read from int32 ids and
// the blank index (the TPU kernel's one-hot operands exist only for its
// vocabulary sharding; the function is the same).
//
// What bounds it on an H100: operations.  2*B*T*U1*H*V flops — 2.75e11 at
// (4, 504, 65, 1024, 1024), 0.28 ms at 989 TFLOP/s dense bf16 — against
// ~1.6 MB of output.  Design: the B*T*U1 cells are flattened and cut into
// tiles of 64 rows (32 when H is too wide for shared memory), one block of
// 8 warps per tile, so ragged T and U need no padding.  The block stages
// tanh(enc + pred) for its rows in shared memory once, then walks V in
// chunks of 128 columns.  W streams through a 3-stage ring of 64-row slabs
// filled by cp.async, so the next slabs load while the tensor cores
// (ldmatrix + mma.sync m16n8k16 bf16, fp32 accumulators; each warp a
// 32-row block of the chunk) work on the current one; the (chunk, slab)
// sequence is one pipeline, so the next chunk's loads overlap this chunk's
// softmax.  Each finished chunk goes through shared memory into an online
// max / sum-of-exp per row, held in registers by the warp that owns the
// row, and the blank and label columns are caught as they pass.  wgmma and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int N_TILE = 128;  // V columns per chunk
constexpr int K_SLAB = 64;   // rows of W per pipeline stage
constexpr int STAGES = 3;
constexpr int H_PAD = 8;     // bf16 padding per staged row (bank spread)
constexpr int W_LD = N_TILE + 8;
constexpr int L_LD = N_TILE + 8;

// WARPS_M warps along the tile's rows, the rest along its 128 columns;
// every warp owns FRAG_M x FRAG_N m16n8 accumulators.
template <int WARPS_M>
struct Tile {
  static constexpr int WARPS_N = WARPS / WARPS_M;
  static constexpr int FRAG_M = 2;
  static constexpr int FRAG_N = N_TILE / 8 / WARPS_N;  // even
  static constexpr int M_TILE = WARPS_M * FRAG_M * 16;
  static constexpr int ROWS_PER_WARP = M_TILE / WARPS;  // softmax rows
  // h tile, W ring, one chunk of logits.
  static size_t smem_bytes(int h_ld) {
    return (size_t)M_TILE * h_ld * 2 + (size_t)STAGES * K_SLAB * W_LD * 2 +
           (size_t)M_TILE * L_LD * 4;
  }
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 16 at column
// offset (l / 16) * 8 of a 16x16 block.  Plain: the mma A fragment of a
// row-major block.  Transposed: two mma B fragments (columns 0-7, 8-15) of
// a row-major [k][n] block.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The sum rounded to bf16, then tanh rounded to bf16: torch's rounding of
// tanh(enc + pred) on bf16 tensors.
__device__ __forceinline__ __nv_bfloat16 joint_h(__nv_bfloat16 e,
                                                 __nv_bfloat16 p) {
  const float s = __bfloat162float(
      __float2bfloat16(__bfloat162float(e) + __bfloat162float(p)));
  return __float2bfloat16(tanhf(s));
}

// W[k0 : k0 + K_SLAB, n0 : n0 + N_TILE] into one ring slot, zero outside
// H x V.  With w_vec (V % 8 == 0, W 16-byte aligned) by cp.async, else by
// plain loads and stores.
__device__ __forceinline__ void load_w_slab(__nv_bfloat16* dst,
                                            const __nv_bfloat16* w, int k0,
                                            int n0, int H, int V, int w_vec,
                                            int tid) {
  constexpr int PIECES = K_SLAB * N_TILE / 8;  // 16-byte pieces
  for (int i = tid; i < PIECES; i += THREADS) {
    const int kk = i / (N_TILE / 8);
    const int nn = (i % (N_TILE / 8)) * 8;
    const int k = k0 + kk;
    const int n = n0 + nn;
    __nv_bfloat16* d = dst + kk * W_LD + nn;
    if (w_vec) {
      const bool in = k < H && n < V;  // V % 8 == 0: all 8 or none
      cp_async16(d, in ? w + (size_t)k * V + n : w, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (k < H && n + j < V) ? w[(size_t)k * V + n + j]
                                    : __float2bfloat16(0.f);
    }
  }
}

template <int WARPS_M>
__global__ void __launch_bounds__(THREADS)
joint_fwd_kernel(const __nv_bfloat16* __restrict__ enc,
                 const __nv_bfloat16* __restrict__ pred,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias,
                 const int* __restrict__ labels, float* __restrict__ lse_out,
                 float* __restrict__ blank_out, float* __restrict__ label_out,
                 int B, int T, int U1, int H, int V, int blank, int h_ld,
                 int w_vec, int h_vec) {
  using Tl = Tile<WARPS_M>;
  constexpr int M_TILE = Tl::M_TILE;
  constexpr int FRAG_M = Tl::FRAG_M;
  constexpr int FRAG_N = Tl::FRAG_N;
  constexpr int RPW = Tl::ROWS_PER_WARP;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = h_s + (size_t)M_TILE * h_ld;
  float* l_s = reinterpret_cast<float*>(w_s + STAGES * K_SLAB * W_LD);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int warp_m = warp / Tl::WARPS_N;
  const int warp_n = warp % Tl::WARPS_N;
  const long long n_rows = (long long)B * T * U1;
  const long long row0 = (long long)blockIdx.x * M_TILE;
  const int h_cols = h_ld - H_PAD;  // H rounded up to K_SLAB, zero-filled
  const int S = h_cols / K_SLAB;    // slabs per chunk
  const int total = S * ((V + N_TILE - 1) / N_TILE);

  // Start the first slabs of W while h is staged.
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < total)
      load_w_slab(w_s + j * K_SLAB * W_LD, w, (j % S) * K_SLAB,
                  (j / S) * N_TILE, H, V, w_vec, tid);
    cp_async_commit();
  }

  // h = tanh(enc + pred) in bf16; rows past the lattice and columns past H
  // are zero.
  for (int r = warp; r < M_TILE; r += WARPS) {
    const long long row = row0 + r;
    __nv_bfloat16* hr = h_s + (size_t)r * h_ld;
    if (row < n_rows) {
      const int u = (int)(row % U1);
      const long long bt = row / U1;  // b * T + t
      const long long bi = bt / T;
      const __nv_bfloat16* er = enc + bt * H;
      const __nv_bfloat16* pr = pred + (bi * U1 + u) * H;
      if (h_vec) {
        for (int k = lane * 8; k < h_cols; k += 32 * 8) {
          uint4 out = make_uint4(0u, 0u, 0u, 0u);
          if (k < H) {  // H % 8 == 0: all 8 columns are in range
            const uint4 ev = *reinterpret_cast<const uint4*>(er + k);
            const uint4 pv = *reinterpret_cast<const uint4*>(pr + k);
            const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&ev);
            const __nv_bfloat16* p8 = reinterpret_cast<const __nv_bfloat16*>(&pv);
            __nv_bfloat16* o8 = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
            for (int j = 0; j < 8; ++j) o8[j] = joint_h(e8[j], p8[j]);
          }
          *reinterpret_cast<uint4*>(hr + k) = out;
        }
      } else {
        for (int k = lane; k < h_cols; k += 32)
          hr[k] = k < H ? joint_h(er[k], pr[k]) : __float2bfloat16(0.f);
      }
    } else {
      for (int k = lane; k < h_cols; k += 32) hr[k] = __float2bfloat16(0.f);
    }
  }

  // Softmax state of this warp's rows, the same in every lane except the
  // caught blank / label logits, which only the lane that saw the column
  // holds (summed over the warp at the end).
  float r_max[RPW], r_sum[RPW], r_blank[RPW], r_label[RPW];
  int r_lab[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const long long row = row0 + warp * RPW + rr;
    r_max[rr] = -INFINITY;
    r_sum[rr] = 0.f;
    r_blank[rr] = 0.f;
    r_label[rr] = 0.f;
    r_lab[rr] = -1;
    if (row < n_rows) {
      const long long bt = row / U1;
      r_lab[rr] = labels[(bt / T) * U1 + (int)(row % U1)];
    }
  }

  const int m_base = warp_m * FRAG_M * 16;
  const int n_base = warp_n * FRAG_N * 8;
  float acc[FRAG_M][FRAG_N][4];
  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();  // slab i has landed (this thread's part)
    __syncthreads();  // ... every thread's part; slot (i - 1) % STAGES free
    {
      const int j = i + STAGES - 1;
      if (j < total)
        load_w_slab(w_s + (j % STAGES) * K_SLAB * W_LD, w, (j % S) * K_SLAB,
                    (j / S) * N_TILE, H, V, w_vec, tid);
      cp_async_commit();  // possibly empty: keeps one group per iteration
    }
    const int slab = i % S;
    if (slab == 0) {
#pragma unroll
      for (int fm = 0; fm < FRAG_M; ++fm)
#pragma unroll
        for (int fn = 0; fn < FRAG_N; ++fn)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[fm][fn][q] = 0.f;
    }
    const __nv_bfloat16* ws = w_s + (i % STAGES) * K_SLAB * W_LD;
    const int k0 = slab * K_SLAB;
    const int lrow = lane % 16;
    const int lcol = (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < K_SLAB; kk += 16) {
      unsigned a[FRAG_M][4];
      unsigned b[FRAG_N / 2][4];
#pragma unroll
      for (int fm = 0; fm < FRAG_M; ++fm)
        ldmatrix_x4(a[fm], smem_addr(h_s + (size_t)(m_base + fm * 16 + lrow) * h_ld +
                                     k0 + kk + lcol));
#pragma unroll
      for (int fp = 0; fp < FRAG_N / 2; ++fp)
        ldmatrix_x4_trans(b[fp], smem_addr(ws + (kk + lrow) * W_LD + n_base +
                                           fp * 16 + lcol));
#pragma unroll
      for (int fm = 0; fm < FRAG_M; ++fm)
#pragma unroll
        for (int fn = 0; fn < FRAG_N; ++fn)
          mma_bf16(acc[fm][fn], a[fm], b[fn / 2][(fn % 2) * 2],
                   b[fn / 2][(fn % 2) * 2 + 1]);
    }
    if (slab != S - 1) continue;

    // The chunk's logits are complete: through shared memory into the
    // online logsumexp.  Accumulator q of a lane sits at row lane / 4
    // (+ 8 for q >= 2), column 2 * (lane % 4) + q % 2 of its m16n8 block.
#pragma unroll
    for (int fm = 0; fm < FRAG_M; ++fm)
#pragma unroll
      for (int fn = 0; fn < FRAG_N; ++fn) {
        float* dst = l_s + (m_base + fm * 16 + lane / 4) * L_LD + n_base +
                     fn * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[fm][fn][0], acc[fm][fn][1]);
        *reinterpret_cast<float2*>(dst + 8 * L_LD) =
            make_float2(acc[fm][fn][2], acc[fm][fn][3]);
      }
    __syncthreads();
    // Each lane holds 4 consecutive columns of the rows it reduces.
    const int c = (i / S) * N_TILE + lane * 4;
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = c + j < V ? bias[c + j] : 0.f;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const float4 v4 = *reinterpret_cast<const float4*>(l_s + r * L_LD + lane * 4);
      float x[4] = {v4.x, v4.y, v4.z, v4.w};
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = c + j < V ? x[j] + bv[j] : -INFINITY;
        m = fmaxf(m, x[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      // Every chunk holds at least one column below V, so m is finite.
      const float m_new = fmaxf(r_max[rr], m);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += expf(x[j] - m_new);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      r_sum[rr] = r_sum[rr] * expf(r_max[rr] - m_new) + s;  // exp(-inf) = 0
      r_max[rr] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j == blank) r_blank[rr] = x[j];
        if (c + j == r_lab[rr]) r_label[rr] = x[j];
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    float bl = r_blank[rr];
    float lb = r_label[rr];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      bl += __shfl_xor_sync(0xffffffffu, bl, off);
      lb += __shfl_xor_sync(0xffffffffu, lb, off);
    }
    const long long row = row0 + warp * RPW + rr;
    if (lane == 0 && row < n_rows) {
      lse_out[row] = r_max[rr] + logf(r_sum[rr]);
      blank_out[row] = bl;
      label_out[row] = lb;
    }
  }
}

template <int WARPS_M>
cudaError_t launch(const void* enc, const void* pred, const void* w,
                   const void* bias, const void* labels, void* lse,
                   void* blank_out, void* label_out, int B, int T, int U1,
                   int H, int V, int blank, int h_ld, int w_vec, int h_vec,
                   size_t smem, cudaStream_t stream) {
  auto kernel = joint_fwd_kernel<WARPS_M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_rows = (long long)B * T * U1;
  const long long grid = (n_rows + Tile<WARPS_M>::M_TILE - 1) / Tile<WARPS_M>::M_TILE;
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(enc),
      static_cast<const __nv_bfloat16*>(pred),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<float*>(lse),
      static_cast<float*>(blank_out), static_cast<float*>(label_out), B, T, U1,
      H, V, blank, h_ld, w_vec, h_vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// enc (B, T, H), pred (B, U1, H), w (H, V): bf16 contiguous; bias (V,)
// float32; labels (B, U1) int32; lse/blank_out/label_out (B, T, U1)
// float32.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when H is too wide for shared memory.
extern "C" int rnnt_joint_fwd(const void* enc, const void* pred, const void* w,
                              const void* bias, const void* labels, void* lse,
                              void* blank_out, void* label_out, int B, int T,
                              int U1, int H, int V, int blank, void* stream) {
  if ((long long)B * T * U1 <= 0 || V <= 0 || H <= 0) return 0;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int h_ld = round_up(H, K_SLAB) + H_PAD;
  const int w_vec = V % 8 == 0 && aligned16(w);
  const int h_vec = H % 8 == 0 && aligned16(enc) && aligned16(pred);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tile<2>::smem_bytes(h_ld) <= (size_t)max_smem)
    return (int)launch<2>(enc, pred, w, bias, labels, lse, blank_out, label_out,
                          B, T, U1, H, V, blank, h_ld, w_vec, h_vec,
                          Tile<2>::smem_bytes(h_ld), s);
  if (Tile<1>::smem_bytes(h_ld) <= (size_t)max_smem)
    return (int)launch<1>(enc, pred, w, bias, labels, lse, blank_out, label_out,
                          B, T, U1, H, V, blank, h_ld, w_vec, h_vec,
                          Tile<1>::smem_bytes(h_ld), s);
  return (int)cudaErrorInvalidValue;
}

// K2: fused RNN-T joint, backward.
//
// Replaces rnnt_tpu/ops/transducer_pallas.py:155 _bwd_kernel (launcher
// _bwd_pallas:280, call :333).  For every lattice cell (row) r = (b, t, u):
//   h_r   = tanh(enc[b, t] + pred[b, u])              (bf16, as K1 rounds it)
//   p_r   = exp(h_r . W + bias - lse_r)                (softmax from K1's lse)
//   dl_r  = g_lse_r p_r + g_blank_r 1[blank] + g_label_r 1[label_r],
//           clamped to +-grad_clamp when grad_clamp > 0
//   dh_r  = dl_r . W^T,  dpre_r = dh_r (1 - h_r^2)
//   denc[b, t] = sum_u dpre,  dpred[b, u] = sum_t dpre,
//   dW = sum_r h_r^T dl_r,  db = sum_r dl_r
// dl enters both products in bf16 (the TPU kernel casts it to W's dtype),
// db sums it in float32; all products accumulate in float32.
//
// What bounds it on an H100: operations.  Three products of 2*N*H*V flops,
// N = B*T*U1: 8.2e11 flop at (4, 504, 65, 1024, 1024), 0.83 ms at 989
// TFLOP/s bf16; 2.1e11 at the banded (128, 16, 16) patches, 0.21 ms.
//
// Design.  The TPU kernel walks its grid in order and carries dW, db and
// dpred in VMEM from step to step; Hopper's blocks run in parallel, and a
// 64-row tile's dh at H = 1024 in f32 (256 KB) does not fit in a block's
// shared memory.  So the three products are three kernels on the stream,
// each parallel over its own output, with the (N, V) dl written once in
// bf16 to a workspace in between (2 bytes per logit: 268 MB at the eval
// shape, one write and two reads, ~0.24 ms of traffic at 3.35 TB/s):
//   dl_kernel: K1's tiling — 64 flattened rows per block, tanh rows staged
//     in shared memory once, W streamed through a 3-stage cp.async ring,
//     ldmatrix + mma.sync m16n8k16 — recomputes each 64 x 128 chunk of
//     logits, forms dl in registers, stores it in bf16 and adds the block's
//     column sums into db (fp32 atomics).
//   dh_kernel: dh = dl . W^T over (8 t x 8 u) lattice patches x 128 columns
//     of H; the epilogue recomputes h, forms dpre, sums it over the patch's
//     u (for denc) and t (for dpred) in shared memory and adds those sums
//     with fp32 atomics (2 x 8 per column per block).
//   dw_kernel: dW = h^T . dl over 64 x 128 output tiles, the rows split S
//     ways for parallelism; h is recomputed per slab of 32 rows, dl streams
//     in by cp.async; each block adds its partial tile with fp32 atomics.
// Atomics make the order of the sums change from run to run, so every
// comparison with the plain version is a tolerance.  Ragged T and U1 need
// no padding: the rows are flattened (or patched and masked).  wgmma and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int WARPS_N = 4;
constexpr int FRAG_M = 2;     // m16 blocks per warp
constexpr int FRAG_N = 4;     // n8 blocks per warp
constexpr int BM = 64;        // tile rows
constexpr int BN = 128;       // tile columns
constexpr int PAD = 8;        // bf16 padding per staged row (bank spread)

// dl_kernel
constexpr int K_SLAB = 64;    // rows of W per ring stage
constexpr int STAGES = 3;
constexpr int W_LD = BN + PAD;
// dh_kernel / dw_kernel
constexpr int BK = 32;        // depth of a staged slab
constexpr int PT = 8;         // dh_kernel patch: PT t x PT u = BM rows
constexpr int DP_LD = BN + 4;

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

// Fragments of one 16 x 16 step, from shared tiles in either layout.  A:
// [m][k] (plain ldmatrix) or [k][m] (transposed); B: [k][n] (transposed)
// or [n][k] (plain).  For B, r[0..1] are columns n0..n0+7, r[2..3] the
// next eight.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* s, int ld,
                                       bool km, int m0, int k0, int lane) {
  if (km)
    ldmatrix_x4_trans(a, smem_addr(s + (size_t)(k0 + lane % 8 + (lane / 16) * 8) * ld +
                                   m0 + ((lane / 8) % 2) * 8));
  else
    ldmatrix_x4(a, smem_addr(s + (size_t)(m0 + lane % 16) * ld + k0 + (lane / 16) * 8));
}

__device__ __forceinline__ void load_b(unsigned (&b)[4], const bf16* s, int ld,
                                       bool nk, int k0, int n0, int lane) {
  if (nk)
    ldmatrix_x4(b, smem_addr(s + (size_t)(n0 + lane % 8 + (lane / 16) * 8) * ld +
                             k0 + ((lane / 8) % 2) * 8));
  else
    ldmatrix_x4_trans(b, smem_addr(s + (size_t)(k0 + lane % 16) * ld + n0 +
                                   (lane / 16) * 8));
}

// acc[fm][fn] += A[m_base + 16 fm, ka : ka + 16] . B[kb : kb + 16, n_base + 8 fn].
__device__ __forceinline__ void warp_mma16(float (&acc)[FRAG_M][FRAG_N][4],
                                           const bf16* As, int lda, bool a_km,
                                           int ka, const bf16* Bs, int ldb,
                                           bool b_nk, int kb, int m_base,
                                           int n_base, int lane) {
  unsigned a[FRAG_M][4];
  unsigned b[FRAG_N / 2][4];
#pragma unroll
  for (int fm = 0; fm < FRAG_M; ++fm)
    load_a(a[fm], As, lda, a_km, m_base + fm * 16, ka, lane);
#pragma unroll
  for (int fp = 0; fp < FRAG_N / 2; ++fp)
    load_b(b[fp], Bs, ldb, b_nk, kb, n_base + fp * 16, lane);
#pragma unroll
  for (int fm = 0; fm < FRAG_M; ++fm)
#pragma unroll
    for (int fn = 0; fn < FRAG_N; ++fn)
      mma_bf16(acc[fm][fn], a[fm], b[fn / 2][(fn % 2) * 2],
               b[fn / 2][(fn % 2) * 2 + 1]);
}

__device__ __forceinline__ void zero_acc(float (&acc)[FRAG_M][FRAG_N][4]) {
#pragma unroll
  for (int fm = 0; fm < FRAG_M; ++fm)
#pragma unroll
    for (int fn = 0; fn < FRAG_N; ++fn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[fm][fn][q] = 0.f;
}

// K1's rounding of tanh(enc + pred) on bf16 tensors: the sum rounded to
// bf16, then tanh rounded to bf16.
__device__ __forceinline__ bf16 joint_h(bf16 e, bf16 p) {
  const float s = __bfloat162float(
      __float2bfloat16(__bfloat162float(e) + __bfloat162float(p)));
  return __float2bfloat16(tanhf(s));
}

// Eight h values from eight enc and pred values (16-byte vectors).
__device__ __forceinline__ uint4 joint_h8(const bf16* e, const bf16* p) {
  const uint4 ev = *reinterpret_cast<const uint4*>(e);
  const uint4 pv = *reinterpret_cast<const uint4*>(p);
  const bf16* e8 = reinterpret_cast<const bf16*>(&ev);
  const bf16* p8 = reinterpret_cast<const bf16*>(&pv);
  uint4 out;
  bf16* o8 = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) o8[j] = joint_h(e8[j], p8[j]);
  return out;
}

// 8 bf16 from src[0..7] into dst, zero where !in or past `limit` elements;
// by cp.async when vec (all 8 in range or none, 16-byte aligned).  src must
// be a valid address even when !in (callers pass the array's base).
__device__ __forceinline__ void load8(bf16* dst, const bf16* src, bool in,
                                      int limit, bool vec) {
  if (vec) {
    cp_async16(dst, src, in ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dst[j] = (in && j < limit) ? src[j] : __float2bfloat16(0.f);
  }
}

// ------------------------- dl (and db) kernel -------------------------

__global__ void __launch_bounds__(THREADS)
dl_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ pred,
          const bf16* __restrict__ w, const float* __restrict__ bias,
          const int* __restrict__ labels, const float* __restrict__ lse,
          const float* __restrict__ g_blank, const float* __restrict__ g_label,
          const float* __restrict__ g_lse, bf16* __restrict__ dl_out,
          float* __restrict__ db, int B, int T, int U1, int H, int V,
          int blank, float clamp, int h_ld, int vec_w, int vec_h) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* h_s = reinterpret_cast<bf16*>(smem);
  bf16* w_s = h_s + (size_t)BM * h_ld;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m_base = (warp / WARPS_N) * FRAG_M * 16;
  const int n_base = (warp % WARPS_N) * FRAG_N * 8;
  const long long n_rows = (long long)B * T * U1;
  const long long row0 = (long long)blockIdx.x * BM;
  const int h_cols = h_ld - PAD;  // H rounded up to K_SLAB, zero-filled
  const int S = h_cols / K_SLAB;
  const int total = S * ((V + BN - 1) / BN);

  auto load_slab = [&](int j) {
    bf16* dst = w_s + (j % STAGES) * K_SLAB * W_LD;
    const int k0 = (j % S) * K_SLAB;
    const int n0 = (j / S) * BN;
    for (int i = tid; i < K_SLAB * BN / 8; i += THREADS) {
      const int kk = i / (BN / 8);
      const int nn = (i % (BN / 8)) * 8;
      const int k = k0 + kk, n = n0 + nn;
      const bool in = k < H && n < V;
      load8(dst + kk * W_LD + nn, in ? w + (size_t)k * V + n : w, in, V - n,
            vec_w);
    }
  };
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < total) load_slab(j);
    cp_async_commit();
  }

  for (int r = warp; r < BM; r += THREADS / 32) {
    const long long row = row0 + r;
    bf16* hr = h_s + (size_t)r * h_ld;
    if (row < n_rows) {
      const long long bt = row / U1;
      const bf16* er = enc + bt * H;
      const bf16* pr = pred + ((bt / T) * U1 + row % U1) * H;
      if (vec_h) {
        for (int k = lane * 8; k < h_cols; k += 32 * 8)
          *reinterpret_cast<uint4*>(hr + k) =
              k < H ? joint_h8(er + k, pr + k) : make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int k = lane; k < h_cols; k += 32)
          hr[k] = k < H ? joint_h(er[k], pr[k]) : __float2bfloat16(0.f);
      }
    } else {
      for (int k = lane; k < h_cols; k += 32) hr[k] = __float2bfloat16(0.f);
    }
  }

  // The lane's four rows: m_base + 16 fm + lane / 4 + 8 hh.
  float r_lse[FRAG_M][2], r_gl[FRAG_M][2], r_gb[FRAG_M][2], r_ga[FRAG_M][2];
  int r_lab[FRAG_M][2];
  bool r_ok[FRAG_M][2];
#pragma unroll
  for (int fm = 0; fm < FRAG_M; ++fm)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = row0 + m_base + fm * 16 + lane / 4 + hh * 8;
      const bool ok = row < n_rows;
      r_ok[fm][hh] = ok;
      r_lse[fm][hh] = ok ? lse[row] : 0.f;
      r_gl[fm][hh] = ok ? g_lse[row] : 0.f;
      r_gb[fm][hh] = ok ? g_blank[row] : 0.f;
      r_ga[fm][hh] = ok ? g_label[row] : 0.f;
      r_lab[fm][hh] = ok ? labels[(row / U1 / T) * U1 + row % U1] : -1;
    }

  float acc[FRAG_M][FRAG_N][4];
  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < total) load_slab(i + STAGES - 1);
    cp_async_commit();
    const int slab = i % S;
    if (slab == 0) zero_acc(acc);
    const bf16* ws = w_s + (i % STAGES) * K_SLAB * W_LD;
#pragma unroll
    for (int kk = 0; kk < K_SLAB; kk += 16)
      warp_mma16(acc, h_s, h_ld, false, slab * K_SLAB + kk, ws, W_LD, false,
                 kk, m_base, n_base, lane);
    if (slab != S - 1) continue;

    // The chunk's logits are complete in registers: form dl.
    const int n0 = (i / S) * BN;
    float csum[FRAG_N][2];
#pragma unroll
    for (int fn = 0; fn < FRAG_N; ++fn) csum[fn][0] = csum[fn][1] = 0.f;
#pragma unroll
    for (int fm = 0; fm < FRAG_M; ++fm)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!r_ok[fm][hh]) continue;
        const long long row = row0 + m_base + fm * 16 + lane / 4 + hh * 8;
#pragma unroll
        for (int fn = 0; fn < FRAG_N; ++fn) {
          const int c0 = n0 + n_base + fn * 8 + (lane % 4) * 2;
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + e;
            d[e] = 0.f;
            if (c < V) {
              const float x = acc[fm][fn][hh * 2 + e] + bias[c];
              float v = r_gl[fm][hh] * expf(x - r_lse[fm][hh]);
              if (c == blank) v += r_gb[fm][hh];
              if (c == r_lab[fm][hh]) v += r_ga[fm][hh];
              if (clamp > 0.f) v = fminf(fmaxf(v, -clamp), clamp);
              d[e] = v;
              csum[fn][e] += v;
            }
          }
          bf16* out = dl_out + row * V + c0;
          if (c0 + 1 < V && V % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __floats2bfloat162_rn(d[0], d[1]);
          } else if (c0 < V) {
            out[0] = __float2bfloat16(d[0]);
            if (c0 + 1 < V) out[1] = __float2bfloat16(d[1]);
          }
        }
      }
    // Column sums over the warp's 32 rows (lanes with equal lane % 4 hold
    // the same columns), then one atomic per column per warp.
#pragma unroll
    for (int fn = 0; fn < FRAG_N; ++fn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = csum[fn][e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        const int c = n0 + n_base + fn * 8 + lane * 2 + e;
        if (lane < 4 && c < V) atomicAdd(db + c, s);
      }
  }
  cp_async_wait<0>();
}

// ----------------------- dh (denc, dpred) kernel -----------------------

__global__ void __launch_bounds__(THREADS)
dh_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ pred,
          const bf16* __restrict__ w, const bf16* __restrict__ dl,
          float* __restrict__ denc, float* __restrict__ dpred, int T, int U1,
          int H, int V, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);         // 2 x [BM][BK + PAD]
  bf16* b_s = a_s + 2 * BM * (BK + PAD);             // 2 x [BN][BK + PAD]
  float* dp_s = reinterpret_cast<float*>(b_s + 2 * BN * (BK + PAD));  // [BM][DP_LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m_base = (warp / WARPS_N) * FRAG_M * 16;
  const int n_base = (warp % WARPS_N) * FRAG_N * 8;
  const int n_tu = (U1 + PT - 1) / PT;
  const int n_tt = (T + PT - 1) / PT;
  const int b = blockIdx.x / (n_tt * n_tu);
  const int ti = (blockIdx.x / n_tu) % n_tt;
  const int ui = blockIdx.x % n_tu;
  const int h0 = blockIdx.y * BN;

  auto load = [&](int s) {
    const int k0 = s * BK;
    bf16* as = a_s + (s % 2) * BM * (BK + PAD);
    bf16* bs = b_s + (s % 2) * BN * (BK + PAD);
    {  // dl rows of the patch: BM rows x BK columns, one piece per thread
      const int r = tid / (BK / 8), pc = (tid % (BK / 8)) * 8;
      const int t = ti * PT + r / PT, u = ui * PT + r % PT;
      const bool ok = t < T && u < U1 && k0 + pc < V;
      const long long row = ((long long)b * T + t) * U1 + u;
      load8(as + r * (BK + PAD) + pc, dl + (ok ? row * V + k0 + pc : 0), ok,
            V - k0 - pc, vec);
    }
    for (int i = tid; i < BN * BK / 8; i += THREADS) {  // W rows h0.. (n x k)
      const int n = i / (BK / 8), pc = (i % (BK / 8)) * 8;
      const bool ok = h0 + n < H && k0 + pc < V;
      load8(bs + n * (BK + PAD) + pc, w + (ok ? (size_t)(h0 + n) * V + k0 + pc : 0),
            ok, V - k0 - pc, vec);
    }
  };

  float acc[FRAG_M][FRAG_N][4];
  zero_acc(acc);
  const int n_slabs = (V + BK - 1) / BK;
  load(0);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* as = a_s + (s % 2) * BM * (BK + PAD);
    const bf16* bs = b_s + (s % 2) * BN * (BK + PAD);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      warp_mma16(acc, as, BK + PAD, false, kk, bs, BK + PAD, true, kk, m_base,
                 n_base, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

  // dpre = dh (1 - h^2) into shared memory, zero off the lattice.
#pragma unroll
  for (int fm = 0; fm < FRAG_M; ++fm)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = m_base + fm * 16 + lane / 4 + hh * 8;
      const int t = ti * PT + r / PT, u = ui * PT + r % PT;
      const bool ok = t < T && u < U1;
      const bf16* er = enc + ((long long)b * T + t) * H;
      const bf16* pr = pred + ((long long)b * U1 + u) * H;
#pragma unroll
      for (int fn = 0; fn < FRAG_N; ++fn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n_base + fn * 8 + (lane % 4) * 2 + e;
          float v = 0.f;
          if (ok && h0 + c < H) {
            const float h = __bfloat162float(joint_h(er[h0 + c], pr[h0 + c]));
            v = acc[fm][fn][hh * 2 + e] * (1.f - h * h);
          }
          dp_s[r * DP_LD + c] = v;
        }
    }
  __syncthreads();

  // Sums over the patch's u (denc) and t (dpred); thread = column x half.
  const int c = tid % BN;
  const int half = tid / BN;
  if (h0 + c < H) {
    for (int i = half * (PT / 2); i < (half + 1) * (PT / 2); ++i) {
      const int t = ti * PT + i;
      const int u = ui * PT + i;
      float se = 0.f, sp = 0.f;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        se += dp_s[(i * PT + j) * DP_LD + c];
        sp += dp_s[(j * PT + i) * DP_LD + c];
      }
      if (t < T) atomicAdd(denc + ((long long)b * T + t) * H + h0 + c, se);
      if (u < U1) atomicAdd(dpred + ((long long)b * U1 + u) * H + h0 + c, sp);
    }
  }
}

// ---------------------------- dW kernel ----------------------------

__global__ void __launch_bounds__(THREADS)
dw_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ pred,
          const bf16* __restrict__ dl, float* __restrict__ dw, int T, int U1,
          long long n_rows, int H, int V, long long rows_per_split, int vec_h,
          int vec) {
  __shared__ __align__(128) bf16 a_s[2][BK][BM + PAD];  // h slab, [row][h]
  __shared__ __align__(128) bf16 b_s[2][BK][BN + PAD];  // dl slab, [row][v]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m_base = (warp / WARPS_N) * FRAG_M * 16;
  const int n_base = (warp % WARPS_N) * FRAG_N * 8;
  const int n_vt = (V + BN - 1) / BN;
  const int hm0 = (blockIdx.x / n_vt) * BM;
  const int v0 = (blockIdx.x % n_vt) * BN;
  const long long r_begin = (long long)blockIdx.y * rows_per_split;
  const long long r_end = min(n_rows, r_begin + rows_per_split);
  if (r_begin >= r_end) return;
  const int n_slabs = (int)((r_end - r_begin + BK - 1) / BK);

  auto load = [&](int s) {
    const long long rs = r_begin + (long long)s * BK;
    {  // h: BK rows x BM columns of H, one 8-wide piece per thread
      const int kk = tid / (BM / 8), pc = (tid % (BM / 8)) * 8;
      const long long row = rs + kk;
      bf16* dst = &a_s[s % 2][kk][pc];
      const int hc = hm0 + pc;
      if (row < r_end && hc < H) {
        const long long bt = row / U1;
        const bf16* er = enc + bt * H + hc;
        const bf16* pr = pred + ((bt / T) * U1 + row % U1) * H + hc;
        if (vec_h) {
          *reinterpret_cast<uint4*>(dst) = joint_h8(er, pr);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            dst[j] = hc + j < H ? joint_h(er[j], pr[j]) : __float2bfloat16(0.f);
        }
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int i = tid; i < BK * BN / 8; i += THREADS) {  // dl: BK rows x BN
      const int kk = i / (BN / 8), pc = (i % (BN / 8)) * 8;
      const long long row = rs + kk;
      const bool ok = row < r_end && v0 + pc < V;
      load8(&b_s[s % 2][kk][pc], dl + (ok ? row * V + v0 + pc : 0), ok,
            V - v0 - pc, vec);
    }
  };

  float acc[FRAG_M][FRAG_N][4];
  zero_acc(acc);
  load(0);
  cp_async_commit();
  for (int s = 0; s < n_slabs; ++s) {
    if (s + 1 < n_slabs) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      warp_mma16(acc, &a_s[s % 2][0][0], BM + PAD, true, kk, &b_s[s % 2][0][0],
                 BN + PAD, false, kk, m_base, n_base, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int fm = 0; fm < FRAG_M; ++fm)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int h = hm0 + m_base + fm * 16 + lane / 4 + hh * 8;
      if (h >= H) continue;
#pragma unroll
      for (int fn = 0; fn < FRAG_N; ++fn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + n_base + fn * 8 + (lane % 4) * 2 + e;
          if (v < V) atomicAdd(dw + (size_t)h * V + v, acc[fm][fn][hh * 2 + e]);
        }
    }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// enc (B, T, H), pred (B, U1, H), w (H, V): bf16 contiguous; bias (V,)
// float32; labels (B, U1) int32; lse, g_blank, g_label, g_lse (B, T, U1)
// float32; dl_ws: a (B*T*U1, V) bf16 workspace.  denc (B, T, H), dpred
// (B, U1, H), dw (H, V), db (V,): float32, ZEROED by the caller (the
// kernels add into them).  grad_clamp <= 0: no clamp.  Returns the first
// CUDA error of the three launches, or cudaErrorInvalidValue when H is too
// wide for dl_kernel's shared memory.
extern "C" int rnnt_joint_bwd(const void* enc, const void* pred, const void* w,
                              const void* bias, const void* labels,
                              const void* lse, const void* g_blank,
                              const void* g_label, const void* g_lse,
                              void* dl_ws, void* denc, void* dpred, void* dw,
                              void* db, int B, int T, int U1, int H, int V,
                              int blank, float grad_clamp, void* stream) {
  const long long n_rows = (long long)B * T * U1;
  if (n_rows <= 0 || V <= 0 || H <= 0) return 0;
  int dev = 0, max_smem = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* e = static_cast<const bf16*>(enc);
  const bf16* p = static_cast<const bf16*>(pred);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* dl = static_cast<bf16*>(dl_ws);
  const int vec_h = H % 8 == 0 && aligned16(enc) && aligned16(pred);
  const int vec_w = V % 8 == 0 && aligned16(w);
  const int vec_dl = V % 8 == 0 && aligned16(dl_ws) && vec_w;

  // 1. dl and db.
  const int h_ld = round_up(H, K_SLAB) + PAD;
  const size_t smem1 = (size_t)BM * h_ld * 2 + (size_t)STAGES * K_SLAB * W_LD * 2;
  if (smem1 > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(dl_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem1);
  if (err != cudaSuccess) return (int)err;
  dl_kernel<<<(unsigned)((n_rows + BM - 1) / BM), THREADS, smem1, s>>>(
      e, p, wb, static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g_blank), static_cast<const float*>(g_label),
      static_cast<const float*>(g_lse), dl, static_cast<float*>(db), B, T, U1,
      H, V, blank, grad_clamp, h_ld, vec_w, vec_h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // 2. dh -> denc, dpred.
  const size_t smem2 = (size_t)2 * (BM + BN) * (BK + PAD) * 2 + (size_t)BM * DP_LD * 4;
  err = cudaFuncSetAttribute(dh_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const long long patches =
      (long long)B * ((T + PT - 1) / PT) * ((U1 + PT - 1) / PT);
  dh_kernel<<<dim3((unsigned)patches, (unsigned)((H + BN - 1) / BN)), THREADS,
              smem2, s>>>(e, p, wb, dl, static_cast<float*>(denc),
                          static_cast<float*>(dpred), T, U1, H, V, vec_dl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // 3. dW, the rows split so that ~4 blocks run per SM.
  const int tiles = ((H + BM - 1) / BM) * ((V + BN - 1) / BN);
  long long splits = (4LL * n_sm + tiles - 1) / tiles;
  splits = std::min(splits, std::max(1LL, n_rows / (8 * BK)));
  long long per = (n_rows + splits - 1) / splits;
  per = (per + BK - 1) / BK * BK;
  splits = (n_rows + per - 1) / per;
  dw_kernel<<<dim3((unsigned)tiles, (unsigned)splits), THREADS, 0, s>>>(
      e, p, dl, static_cast<float*>(dw), T, U1, n_rows, H, V, per, vec_h,
      vec_dl);
  return (int)cudaGetLastError();
}

// adamw_update: optax's clip_by_global_norm + adamw over every parameter
// leaf in one pass.
//
// Replaces no TPU kernel: the JAX package's optax chain is fused by XLA.
// The port's AdamWClip (train/optim.py) as a per-leaf loop issues ~17
// elementwise kernels a leaf (the clip's where / div / mul, two moment
// updates, the bias corrections, sqrt, eps, the decay and the add: ~15,500
// launches a parakeet_rnnt_0.6b step), each reading and writing whole
// float32 tensors; here it is one launch a table of up to 640 leaves.
//
// What bounds it on an H100: bytes.  g, p, mu and nu are read once (16 B a
// parameter) and p, mu and nu written once (12 B); with the norm pass
// (csrc/sq_norms.cu, 4 B) 32 B a parameter: 5.86 ms for 613,410,305
// parameters at 3.35 TB/s, of which this pass is 28 B (5.13 ms).
//
// Design (ops/multi_tensor.py plan_launches lays it out): the leaves' p,
// g, mu and nu pointers, element counts and first blocks (prefix sums)
// arrive as the kernel's by-value parameters (__grid_constant__, read in
// place), so nothing is copied to the card before the launch.  A block
// finds its leaf by a binary search over the first blocks and updates its
// chunk of elements, one thread an element (four with 16-byte loads and
// stores where all four of the leaf's pointers are 16-byte aligned, scalar
// otherwise and at the ragged tail).  The global norm is read from device
// memory (no host sync); the schedule's lr and the bias corrections come as
// float32 scalars computed on the host.  Arithmetic: float32, in
// train/optim.py's order, IEEE division and sqrtf (no fast math), nvcc's
// default FMA contraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAP = 640;  // ops/multi_tensor.py UPDATE_CAP
constexpr int THREADS = 256;

struct Table {
  float* p[CAP];
  const float* g[CAP];
  float* m[CAP];
  float* v[CAP];
  long long n[CAP];
  int blk[CAP + 1];  // first block of each leaf; blk[leaves] = blocks
  int leaves;
};

struct Hyper {
  const float* g_norm;  // the clip's global norm, on the card
  long long chunk;
  float max_norm, b1, one_b1, b2, one_b2, bc1, bc2, eps, wd, neg_lr;
};
static_assert(sizeof(Table) + sizeof(Hyper) <= 32764,
              "kernel parameters over the 32,764 bytes sm_90 takes");

__device__ __forceinline__ int leaf_of(const Table& t, int b) {
  int lo = 0, hi = t.leaves - 1;  // the last j with blk[j] <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.blk[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// train/optim.py's update of one element: the clip, the moments, the
// bias-corrected step with decoupled decay.
__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Hyper& h, float gn, bool clip) {
  if (clip) g = g / gn * h.max_norm;
  m = m * h.b1 + h.one_b1 * g;
  v = v * h.b2 + h.one_b2 * (g * g);
  float upd = (m / h.bc1) / (sqrtf(v / h.bc2) + h.eps);
  upd = upd + h.wd * p;
  p = p + h.neg_lr * upd;
}

__global__ void __launch_bounds__(THREADS)
adamw_kernel(const __grid_constant__ Table t, const __grid_constant__ Hyper h) {
  const int b = blockIdx.x;
  const int j = leaf_of(t, b);
  const long long start = (long long)(b - t.blk[j]) * h.chunk;
  const long long stop = min(start + h.chunk, t.n[j]);
  float* __restrict__ p = t.p[j];
  const float* __restrict__ g = t.g[j];
  float* __restrict__ m = t.m[j];
  float* __restrict__ v = t.v[j];
  const float gn = *h.g_norm;
  const bool clip = gn >= h.max_norm;
  long long k = start;
  const uintptr_t any = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  if ((any & 15) == 0) {  // chunk is a multiple of 4
    const long long vstop = start + ((stop - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < vstop; i += 4 * THREADS) {
      float4 pp = *reinterpret_cast<const float4*>(p + i);
      const float4 gg = *reinterpret_cast<const float4*>(g + i);
      float4 mm = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      adamw(pp.x, gg.x, mm.x, vv.x, h, gn, clip);
      adamw(pp.y, gg.y, mm.y, vv.y, h, gn, clip);
      adamw(pp.z, gg.z, mm.z, vv.z, h, gn, clip);
      adamw(pp.w, gg.w, mm.w, vv.w, h, gn, clip);
      *reinterpret_cast<float4*>(p + i) = pp;
      *reinterpret_cast<float4*>(m + i) = mm;
      *reinterpret_cast<float4*>(v + i) = vv;
    }
    k = vstop;
  }
  for (long long i = k + threadIdx.x; i < stop; i += THREADS) {
    float pp = p[i], mm = m[i], vv = v[i];
    adamw(pp, g[i], mm, vv, h, gn, clip);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace

// One launch of leaves: p, g, m, v, n, blk host arrays of `leaves` (blk:
// + 1) entries (uint64 device pointers of float32 data, int64 counts, int32
// first blocks; ops/multi_tensor.py plan_launches), 1 <= leaves <= 640,
// blk[0] = 0 and every leaf at least one block of `chunk` (a positive
// multiple of 4) elements; g_norm one float32 on the card; the scalars
// float32 (one_b1 = 1 - b1, one_b2 = 1 - b2, neg_lr = -lr).  Updates p, m
// and v in place.  Returns cudaGetLastError() after the launch.
extern "C" int rnnt_adamw_update(const unsigned long long* p, const unsigned long long* g,
                                 const unsigned long long* m, const unsigned long long* v,
                                 const long long* n, const int* blk, int leaves,
                                 long long chunk, const float* g_norm, float max_norm,
                                 float b1, float one_b1, float b2, float one_b2, float bc1,
                                 float bc2, float eps, float wd, float neg_lr,
                                 cudaStream_t stream) {
  if (leaves < 1 || leaves > CAP || chunk < 4 || chunk % 4 != 0)
    return cudaErrorInvalidValue;
  Table t;
  for (int i = 0; i < leaves; ++i) {
    t.p[i] = reinterpret_cast<float*>(p[i]);
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.m[i] = reinterpret_cast<float*>(m[i]);
    t.v[i] = reinterpret_cast<float*>(v[i]);
    t.n[i] = n[i];
    t.blk[i] = blk[i];
  }
  t.blk[leaves] = blk[leaves];
  t.leaves = leaves;
  const Hyper h{g_norm, chunk, max_norm, b1, one_b1, b2, one_b2, bc1, bc2, eps, wd, neg_lr};
  adamw_kernel<<<blk[leaves], THREADS, 0, stream>>>(t, h);
  return cudaGetLastError();
}

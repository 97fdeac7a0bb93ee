// sq_norms: the squared norm of every gradient leaf, summed by group.
//
// Replaces no TPU kernel: the JAX package's optax global_norm is fused by
// XLA.  The port's train step needs, once a step, the sum of squares of its
// gradients by (top-level submodule, sharded or not) group: the reported
// norms, and the clip's global norm (parallel/mesh.py squared_norms).  As a
// per-leaf loop that is a reduction launch a leaf (911 at
// parakeet_rnnt_0.6b); here it is one launch a table of up to 1024 leaves.
//
// What bounds it on an H100: bytes, each gradient read once (4 B a
// parameter; with the update pass, csrc/adamw_update.cu, 32 B a parameter in
// all: 5.86 ms for 613,410,305 parameters at 3.35 TB/s).
//
// Design (ops/multi_tensor.py plan_launches lays it out): the leaves'
// pointers, element counts, first blocks (prefix sums) and partial slots
// arrive as the kernel's by-value parameters (__grid_constant__, read in
// place).  A block finds its leaf by a binary search over the first blocks
// and sums the squares of its chunk of elements (16-byte loads where the
// leaf is 16-byte aligned, scalar otherwise and at the ragged tail), then
// reduces over the block in a fixed tree and writes one partial.  The
// partials of a group sit in one range, in the leaves' order; the last
// launch of a pass also runs group_sum_kernel, one block a group summing its
// range in a fixed order.  No float atomics: two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAP = 1024;         // ops/multi_tensor.py NORM_CAP
constexpr int MAX_GROUPS = 64;    // ops/multi_tensor.py MAX_GROUPS
constexpr int THREADS = 256;
constexpr int SUM_THREADS = 1024;

struct Table {
  const float* g[CAP];
  long long n[CAP];
  int blk[CAP + 1];  // first block of each leaf; blk[leaves] = blocks
  int out[CAP];      // partial slot of each leaf's first block
  int leaves;
};
static_assert(sizeof(Table) + 2 * sizeof(long long) <= 32764,
              "kernel parameters over the 32,764 bytes sm_90 takes");

struct Groups {
  int start[MAX_GROUPS + 1];
  int groups;
};

__device__ __forceinline__ int leaf_of(const Table& t, int b) {
  int lo = 0, hi = t.leaves - 1;  // the last j with blk[j] <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.blk[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The sum of x over the block, in thread 0: warps by shuffles, then the warp
// sums by the first warp.  A fixed tree.
template <int N>
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_sum[N / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if (lane == 0) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < N / 32 ? warp_sum[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

__global__ void __launch_bounds__(THREADS)
partial_kernel(const __grid_constant__ Table t, const long long chunk,
               float* __restrict__ partials) {
  const int b = blockIdx.x;
  const int j = leaf_of(t, b);
  const long long start = (long long)(b - t.blk[j]) * chunk;
  const long long stop = min(start + chunk, t.n[j]);
  const float* __restrict__ g = t.g[j];
  float acc = 0.f;
  long long k = start;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {  // chunk is a multiple of 4
    const long long vstop = start + ((stop - start) & ~3LL);
    for (long long i = start + 4 * threadIdx.x; i < vstop; i += 4 * THREADS) {
      const float4 x = *reinterpret_cast<const float4*>(g + i);
      acc += x.x * x.x;
      acc += x.y * x.y;
      acc += x.z * x.z;
      acc += x.w * x.w;
    }
    k = vstop;
  }
  for (long long i = k + threadIdx.x; i < stop; i += THREADS) acc += g[i] * g[i];
  acc = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) partials[t.out[j] + (b - t.blk[j])] = acc;
}

__global__ void __launch_bounds__(SUM_THREADS)
group_sum_kernel(const __grid_constant__ Groups gs, const float* __restrict__ partials,
                 float* __restrict__ sums) {
  const int grp = blockIdx.x;
  float acc = 0.f;
  for (int i = gs.start[grp] + threadIdx.x; i < gs.start[grp + 1]; i += SUM_THREADS)
    acc += partials[i];
  acc = block_sum<SUM_THREADS>(acc);
  if (threadIdx.x == 0) sums[grp] = acc;
}

}  // namespace

// One launch of leaves: g, n, blk, out host arrays of `leaves` (blk: + 1)
// entries (uint64 device pointers of float32 data, int64 counts, int32
// first blocks and partial slots; ops/multi_tensor.py plan_launches),
// 1 <= leaves <= 1024, blk[0] = 0 and every leaf at least one block of
// `chunk` (a positive multiple of 4) elements; partials float32 of every
// launch's blocks.  With groups > 0 (the pass's last launch) also
// sums[g] = the sum of partials[group_start[g] : group_start[g + 1]] for
// g < groups <= 64.  Returns cudaGetLastError() after the launches.
extern "C" int rnnt_sq_norms(const unsigned long long* g, const long long* n,
                             const int* blk, const int* out, int leaves, long long chunk,
                             float* partials, const int* group_start, int groups,
                             float* sums, cudaStream_t stream) {
  if (leaves < 1 || leaves > CAP || chunk < 4 || chunk % 4 != 0 || groups < 0 ||
      groups > MAX_GROUPS)
    return cudaErrorInvalidValue;
  Table t;
  for (int i = 0; i < leaves; ++i) {
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.n[i] = n[i];
    t.blk[i] = blk[i];
    t.out[i] = out[i];
  }
  t.blk[leaves] = blk[leaves];
  t.leaves = leaves;
  partial_kernel<<<blk[leaves], THREADS, 0, stream>>>(t, chunk, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || groups == 0) return err;
  Groups gs;
  for (int i = 0; i <= groups; ++i) gs.start[i] = group_start[i];
  gs.groups = groups;
  group_sum_kernel<<<groups, SUM_THREADS, 0, stream>>>(gs, partials, sums);
  return cudaGetLastError();
}

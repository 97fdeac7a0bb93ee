// joint_h.cuh: h = act(enc + pred) for the fused joint, shared by K1
// (joint_fwd.cu) and K2 (joint_bwd.cu); act is tanh (ACT_TANH) or ReLU
// (ACT_RELU), a launch argument of both.
//
// K2 recomputes the logits from h and forms the softmax against K1's lse,
// so the two kernels must round h the same way, bit for bit: the sum
// rounded to bf16, then the accurate tanhf rounded to bf16 (torch's
// rounding of tanh(enc + pred) on bf16 tensors; no tanh.approx), or the
// ReLU of the rounded sum (exact in bf16).
//
// `h_rows` is the body of an h pass: one block per (b, t) writes the U1
// rows h[(b, t, u), :] of a bf16 workspace (B*T*U1, Hp), 16 bytes a
// thread; enc's row is read once per block from L1, and the only
// divisions are by the row's chunk count.  Each source wraps it in a
// __global__ kernel of its own name, so that a trace tells the two apart.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace joint {

typedef __nv_bfloat16 bf16;

constexpr int ACT_TANH = 0;
constexpr int ACT_RELU = 1;

template <int ACT>
__device__ __forceinline__ bf16 joint_h(bf16 e, bf16 p) {
  const float s = __bfloat162float(
      __float2bfloat16(__bfloat162float(e) + __bfloat162float(p)));
  if (ACT == ACT_RELU) return __float2bfloat16(fmaxf(s, 0.f));
  return __float2bfloat16(tanhf(s));
}

// d act / d pre at the rounded h: 1 - h^2 for tanh, [h > 0] for ReLU.
__device__ __forceinline__ float joint_dact(float h, int act) {
  return act == ACT_RELU ? (h > 0.f ? 1.f : 0.f) : 1.f - h * h;
}

// enc (B, T, Hp), pred (B, U1, Hp), h (B*T*U1, Hp): bf16, Hp % 8 == 0,
// 16-byte aligned; launched on B*T blocks.
template <int ACT>
__device__ __forceinline__ void h_rows_act(const bf16* __restrict__ enc,
                                       const bf16* __restrict__ pred,
                                       bf16* __restrict__ h, int T, int U1, int Hp) {
  const int bt = blockIdx.x;
  const int chunks = Hp / 8;
  const bf16* er = enc + (long long)bt * Hp;
  const bf16* pr = pred + (long long)(bt / T) * U1 * Hp;
  bf16* hr = h + (long long)bt * U1 * Hp;
  for (int i = threadIdx.x; i < U1 * chunks; i += blockDim.x) {
    const int u = i / chunks;
    const int k = (i - u * chunks) * 8;
    const uint4 ev = *reinterpret_cast<const uint4*>(er + k);
    const uint4 pv = *reinterpret_cast<const uint4*>(pr + u * Hp + k);
    const bf16* e8 = reinterpret_cast<const bf16*>(&ev);
    const bf16* p8 = reinterpret_cast<const bf16*>(&pv);
    uint4 out;
    bf16* o8 = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) o8[j] = joint_h<ACT>(e8[j], p8[j]);
    *reinterpret_cast<uint4*>(hr + u * Hp + k) = out;
  }
}

// The h pass of either activation (act uniform over the grid).
__device__ __forceinline__ void h_rows(const bf16* __restrict__ enc,
                                       const bf16* __restrict__ pred,
                                       bf16* __restrict__ h, int T, int U1, int Hp, int act) {
  if (act == ACT_RELU)
    h_rows_act<ACT_RELU>(enc, pred, h, T, U1, Hp);
  else
    h_rows_act<ACT_TANH>(enc, pred, h, T, U1, Hp);
}

}  // namespace joint

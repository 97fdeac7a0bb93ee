// K5: arbitrary-start window gather.
//
// Replaces rnnt_tpu/ops/window_gather.py:38 _window_kernel (launcher
// _gather_windows_impl:60, call :73): out[b, n, k] = x[b, clip(starts[b, n],
// 0, L-1) + k] for k < width (a multiple of 128), 0 where the read is past
// L.  The device augmentation reads every chorus tap block, resample block,
// trim block and phase-vocoder analysis frame through it
// (data/augment_device.py).
//
// What bounds it on an H100: bytes.  It does no arithmetic; the least time
// is the output written once plus x and the starts read once, at 3.35 TB/s
// (~18 MB written over the four flagship calls of one step at B 4, L
// 164,080: a few microseconds each).  The TPU kernel's 128-aligned slice
// plus lane roll exists only because Mosaic needs aligned dynamic slices;
// here a thread reads any address.  Design: a block per (row, group of
// windows); the block loads its windows' starts into shared memory and
// clips them; each thread then writes 16 aligned bytes of the output
// (neighbouring threads on neighbouring addresses) from four scalar loads of
// x, masked past L, so no padded copy of x is made.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int FLOATS_PER_BLOCK = 2048;  // windows per block = this / width
constexpr int MAX_WPB = FLOATS_PER_BLOCK / 128;

__global__ void __launch_bounds__(THREADS)
window_gather_kernel(const float* __restrict__ x, const int* __restrict__ starts,
                     float* __restrict__ out, int L, int N, int width, int wpb) {
  __shared__ int s_start[MAX_WPB];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * wpb;
  const int nw = min(wpb, N - n0);
  if (threadIdx.x < nw) {
    const int s = starts[(size_t)b * N + n0 + threadIdx.x];
    s_start[threadIdx.x] = min(max(s, 0), L - 1);
  }
  __syncthreads();

  const float* xr = x + (size_t)b * L;
  float4* o = reinterpret_cast<float4*>(out + ((size_t)b * N + n0) * width);
  const int q = width >> 2;  // float4s per window
  for (int i = threadIdx.x; i < nw * q; i += THREADS) {
    const int w = i / q;
    const int p = s_start[w] + ((i - w * q) << 2);
    float4 v;
    v.x = p < L ? __ldg(xr + p) : 0.f;
    v.y = p + 1 < L ? __ldg(xr + p + 1) : 0.f;
    v.z = p + 2 < L ? __ldg(xr + p + 2) : 0.f;
    v.w = p + 3 < L ? __ldg(xr + p + 3) : 0.f;
    o[i] = v;
  }
}

}  // namespace

// x (B, L) float32 contiguous, L >= 1; starts (B, N) int32 contiguous; out
// (B, N, width) float32 contiguous, 16-byte aligned; width a positive
// multiple of 128.  Returns cudaGetLastError() after the launch.
extern "C" int rnnt_window_gather(const void* x, const void* starts, void* out,
                                  int B, int L, int N, int width,
                                  void* stream) {
  if (L < 1 || width <= 0 || width % 128 != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return 0;
  const int wpb = FLOATS_PER_BLOCK / width > 0 ? FLOATS_PER_BLOCK / width : 1;
  const dim3 grid((N + wpb - 1) / wpb, B);
  window_gather_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(starts),
      static_cast<float*>(out), L, N, width, wpb);
  return (int)cudaGetLastError();
}

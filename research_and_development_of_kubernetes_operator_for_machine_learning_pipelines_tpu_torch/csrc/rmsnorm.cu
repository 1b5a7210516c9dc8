// RMSNorm for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_rmsnorm_kernel` of the JAX package's
// ops/rmsnorm.py: out = x * rsqrt(mean(x^2) + eps) * scale over the last
// axis, computed in f32 and written in x's type.
//
//   x      [rows, H]  f32 or bf16, rows contiguous
//   scale  [H]        f32 or bf16
//   out    [rows, H]  x's type
//
// Bound on the H100: bytes (one read of x and scale, one write of out; two
// flops an element).  Design: one block per row; each thread reads its
// stride of the row, the f32 sum of squares is reduced by warp shuffles and
// one shared-memory step, and the second pass re-reads the row, which a
// 8 KB bf16 row keeps in L1/L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out, int H,
    float eps) {
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * H;
  T* orow = out + row * H;

  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float r = rsqrtf(red[0] / (float)H + eps);
  for (int i = threadIdx.x; i < H; i += kThreads) {
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(scale[i]));
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int H, float eps,
                   cudaStream_t stream) {
  rmsnorm_kernel<T, S><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), H, eps);
  return cudaGetLastError();
}

}  // namespace

// x_dtype, scale_dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t; nothing is synchronised.
extern "C" int rmsnorm_launch(int x_dtype, int scale_dtype, const void* x, const void* scale,
                              void* out, int rows, int H, float eps, void* stream) {
  if (rows <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0) return (int)launch<float, float>(x, scale, out, rows, H, eps, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, scale, out, rows, H, eps, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, scale, out, rows, H, eps, st);
  if (x_dtype == 1 && scale_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, H, eps, st);
  return (int)cudaErrorInvalidValue;
}

// D-major int8 decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_kernel_dmajor` of the JAX layout probe
// scripts/proto_dmajor_attention.py: one layer's single-token attention,
// with NO self term, over an int8 KV window stored transposed (D-major),
// with per-position f32 scales and an additive mask:
//
//   s[w]   = (sum_d (q[d] * scale) * k8t[d, w]) * ks[w] + mask[w]
//   p[w]   = exp(s[w] - max_w s)
//   out[d] = (sum_w v8t[d, w] * (p[w] * vs[w])) / sum_w p[w]
//
//   q         [B, NKV, D, 1]  f32 or bf16, contiguous
//   k8t, v8t  [B, NKV, D, W]  int8; any batch/head/row strides that are
//                             multiples of 4 bytes, W dense
//   ks, vs    [B, NKV, 1, W]  f32; any batch/head strides, W dense
//   mask      [B, 1, W]       f32 additive (0 / -1e9), W dense
//   out       [B, NKV, D, 1]  f32, contiguous
//
// The rounding order is the Pallas kernel's: q * scale first, then the
// reduction over D, then * ks + mask, then exp(s - m), then ctx / denom.
// There is no early exit and no -inf rule: a row whose mask is -1e9
// everywhere has every score equal to -1e9 in f32, so it comes out as the
// uniform average over W of vs * v, as the reference computes.
//
// Bound on the H100: bytes.  Per (slot, head) the kernel reads the D x W
// int8 K and V once (2 * D * W bytes) and does ~4 * D * W flops: 2 flops a
// byte, far under the f32 CUDA cores' ~20.
//
// Design (simple and right first): one 256-thread block per (slot, kv
// head).  Phase 1, the scores: a thread owns 4 consecutive positions and
// loops over the D rows with 4-byte int8 loads, so a warp reads 128
// contiguous bytes of one row of k8t (q, pre-scaled, sits in shared
// memory).  A short window leaves threads idle, so the D rows are split
// between up to D thread groups whose partial sums meet in shared memory.
// The scores (W floats, dynamic shared memory) then take the block max,
// become p * vs in place, and give the block sum.  Phase 2, the context:
// one warp per row d of v8t reads it coalesced over w (4 bytes a lane),
// multiplies by p * vs from shared memory (16 bytes a lane) and reduces by
// shuffles.  Any W: a window that is not a multiple of 4 finishes its last
// group with byte loads.  A split over W (flash-decoding), TMA and
// asynchronous copies come later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;
constexpr int kStaticSmem = (kMaxD + 4 * kThreads + 2 * kWarps) * 4;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dmajor_attention_kernel(
    const T* __restrict__ q,
    const int8_t* __restrict__ k8t, long long k_sb, long long k_sh, long long k_sd,
    const float* __restrict__ ks, long long ks_sb, long long ks_sh,
    const int8_t* __restrict__ v8t, long long v_sb, long long v_sh, long long v_sd,
    const float* __restrict__ vs, long long vs_sb, long long vs_sh,
    const float* __restrict__ mask, long long m_sb,
    float* __restrict__ out, int nkv, int W, int D, float scale) {
  extern __shared__ __align__(16) float sm_p[];   // 4 * ceil(W / 4): scores, then p * vs
  __shared__ float sm_q[kMaxD];
  __shared__ __align__(16) float sm_part[4 * kThreads];  // partial scores of the D split
  __shared__ float sm_red[kWarps];

  const int b = blockIdx.x / nkv;
  const int n = blockIdx.x % nkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long qh = (long long)b * nkv + n;

  const int8_t* kb = k8t + (long long)b * k_sb + (long long)n * k_sh;
  const int8_t* vb = v8t + (long long)b * v_sb + (long long)n * v_sh;
  const float* ksb = ks + (long long)b * ks_sb + (long long)n * ks_sh;
  const float* vsb = vs + (long long)b * vs_sb + (long long)n * vs_sh;
  const float* mrow = mask + (long long)b * m_sb;

  for (int d = tid; d < D; d += kThreads) sm_q[d] = to_f32(q[qh * D + d]) * scale;
  __syncthreads();

  // Phase 1: scores.  nwg groups of 4 positions; ds thread groups split D.
  const int nwg = (W + 3) / 4;
  int ds = 1;
  while (ds < D && nwg * ds * 2 <= kThreads) ds *= 2;
  for (int g = tid; g < nwg * ds; g += kThreads) {  // one round when ds > 1
    const int wg = g % nwg;
    const int part = g / nwg;
    const int w0 = 4 * wg;
    const int8_t* kp = kb + w0;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (w0 + 4 <= W) {
#pragma unroll 8
      for (int d = part; d < D; d += ds) {
        const char4 c = *reinterpret_cast<const char4*>(kp + (long long)d * k_sd);
        const float qd = sm_q[d];
        a[0] += qd * (float)c.x;
        a[1] += qd * (float)c.y;
        a[2] += qd * (float)c.z;
        a[3] += qd * (float)c.w;
      }
    } else {
      for (int d = part; d < D; d += ds) {
        const float qd = sm_q[d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (w0 + i < W) a[i] += qd * (float)kp[(long long)d * k_sd + i];
        }
      }
    }
    if (ds == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (w0 + i < W) sm_p[w0 + i] = a[i] * ksb[w0 + i] + mrow[w0 + i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) sm_part[part * 4 * nwg + w0 + i] = a[i];
    }
  }
  if (ds > 1) {  // block-uniform
    __syncthreads();
    for (int w = tid; w < W; w += kThreads) {
      float s = 0.f;
      for (int p = 0; p < ds; ++p) s += sm_part[p * 4 * nwg + w];
      sm_p[w] = s * ksb[w] + mrow[w];
    }
  }
  __syncthreads();

  // Softmax over W: block max, then p * vs in place and the block sum.
  float mx = -INFINITY;
  for (int w = tid; w < W; w += kThreads) mx = fmaxf(mx, sm_p[w]);
  mx = warp_max(mx);
  if (lane == 0) sm_red[warp] = mx;
  __syncthreads();
  mx = sm_red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) mx = fmaxf(mx, sm_red[i]);
  __syncthreads();  // every thread has read sm_red before it is reused
  float l = 0.f;
  for (int w = tid; w < W; w += kThreads) {
    const float p = expf(sm_p[w] - mx);
    l += p;
    sm_p[w] = p * vsb[w];
  }
  l = warp_sum(l);
  if (lane == 0) sm_red[warp] = l;
  __syncthreads();
  float denom = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) denom += sm_red[i];

  // Phase 2: context, one warp per row d of v8t.
  for (int d = warp; d < D; d += kWarps) {
    const int8_t* vp = vb + (long long)d * v_sd;
    float acc = 0.f;
#pragma unroll 4
    for (int wg = lane; wg < nwg; wg += 32) {
      const int w0 = 4 * wg;
      if (w0 + 4 <= W) {
        const char4 c = *reinterpret_cast<const char4*>(vp + w0);
        const float4 pv = reinterpret_cast<const float4*>(sm_p)[wg];
        acc += (float)c.x * pv.x + (float)c.y * pv.y + (float)c.z * pv.z + (float)c.w * pv.w;
      } else {
        for (int i = 0; i < W - w0; ++i) acc += (float)vp[w0 + i] * sm_p[w0 + i];
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[qh * D + d] = acc / denom;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k8t, long long k_sb, long long k_sh,
                   long long k_sd, const void* ks, long long ks_sb, long long ks_sh,
                   const void* v8t, long long v_sb, long long v_sh, long long v_sd,
                   const void* vs, long long vs_sb, long long vs_sh, const void* mask,
                   long long m_sb, void* out, int B, int nkv, int D, int W, float scale,
                   cudaStream_t stream) {
  const size_t smem = (size_t)4 * ((W + 3) / 4) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dmajor_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dmajor_attention_kernel<T><<<B * nkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q),
      static_cast<const int8_t*>(k8t), k_sb, k_sh, k_sd,
      static_cast<const float*>(ks), ks_sb, ks_sh,
      static_cast<const int8_t*>(v8t), v_sb, v_sh, v_sd,
      static_cast<const float*>(vs), vs_sb, vs_sh,
      static_cast<const float*>(mask), m_sb,
      static_cast<float*>(out), nkv, W, D, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q).  Strides are in elements: k8t and
// v8t (batch, head, row d), ks and vs (batch, head), mask (batch).  Returns
// the launch's cudaError_t; nothing is synchronised.
extern "C" int dmajor_attention_launch(
    int dtype, const void* q,
    const void* k8t, long long k_sb, long long k_sh, long long k_sd,
    const void* ks, long long ks_sb, long long ks_sh,
    const void* v8t, long long v_sb, long long v_sh, long long v_sd,
    const void* vs, long long vs_sb, long long vs_sh,
    const void* mask, long long m_sb,
    void* out, int B, int nkv, int D, int W, float scale, void* stream) {
  if (B <= 0 || nkv <= 0 || W <= 0 || D <= 0 || D > kMaxD || D % 4 != 0 ||
      (long long)B * nkv > 0x7fffffffLL ||
      (long long)4 * ((W + 3) / 4) * 4 + kStaticSmem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(q, k8t, k_sb, k_sh, k_sd, ks, ks_sb, ks_sh, v8t, v_sb, v_sh,
                              v_sd, vs, vs_sb, vs_sh, mask, m_sb, out, B, nkv, D, W, scale, st);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, k8t, k_sb, k_sh, k_sd, ks, ks_sb, ks_sh, v8t, v_sb,
                                      v_sh, v_sd, vs, vs_sb, vs_sh, mask, m_sb, out, B, nkv, D,
                                      W, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

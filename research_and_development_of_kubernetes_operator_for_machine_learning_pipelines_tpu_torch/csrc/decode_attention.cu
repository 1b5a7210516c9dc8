// Fused int8-KV decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels `_decode_attn_kernel_mxu` and
// `_decode_attn_kernel_vpu` of the JAX package's ops/decode_attention.py:
// one layer's single-token attention over an int8 KV window, with the
// per-(position, head) f32 scales folded into the score and probability
// rows, a strict additive mask, and the current token's exact K/V joined
// into the softmax without a concat.
//
//   q       [B, NKV, G, D]  f32 or bf16, contiguous
//   k8, v8  [B, NKV, W, D]  int8, any batch/head/position strides, D dense
//   ks, vs  [B, NKV, W, 1]  f32, any batch/head/position strides
//   k_self  [B, NKV, 1, D]  same type as q, contiguous
//   v_self  [B, NKV, 1, D]
//   mask    [B, 1, W]       f32 additive bias, W dense
//   out     [B, NKV, G, D]  f32, contiguous
//
// Bound on the H100: bytes.  Per (slot, head) the kernel reads the W x D
// int8 K and V rows once (2 * W * D bytes) and does ~4 * G * W * D flops:
// at G <= 8 that is < 16 flops a byte, far under the ~295 a byte where the
// tensor cores would become the limit.
//
// Design (simple and right first): one thread block per (slot, kv head);
// the G query rows, pre-scaled by 1/sqrt(D), sit in registers; each warp
// splits into D/4-lane sub-rows, so one sub-row reads one cache row with a
// 4-byte int8 load per lane (128 contiguous bytes a row at D = 128); every
// sub-row keeps its own online softmax over the positions it visits; the
// sub-rows of a warp merge by shuffles, the warps through shared memory,
// and the self term joins the final max and denominator.  The window is
// read in place through its strides, so a layer's window of the head-major
// cache is never copied.  wgmma, TMA and split-K come later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// exp(a - b) that is 0 when a is -inf (an empty online-softmax state).
__device__ __forceinline__ float exp_diff(float a, float b) {
  return a == -INFINITY ? 0.f : expf(a - b);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q,
    const int8_t* __restrict__ k8, long long k_sb, long long k_sh, long long k_sw,
    const float* __restrict__ ks, long long ks_sb, long long ks_sh, long long ks_sw,
    const int8_t* __restrict__ v8, long long v_sb, long long v_sh, long long v_sw,
    const float* __restrict__ vs, long long vs_sb, long long vs_sh, long long vs_sw,
    const T* __restrict__ k_self, const T* __restrict__ v_self,
    const float* __restrict__ mask, long long m_sb,
    float* __restrict__ out, int nkv, int W, int D, float scale) {
  __shared__ float sm_q[G][kMaxD];
  __shared__ float sm_self[G];
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][kMaxD];

  const int b = blockIdx.x / nkv;
  const int n = blockIdx.x % nkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int lpr = D / 4;          // lanes per cache row
  const int rpw = 32 / lpr;       // rows a warp reads at once
  const int sl = lane % lpr;      // this lane's 4-element slice of a row
  const int workers = kWarps * rpw;
  const int worker = warp * rpw + lane / lpr;

  const long long qh = ((long long)b * nkv + n);
  for (int i = tid; i < G * D; i += kThreads) {
    sm_q[i / D][i % D] = to_f32(q[qh * G * D + i]) * scale;
  }
  __syncthreads();

  // Self term: s_self[g] = q[g] . k_self (q already scaled).
  if (warp == 0) {
    const T* kself = k_self + qh * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += sm_q[g][d] * to_f32(kself[d]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) sm_self[g] = s;
    }
  }

  float qr[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qr[g][i] = sm_q[g][4 * sl + i];
  }
  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  }

  const int8_t* kbase = k8 + (long long)b * k_sb + (long long)n * k_sh + 4 * sl;
  const int8_t* vbase = v8 + (long long)b * v_sb + (long long)n * v_sh + 4 * sl;
  const float* ksbase = ks + (long long)b * ks_sb + (long long)n * ks_sh;
  const float* vsbase = vs + (long long)b * vs_sb + (long long)n * vs_sh;
  const float* mrow = mask + (long long)b * m_sb;

  // Every lane runs the same number of rounds, so the shuffles below are
  // always warp-uniform; a lane past the window's end skips its update.
  for (int base = 0; base < W; base += workers) {
    const int p = base + worker;
    const bool valid = p < W;
    char4 kc = make_char4(0, 0, 0, 0);
    char4 vc = make_char4(0, 0, 0, 0);
    float ksv = 0.f, vsv = 0.f, mk = 0.f;
    if (valid) {
      kc = *reinterpret_cast<const char4*>(kbase + (long long)p * k_sw);
      vc = *reinterpret_cast<const char4*>(vbase + (long long)p * v_sw);
      ksv = ksbase[(long long)p * ks_sw];
      vsv = vsbase[(long long)p * vs_sw];
      mk = mrow[p];
    }
    const float kf[4] = {(float)kc.x, (float)kc.y, (float)kc.z, (float)kc.w};
    const float vf[4] = {(float)vc.x, (float)vc.y, (float)vc.z, (float)vc.w};
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = qr[g][0] * kf[0] + qr[g][1] * kf[1] + qr[g][2] * kf[2] + qr[g][3] * kf[3];
      for (int off = lpr / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (valid) {
        s = s * ksv + mk;
        const float m_new = fmaxf(m[g], s);
        const float alpha = exp_diff(m[g], m_new);
        const float pr = exp_diff(s, m_new);
        const float pv = pr * vsv;
        l[g] = l[g] * alpha + pr;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = acc[g][i] * alpha + pv * vf[i];
        m[g] = m_new;
      }
    }
  }

  // Merge the sub-rows of each warp (lanes with the same slice pair up).
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float fa = exp_diff(m[g], mx);
      const float fb = exp_diff(mo, mx);
      l[g] = l[g] * fa + lo * fb;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * fa + ao * fb;
      }
      m[g] = mx;
    }
  }
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sm_acc[warp][g][4 * sl + i] = acc[g][i];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // Merge the warps and the self term; one thread per output element.
  const T* vself = v_self + qh * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = sm_self[g];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    const float p_self = expf(sm_self[g] - mx);
    float den = p_self;
    float num = p_self * to_f32(vself[d]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp_diff(sm_m[w][g], mx);
      den += sm_l[w][g] * f;
      num += sm_acc[w][g][d] * f;
    }
    out[qh * G * D + i] = num / den;
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k8, long long k_sb, long long k_sh, long long k_sw,
                   const void* ks, long long ks_sb, long long ks_sh, long long ks_sw,
                   const void* v8, long long v_sb, long long v_sh, long long v_sw,
                   const void* vs, long long vs_sb, long long vs_sh, long long vs_sw,
                   const void* k_self, const void* v_self, const void* mask, long long m_sb,
                   void* out, int B, int nkv, int W, int D, float scale, cudaStream_t stream) {
  decode_attention_kernel<T, G><<<B * nkv, kThreads, 0, stream>>>(
      static_cast<const T*>(q),
      static_cast<const int8_t*>(k8), k_sb, k_sh, k_sw,
      static_cast<const float*>(ks), ks_sb, ks_sh, ks_sw,
      static_cast<const int8_t*>(v8), v_sb, v_sh, v_sw,
      static_cast<const float*>(vs), vs_sb, vs_sh, vs_sw,
      static_cast<const T*>(k_self), static_cast<const T*>(v_self),
      static_cast<const float*>(mask), m_sb,
      static_cast<float*>(out), nkv, W, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_g(int G, const void* q, const void* k8, long long k_sb, long long k_sh,
                     long long k_sw, const void* ks, long long ks_sb, long long ks_sh,
                     long long ks_sw, const void* v8, long long v_sb, long long v_sh,
                     long long v_sw, const void* vs, long long vs_sb, long long vs_sh,
                     long long vs_sw, const void* k_self, const void* v_self, const void* mask,
                     long long m_sb, void* out, int B, int nkv, int W, int D, float scale,
                     cudaStream_t stream) {
#define DA_CASE(GG)                                                                        \
  case GG:                                                                                 \
    return launch<T, GG>(q, k8, k_sb, k_sh, k_sw, ks, ks_sb, ks_sh, ks_sw, v8, v_sb, v_sh, \
                         v_sw, vs, vs_sb, vs_sh, vs_sw, k_self, v_self, mask, m_sb, out, B, \
                         nkv, W, D, scale, stream);
  switch (G) {
    DA_CASE(1)
    DA_CASE(2)
    DA_CASE(4)
    DA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_self and v_self).  Returns the
// launch's cudaError_t; nothing is synchronised.
extern "C" int decode_attention_launch(
    int dtype, int G, const void* q,
    const void* k8, long long k_sb, long long k_sh, long long k_sw,
    const void* ks, long long ks_sb, long long ks_sh, long long ks_sw,
    const void* v8, long long v_sb, long long v_sh, long long v_sw,
    const void* vs, long long vs_sb, long long vs_sh, long long vs_sw,
    const void* k_self, const void* v_self, const void* mask, long long m_sb,
    void* out, int B, int nkv, int W, int D, float scale, void* stream) {
  if (D % 4 != 0 || D > kMaxD || 32 % (D / 4) != 0 || B <= 0 || nkv <= 0 || W <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_g<float>(G, q, k8, k_sb, k_sh, k_sw, ks, ks_sb, ks_sh, ks_sw, v8, v_sb,
                                v_sh, v_sw, vs, vs_sb, vs_sh, vs_sw, k_self, v_self, mask, m_sb,
                                out, B, nkv, W, D, scale, st);
  }
  if (dtype == 1) {
    return (int)launch_g<__nv_bfloat16>(G, q, k8, k_sb, k_sh, k_sw, ks, ks_sb, ks_sh, ks_sw, v8,
                                        v_sb, v_sh, v_sw, vs, vs_sb, vs_sh, vs_sw, k_self, v_self,
                                        mask, m_sb, out, B, nkv, W, D, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

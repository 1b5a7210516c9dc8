// Flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_flash_kernel` of the JAX package's
// ops/flash_attention.py: blockwise online-softmax attention where a query
// tile stays resident and key/value tiles stream through it, so the score
// matrix never reaches device memory.
//
//   q     [B, S, H, D] or [B, H, S, D]: any batch/head/position strides, D dense
//   k, v  [B, T, H, D] likewise
//   bias  [B, T]       optional f32 additive key bias (BERT's mask_bias), T dense
//   o     [B, S, H, D] any batch/head/position strides, D dense; q's type
//
// scores = (q * scale) . k in f32, plus bias[b, key]; then the kv_len mask
// (key >= kv_len) and the causal mask (key > query) each REPLACE the score
// with -1e30, as the Pallas kernel does, and masked keys still take part
// in the softmax: kv_len <= 0 masks every key, all T scores are -1e30, and
// the row comes out as the mean of V over the T keys, as the kernel's
// oracle `attention_reference` gives.  Keys past T, which only pad the
// ragged last tile, take no part (-inf).  Any S and T: the ragged query
// tile and key tile are masked here, nothing is padded on the host.  f32
// or bf16 I/O, f32 math.
//
// Bound on the H100: operations.  At BERT-base (S = T = 128, D = 64) each
// (batch, head) reads 3 * S * D inputs and does 4 * S * T * D flops: 43
// flops a byte in bf16.  That is under the tensor cores' ~295 a byte, but
// this kernel runs its products on the f32 CUDA cores (67 TFLOP/s), where
// the line sits at ~20 flops a byte, so it is bound by its own arithmetic.
//
// Design (simple and right first): one 256-thread block per (batch * head,
// 64-row query tile).  Four threads share a query row; each owns D/4 of
// its elements in interleaved 8- or 16-byte groups (so the four read
// neighbouring shared-memory words and never collide on a bank), holding
// q (pre-scaled) and the f32 accumulator in registers.  Key/value tiles of
// 64 rows (32 for f32 at D = 128, to stay in 32 KB) are staged in shared
// memory in the input type with 16-byte loads and converted to f32 at use.
// Keys go in chunks of 16: 16 partial dots, two shuffles each to sum the
// four owners, one max and rescale per chunk, then 16 p * v updates.  Key
// tiles wholly past kv_len, or (causal) past the tile's last query, are
// skipped.  Tensor cores (mma.sync / wgmma), TMA and a split over T are
// later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                      // query rows per block
constexpr int kTPR = kThreads / kBQ;         // threads per query row
constexpr int kChunk = 16;                   // keys per online-softmax step
constexpr float kNegInf = -1e30f;            // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// W contiguous elements of T -> f32, from shared memory, in one 8- or
// 16-byte load.
template <typename T, int W> struct Vec;
template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  }
};

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const T* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
    const T* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
    const float* __restrict__ bias, long long bias_sb,
    T* __restrict__ o, long long o_sb, long long o_sh, long long o_ss,
    int H, int S, int T_len, int kv_len, float scale) {
  constexpr int DS = D / kTPR;                                  // elements a thread owns
  constexpr int W = (16 / (int)sizeof(T)) < DS ? 16 / (int)sizeof(T) : DS;  // group width
  constexpr int NG = DS / W;                                    // groups a thread owns
  constexpr int BK = (sizeof(T) == 4 && D == 128) ? 32 : 64;    // key rows per tile
  constexpr int LV = 16 / (int)sizeof(T);                       // elements per 16-byte load
  static_assert(D % (kTPR * W) == 0, "head dim must split into thread groups");
  static_assert(D % LV == 0, "head dim must be a multiple of 16 bytes");

  __shared__ __align__(16) unsigned char sk_raw[BK * D * sizeof(T)];
  __shared__ __align__(16) unsigned char sv_raw[BK * D * sizeof(T)];
  __shared__ float sbias[BK];
  T* sk = reinterpret_cast<T*>(sk_raw);
  T* sv = reinterpret_cast<T*>(sv_raw);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int sub = tid % kTPR;
  const int qi = q0 + row;
  const bool row_valid = qi < S;

  // Element e of this thread's slice lives at d = (sub + kTPR * (e / W)) * W + e % W.
  float qr[DS], acc[DS];
  {
    const T* qrow = q + (long long)b * q_sb + (long long)h * q_sh + (long long)qi * q_ss;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int d = (sub + kTPR * g) * W + w;
        qr[g * W + w] = row_valid ? to_f32(qrow[d]) * scale : 0.f;
        acc[g * W + w] = 0.f;
      }
    }
  }
  float m = kNegInf, l = 0.f;

  const int kv_eff = kv_len < T_len ? kv_len : T_len;
  const bool no_key = kv_eff <= 0;  // every key masked: the row averages all T
  int kv_end = no_key ? T_len : kv_eff;
  if (!no_key && CAUSAL && q0 + kBQ < kv_end) kv_end = q0 + kBQ;  // keys past the tile's last query
  const T* kbase = k + (long long)b * k_sb + (long long)h * k_sh;
  const T* vbase = v + (long long)b * v_sb + (long long)h * v_sh;
  const float* brow = bias ? bias + (long long)b * bias_sb : nullptr;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * (D / LV); idx += kThreads) {
      const int r = idx / (D / LV);
      const int c = (idx % (D / LV)) * LV;
      const int key = k0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (key < T_len) {
        kx = *reinterpret_cast<const uint4*>(kbase + (long long)key * k_st + c);
        vx = *reinterpret_cast<const uint4*>(vbase + (long long)key * v_st + c);
      }
      *reinterpret_cast<uint4*>(sk + r * D + c) = kx;
      *reinterpret_cast<uint4*>(sv + r * D + c) = vx;
    }
    for (int r = tid; r < BK; r += kThreads) {
      sbias[r] = (brow && k0 + r < T_len) ? brow[k0 + r] : 0.f;
    }
    __syncthreads();

    const int tile_end = kv_end - k0 < BK ? kv_end - k0 : BK;
    for (int c0 = 0; c0 < tile_end; c0 += kChunk) {  // block-uniform bounds
      float s[kChunk];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const T* krow = sk + (c0 + j) * D;
        float dot = 0.f;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float kf[W];
          Vec<T, W>::load(krow + (sub + kTPR * g) * W, kf);
#pragma unroll
          for (int w = 0; w < W; ++w) dot = fmaf(qr[g * W + w], kf[w], dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int key = k0 + c0 + j;
        dot += sbias[c0 + j];
        const bool masked = key >= kv_eff || (CAUSAL && key > qi);
        s[j] = key >= T_len ? -INFINITY : masked ? kNegInf : dot;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = __expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int e = 0; e < DS; ++e) acc[e] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = __expf(s[j] - m_new);
        l += p;
        const T* vrow = sv + (c0 + j) * D;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float vf[W];
          Vec<T, W>::load(vrow + (sub + kTPR * g) * W, vf);
#pragma unroll
          for (int w = 0; w < W; ++w) acc[g * W + w] = fmaf(p, vf[w], acc[g * W + w]);
        }
      }
      m = m_new;
    }
  }

  if (row_valid) {
    const float inv = 1.f / l;  // l >= 1: the largest score gives p = 1
    T* orow = o + (long long)b * o_sb + (long long)h * o_sh + (long long)qi * o_ss;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        orow[(sub + kTPR * g) * W + w] = from_f32<T>(acc[g * W + w] * inv);
      }
    }
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch(const void* q, const long long* qs, const void* k, const long long* ks,
                   const void* v, const long long* vs, const float* bias, long long bias_sb,
                   void* o, const long long* os, int B, int H, int S, int T_len, int kv_len,
                   float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * H), (unsigned)((S + kBQ - 1) / kBQ));
  flash_attention_kernel<T, D, CAUSAL><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), qs[0], qs[1], qs[2],
      static_cast<const T*>(k), ks[0], ks[1], ks[2],
      static_cast<const T*>(v), vs[0], vs[1], vs[2],
      bias, bias_sb, static_cast<T*>(o), os[0], os[1], os[2],
      H, S, T_len, kv_len, scale);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t by_dim(int D, const void* q, const long long* qs, const void* k, const long long* ks,
                   const void* v, const long long* vs, const float* bias, long long bias_sb,
                   void* o, const long long* os, int B, int H, int S, int T_len, int kv_len,
                   float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16, CAUSAL>(q, qs, k, ks, v, vs, bias, bias_sb, o, os, B, H, S, T_len, kv_len, scale, st);
    case 32: return launch<T, 32, CAUSAL>(q, qs, k, ks, v, vs, bias, bias_sb, o, os, B, H, S, T_len, kv_len, scale, st);
    case 64: return launch<T, 64, CAUSAL>(q, qs, k, ks, v, vs, bias, bias_sb, o, os, B, H, S, T_len, kv_len, scale, st);
    case 128: return launch<T, 128, CAUSAL>(q, qs, k, ks, v, vs, bias, bias_sb, o, os, B, H, S, T_len, kv_len, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, ordered
// (batch, head, position); the last axis of q, k, v and o is dense.  bias
// may be null.  Returns the launch's cudaError_t; nothing is synchronised.
extern "C" int flash_attention_launch(
    int dtype, int D, int causal,
    const void* q, long long q_sb, long long q_sh, long long q_ss,
    const void* k, long long k_sb, long long k_sh, long long k_st,
    const void* v, long long v_sb, long long v_sh, long long v_st,
    const float* bias, long long bias_sb,
    void* o, long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int S, int T_len, int kv_len, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T_len <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL || (S + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_st};
  const long long vs[3] = {v_sb, v_sh, v_st}, os[3] = {o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return causal ? (int)by_dim<float, true>(D, q, qs, k, ks, v, vs, bias, bias_sb, o, os, B, H, S, T_len, kv_len, scale, st)
                  : (int)by_dim<float, false>(D, q, qs, k, ks, v, vs, bias, bias_sb, o, os, B, H, S, T_len, kv_len, scale, st);
  }
  if (dtype == 1) {
    return causal ? (int)by_dim<__nv_bfloat16, true>(D, q, qs, k, ks, v, vs, bias, bias_sb, o, os, B, H, S, T_len, kv_len, scale, st)
                  : (int)by_dim<__nv_bfloat16, false>(D, q, qs, k, ks, v, vs, bias, bias_sb, o, os, B, H, S, T_len, kv_len, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

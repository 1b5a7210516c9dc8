// Fused decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels `_decode_attn_kernel_mxu` (line 52, its
// pallas_call at 114) and `_decode_attn_kernel_vpu` (line 173, pallas_call
// at 260) of the JAX package's ops/decode_attention.py: one layer's
// single-token attention over an int8 KV window, with the per-(position,
// head) f32 scales folded into the score and probability rows, a strict
// additive mask, and the current token's exact K/V joined into the
// softmax without a concat.  The same kernel, instanced on the cache's
// element type, runs the dense window of the bf16 (or f32) cache: the XLA
// chain of the JAX package's models/llama.py:611-637, which reaches no
// Pallas kernel there.
//
//   q       [B, NKV, G, D]  f32 or bf16, contiguous
//   k8, v8  [B, NKV, W, D]  int8, or q's type (the dense cache), any
//                           batch/head/position strides, D dense
//   ks, vs  [B, NKV, W, 1]  f32, any batch/head/position strides (int8
//                           only; the dense cache has no scales)
//   k_self  [B, NKV, 1, D]  same type as q, contiguous
//   v_self  [B, NKV, 1, D]
//   mask    [B, 1, W]       f32 additive bias, W dense
//   out     [B, NKV, G, D]  f32, contiguous
//
// Bound on the H100: bytes.  Per (slot, head) the kernel reads the W x D
// int8 K and V rows once (2 * W * D bytes; 2 * W * D * 2 in bf16) and does
// ~4 * G * W * D flops: at G <= 8 that is < 16 flops a byte, far under the
// ~295 a byte where the tensor cores would become the limit.  At
// Llama-2-7B's 4 slots x 32 heads x W = 768 the bytes take 7.8 us (15.3
// in bf16).
//
// Design (flash-decoding).  To reach that bound the card needs many bytes
// in flight, so the window is split:
//
// - Grid B x NKV x splits.  The host picks `splits` (ops/decode_attention.py
//   `num_splits`): as many as fill one wave of 4 blocks an SM, >= 64
//   positions a split, 1 for windows of 192 or less.  At G = 1 the launch
//   bounds hold the kernel to 64 registers, so 4 blocks of 256 threads fit
//   an SM.  Block (slot, head, split) owns `chunk` consecutive positions;
//   a block past W owns none and contributes nothing.
// - Wide loads.  A lane reads VEC bytes of a cache row: 16 (an `int4`)
//   when the base and every stride of k8 and v8 are 16-byte aligned, as
//   the head-major cache [L, B, NKV, T, D] always is, else 4.  That is
//   E = VEC / sizeof(element) elements (16 int8 or 8 bf16 in 16 bytes), so
//   D / E lanes share a row (8 at int8 and 16 at bf16 for D = 128); where
//   that is more than 32 (4-byte bf16 or f32 loads at D = 128) a warp
//   takes the row and each lane D / (32 E) loads of it.  A block reads
//   8 warps x 32 / (D / E) rows a round, 2 rounds unrolled, with every load
//   of both rounds issued before their arithmetic: the same 32 bytes in
//   flight a lane in every instance.  VEC is a template parameter the
//   wrapper picks explicitly.
// - Two phases per split, not a per-position online softmax.  Phase 1:
//   every row's score, (q * scale) . k8 reduced over the row's lanes by
//   shuffles, times ks (int8), plus the mask, goes to shared memory.  Then
//   one block max, exp and the sum (p * vs, or p, replaces the score in
//   place).
//   Phase 2: P . V over the split's V rows, each lane accumulating its E
//   columns, then a reduction over the rows of a warp (shuffles) and over
//   the warps (shared memory).  No dependent shuffle -> exp -> rescale
//   chain per position remains.
// - With one split the block joins the self term and writes `out`.  With
//   more, each writes its partial (m, l, acc[G][D]) in f32 to the scratch
//   the wrapper allocates, and a second small kernel, launched by the
//   same C call, merges them with the usual max-rescale and joins the self
//   term once.  The mask is finite (-1e9), so a split masked everywhere
//   has a finite partial that the merge weighs to 0; a split with no
//   position has m = -inf, l = 0, acc = 0, which weighs exactly 0.  A
//   length-0 row is exactly v_self.
//
// The verify chunk (self-speculative decoding).  The attention of the JAX
// package's models/llama.py `_block_verify_deferred` (lines 1083-1152, an
// einsum chain there, no Pallas kernel) is this kernel with its one self
// row widened to S causal chunk rows: for slot b, head n, chunk position s
// and group g, query row r = s * G + g attends the window [0, W) under the
// same strict mask for every s, plus the chunk keys j <= s in one softmax.
// The diagonal j == s is exact; on the int8 window every earlier chunk key
// and value reads through the cache's quantize round-trip (k8c * ksc,
// v8c * vsc), as it would have through the cache on the sequential path.
//
//   q        [B, NKV, R = S * G, D]   contiguous, row r = s * G + g
//   k_chunk  [B, NKV, S, D]           q's type, contiguous (exact rows)
//   v_chunk
//   k8c, v8c [B, NKV, S, D] int8 and ksc, vsc [B, NKV, S, 1] f32,
//                                     contiguous (int8 window only)
//   out      [B, NKV, R, D]           f32
//
// bf16 q (the serving type): `verify_attention_kernel<C, D>`, the core of
// chunk_attention.cuh on the tensor cores.  Bound on the H100 at
// Llama-2-7B's B 4, NKV 32, W 768: the bytes (the window once a (slot,
// head): 25 MB int8, 7.8 us at 3.35 TB/s) up to S = 128; at S = 256 the
// operations as much (Q . K once and P . V twice, its f32 probabilities
// as a hi/lo pair, at the bf16 tensor-core rate: chip_smoke.py
// `_va_bytes_flops`).  Design:
// - Grid (B * NKV * row groups) x window pieces.  A block holds one
//   group of the (slot, kv head)'s R = S * G query rows (16, 32 or 64:
//   its 4 warps split each 64-key tile's four 16-key slices 4, 2 or 1
//   ways), so the window crosses device memory once a (slot, head) up
//   to 64 rows, and once a row group beyond.  The host's plan
//   (ops/decode_attention.py `verify_plan`) cuts W into tile-aligned
//   pieces to fill one wave (3 blocks an SM); the last piece also
//   attends the S chunk keys (causal; the exact diagonal and, on the
//   int8 window, the round-trip codes and scales below it).
// - Window tiles of int8 codes (+ scales + mask) or bf16 rows stream
//   through a 2-stage `cp.async` ring and are read by every row tile of
//   the block; Q . K runs on bf16 `mma.sync` (codes are exact in bf16,
//   products exact in f32; only the summation order changes).
// - The probabilities stay f32: p (times the value scale) enters P . V
//   as a hi/lo pair of bf16 MMAs (within 2^-17 of p), the diagonal's
//   p * v in f32 from the exact V row, so DA_TOL (1e-4) holds.
// - One piece: the block writes the rows.  Several: each writes its f32
//   partial and `verify_attention_kernel_join`, launched by the same C
//   call, joins them.  S is capped at kMaxS = 256 (the prefill chunk).
// - A live count a slot (`counts`, optional).  The unified super-step
//   (models/llama.py `super_step_ragged`) gives every row one static
//   width S but a row commits 1 (decode), draft + 1 (verify) or the
//   chunk's positions, so rows r with r / G >= counts[b] are parked: a
//   row group wholly parked exits at once (zeros written by the block with
//   one piece, else by the join), a partly parked one attends for its live
//   rows only (fewer chunk keys too) and zeros the rest.  Live rows are
//   unchanged: the chunk term is causal, so none reads a parked key.
//   At S = 256 a decode row then costs one row group of 64, not four.
// f32 q (exactness checks) keeps the first design on the CUDA cores: the
// split kernel instanced with VERIFY at G = 1, one query row a block, and
// `verify_attention_kernel_merge` joining the S chunk keys.  The S = 1
// decode instances (VERIFY false) keep their code, grid and launch
// bounds: every VERIFY branch is a compile-time constant there.
//
// What still holds the bf16 verify back (H100 80GB HBM3, 700 W,
// chip_smoke.py): latency.  A block costs ~6 us before and after its
// tiles (the first tile's round trip, the chunk tile, the partials) and a
// 64-key tile ~2 us at one block an SM, ~3.8 us at three; 168 registers
// and 73 KB of shared memory leave 12 warps an SM, and a 16-key
// `mma.sync` softmax step leaves them waiting.  So S = 5 takes ~3.5x its
// byte bound, and S = 2 is slower than the one-row design it replaced.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "chunk_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kUnroll = 2;           // row rounds whose loads go out together
constexpr int kMaxChunk = 2048;      // positions a split's scores may hold
constexpr int kSmemNoOptIn = 48 * 1024;  // bytes a block may use without opting in

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC bytes of a cache row, as VEC / 4 words.
template <int VEC> struct Row { unsigned w[VEC / 4]; };

template <typename C>
__device__ __forceinline__ void load_row(const C* p, Row<16>& r) {
  const int4 x = __ldg(reinterpret_cast<const int4*>(p));
  r.w[0] = x.x; r.w[1] = x.y; r.w[2] = x.z; r.w[3] = x.w;
}
template <typename C>
__device__ __forceinline__ void load_row(const C* p, Row<4>& r) {
  r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
}

// The cache's element types: element e of a row's words, as f32, and
// whether per-(position, head) scales come with it.
template <typename C> struct Cache;
template <> struct Cache<int8_t> {
  static constexpr bool kScaled = true;
  template <int VEC>
  __device__ static float get(const Row<VEC>& r, int e) {  // byte e, sign-extended
    return (float)((int)(r.w[e / 4] << (24 - 8 * (e % 4))) >> 24);
  }
};
template <> struct Cache<__nv_bfloat16> {
  static constexpr bool kScaled = false;
  template <int VEC>
  __device__ static float get(const Row<VEC>& r, int e) {  // half e: its bits are f32's high half
    const unsigned x = r.w[e / 2];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
};
template <> struct Cache<float> {
  static constexpr bool kScaled = false;
  template <int VEC>
  __device__ static float get(const Row<VEC>& r, int e) { return __uint_as_float(r.w[e]); }
};

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

// s_self[g] = (q[g] * scale) . k_self for this (slot, head), one warp a g.
template <typename T>
__device__ __forceinline__ void self_scores(const T* qh, const T* kself, int G, int D,
                                            float scale, float* s_self) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += kWarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += to_f32(qh[g * D + d]) * scale * to_f32(kself[d]);
    s = warp_sum(s);
    if (lane == 0) s_self[g] = s;
  }
}

// G = 1 (Llama-2-7B) keeps to 64 registers, so 4 blocks fit an SM and a
// grid of ~4 x 132 blocks runs as one wave; G = 2 keeps to 128 (2 blocks);
// larger G needs its registers for q (G x E floats a lane).  T: q's type;
// C: the cache's element (int8 with scales, or T).
template <typename T, typename C, int G, int VEC, bool VERIFY>
__global__ void __launch_bounds__(kThreads, G == 1 ? 4 : G == 2 ? 2 : 1) decode_attention_kernel(
    const T* __restrict__ q,
    const C* __restrict__ k8, long long k_sb, long long k_sh, long long k_sw,
    const float* __restrict__ ks, long long ks_sb, long long ks_sh, long long ks_sw,
    const C* __restrict__ v8, long long v_sb, long long v_sh, long long v_sw,
    const float* __restrict__ vs, long long vs_sb, long long vs_sh, long long vs_sw,
    const T* __restrict__ k_self, const T* __restrict__ v_self,
    const float* __restrict__ mask, long long m_sb,
    float* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int nkv, int W, int D, int chunk, int splits, int R, float scale,
    const int* __restrict__ counts, int group) {
  constexpr int E = VEC / (int)sizeof(C);                  // elements a load
  constexpr int NCH = kMaxD / (32 * E) > 1 ? kMaxD / (32 * E) : 1;  // most loads a lane a row
  constexpr bool kScaled = Cache<C>::kScaled;
  static_assert(!VERIFY || G == 1, "the verify instance takes one query row a block");
  extern __shared__ float smem[];
  float* sm_s = smem;                    // [G][chunk]: scores, then p (* vs)
  float* sm_acc = smem + G * chunk;      // [kWarps][G][D]: per-warp P . V
  __shared__ float sm_red[kWarps][G];
  __shared__ float sm_self[G], sm_m[G], sm_l[G];

  const int bn = blockIdx.x / splits;    // slot * nkv + head
  const int split = blockIdx.x % splits;
  const int b = bn / nkv;
  const int n = bn % nkv;
  const int p0 = split * chunk;
  const int len = max(min(W - p0, chunk), 0);  // 0: a split past W
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_lanes = D / E;           // loads a row: 1..64
  const int lpr = min(row_lanes, 32);    // lanes per row: 1..32
  const int nch = NCH == 1 ? 1 : row_lanes / lpr;  // loads a lane a row: 1..NCH
  const int sub = lane % lpr;            // this lane's columns: (c * lpr + sub) * E + [0, E)
  const int round_rows = kWarps * (32 / lpr);
  const int my_row = warp * (32 / lpr) + lane / lpr;  // row within a round

  // VERIFY: this block's one row is row blockIdx.y of the slot's R; a row
  // at or past the slot's live count is parked (the merge writes its zeros).
  const int row0 = VERIFY ? (int)blockIdx.y : 0;
  if (VERIFY && counts != nullptr && row0 / group >= __ldg(counts + b)) return;
  const T* qh = q + ((long long)bn * (VERIFY ? R : G) + row0) * D;
  float qr[G][NCH * E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qr[g][c * E + e] =
            c < nch ? to_f32(qh[g * D + (c * lpr + sub) * E + e]) * scale : 0.f;
      }
    }
  }
  const bool whole = !VERIFY && splits == 1;  // finish here: no merge launch
  if (whole) self_scores(qh, k_self + (long long)bn * D, G, D, scale, sm_self);

  const C* kb = k8 + (long long)b * k_sb + (long long)n * k_sh + sub * E;
  const C* vb = v8 + (long long)b * v_sb + (long long)n * v_sh + sub * E;
  const float* ksb = kScaled ? ks + (long long)b * ks_sb + (long long)n * ks_sh : nullptr;
  const float* vsb = kScaled ? vs + (long long)b * vs_sb + (long long)n * vs_sh : nullptr;
  const float* mrow = mask + (long long)b * m_sb;

  // Phase 1: scores.  Loop bounds are block-uniform, so every shuffle has
  // the whole warp; a lane past the split's end works on zeros.
  for (int base = 0; base < len; base += kUnroll * round_rows) {
    Row<VEC> kr[kUnroll][NCH];
    float ksv[kUnroll], mk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * round_rows + my_row;
      const int p = p0 + i;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
#pragma unroll
        for (int j = 0; j < VEC / 4; ++j) kr[u][c].w[j] = 0;
      }
      ksv[u] = 0.f;
      mk[u] = 0.f;
      if (i < len) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          if (c < nch) load_row(kb + (long long)p * k_sw + c * lpr * E, kr[u][c]);
        }
        if (sub == 0) {
          if (kScaled) ksv[u] = __ldg(ksb + (long long)p * ks_sw);
          mk[u] = __ldg(mrow + p);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * round_rows + my_row;
      float kf[NCH * E];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[c * E + e] = Cache<C>::get(kr[u][c], e);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < NCH * E; ++e) s += qr[g][e] * kf[e];
        for (int off = lpr / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (sub == 0 && i < len) sm_s[g * chunk + i] = kScaled ? s * ksv[u] + mk[u] : s + mk[u];
      }
    }
  }
  __syncthreads();

  // Softmax over the split: the block max, then p (* vs) in place and the sum.
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float x = -INFINITY;
    for (int i = tid; i < len; i += kThreads) x = fmaxf(x, sm_s[g * chunk + i]);
    x = warp_max(x);
    if (lane == 0) sm_red[warp][g] = x;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = sm_red[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m[g] = fmaxf(m[g], sm_red[w][g]);
  }
  __syncthreads();  // every thread has read sm_red before it is reused
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float x = 0.f;
    for (int i = tid; i < len; i += kThreads) {
      const float p = expf(sm_s[g * chunk + i] - m[g]);
      x += p;
      sm_s[g * chunk + i] = kScaled ? p * __ldg(vsb + (long long)(p0 + i) * vs_sw) : p;
    }
    x = warp_sum(x);
    if (lane == 0) sm_red[warp][g] = x;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l[g] += sm_red[w][g];
    if (tid == 0) {
      sm_m[g] = m[g];
      sm_l[g] = l[g];
    }
  }

  // Phase 2: P . V, each lane accumulating its columns over its rows.
  float acc[G][NCH * E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < NCH * E; ++e) acc[g][e] = 0.f;
  }
  for (int base = 0; base < len; base += kUnroll * round_rows) {
    Row<VEC> vr[kUnroll][NCH];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * round_rows + my_row;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
#pragma unroll
        for (int j = 0; j < VEC / 4; ++j) vr[u][c].w[j] = 0;
        if (i < len && c < nch) load_row(vb + (long long)(p0 + i) * v_sw + c * lpr * E, vr[u][c]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * round_rows + my_row;
      if (i < len) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pv = sm_s[g * chunk + i];
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][c * E + e] += pv * Cache<C>::get(vr[u][c], e);
          }
        }
      }
    }
  }
  // The rows of a warp (lanes with the same columns), then the warps.
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < NCH * E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  }
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (c < nch) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            sm_acc[(warp * G + g) * D + (c * lpr + sub) * E + e] = acc[g][c * E + e];
          }
        }
      }
    }
  }
  __syncthreads();

  const long long slot =
      (VERIFY ? (long long)bn * gridDim.y + blockIdx.y : (long long)bn) * splits + split;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[(w * G + g) * D + d];
    if (whole) {  // join the self term and finish (len >= 1, so m is finite)
      const float mx = fmaxf(sm_m[g], sm_self[g]);
      const float f = expf(sm_m[g] - mx);
      const float p_self = expf(sm_self[g] - mx);
      out[(long long)bn * G * D + i] =
          (a * f + p_self * to_f32(v_self[(long long)bn * D + d])) / (sm_l[g] * f + p_self);
    } else {
      part_acc[slot * G * D + i] = a;
      if (d == 0) {
        part_ml[(slot * G + g) * 2] = sm_m[g];
        part_ml[(slot * G + g) * 2 + 1] = sm_l[g];
      }
    }
  }
}

// Merges the splits' partials of one (slot, head) and joins the self term.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel_combine(
    const T* __restrict__ q, const T* __restrict__ k_self, const T* __restrict__ v_self,
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    float* __restrict__ out, int G, int D, int splits, float scale) {
  __shared__ float sm_self[8];
  const int bn = blockIdx.x;
  self_scores(q + (long long)bn * G * D, k_self + (long long)bn * D, G, D, scale, sm_self);
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    const float s_self = sm_self[g];
    float mx = s_self;
    for (int s = 0; s < splits; ++s) {
      mx = fmaxf(mx, part_ml[(((long long)bn * splits + s) * G + g) * 2]);
    }
    const float p_self = expf(s_self - mx);
    float den = p_self;
    float num = p_self * to_f32(v_self[(long long)bn * D + d]);
    for (int s = 0; s < splits; ++s) {
      const long long slot = (long long)bn * splits + s;
      const float f = expf(part_ml[(slot * G + g) * 2] - mx);  // 0 for an empty split
      den += part_ml[(slot * G + g) * 2 + 1] * f;
      num += part_acc[slot * G * D + i] * f;
    }
    out[(long long)bn * G * D + i] = num / den;
  }
}

// Verify (f32 q): merges the splits' partials of one (slot, head, row)
// and joins the row's chunk term, the at most S chunk keys j <= s: their
// scores first (one warp a key, into shared memory), then one max-rescale
// over the splits and the keys per d.
constexpr int kMaxS = 256;  // chunk positions: up to the prefill chunk

template <typename T, bool SCALED>
__global__ void __launch_bounds__(kThreads) verify_attention_kernel_merge(
    const T* __restrict__ q, const T* __restrict__ k_chunk, const T* __restrict__ v_chunk,
    const int8_t* __restrict__ k8c, const float* __restrict__ ksc,
    const int8_t* __restrict__ v8c, const float* __restrict__ vsc,
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    float* __restrict__ out, int R, int G, int S, int D, int splits, float scale,
    const int* __restrict__ counts, int nkv) {
  __shared__ float sm_cs[kMaxS];  // the row's chunk scores
  const int bn = blockIdx.x;
  const int row = blockIdx.y;
  const int s = row / G;           // the row's chunk position
  if (counts != nullptr && s >= __ldg(counts + bn / nkv)) {  // parked: zeros
    for (int d = threadIdx.x; d < D; d += kThreads) out[((long long)bn * R + row) * D + d] = 0.f;
    return;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long cbase = (long long)bn * S;  // this (slot, head)'s chunk rows
  const T* qr = q + ((long long)bn * R + row) * D;
  for (int j = warp; j <= s; j += kWarps) {  // warp-uniform; later positions are masked
    float acc = 0.f;
    if (SCALED && j < s) {  // an earlier position: the quantize round-trip
      const int8_t* kr = k8c + (cbase + j) * D;
      for (int d = lane; d < D; d += 32) acc += to_f32(qr[d]) * scale * (float)kr[d];
      acc = warp_sum(acc) * __ldg(ksc + cbase + j);
    } else {  // the diagonal, or any position of a dense chunk: exact
      const T* kr = k_chunk + (cbase + j) * D;
      for (int d = lane; d < D; d += 32) acc += to_f32(qr[d]) * scale * to_f32(kr[d]);
      acc = warp_sum(acc);
    }
    if (lane == 0) sm_cs[j] = acc;
  }
  __syncthreads();
  const long long slot0 = ((long long)bn * gridDim.y + row) * splits;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = -INFINITY;
    for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, part_ml[(slot0 + sp) * 2]);
    for (int j = 0; j <= s; ++j) mx = fmaxf(mx, sm_cs[j]);  // finite: the diagonal
    float den = 0.f, num = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const long long slot = slot0 + sp;
      const float f = expf(part_ml[slot * 2] - mx);  // 0 for an empty split
      den += part_ml[slot * 2 + 1] * f;
      num += part_acc[slot * D + d] * f;
    }
    for (int j = 0; j <= s; ++j) {
      const float p = expf(sm_cs[j] - mx);
      const float v = SCALED && j < s ? (float)v8c[(cbase + j) * D + d] * __ldg(vsc + cbase + j)
                                      : to_f32(v_chunk[(cbase + j) * D + d]);
      den += p;
      num += p * v;
    }
    out[((long long)bn * R + row) * D + d] = num / den;
  }
}

// Verify (bf16 q) on the tensor cores: one block a (slot, kv head, group
// of `rows` query rows) x window piece; the last piece also attends the
// chunk.  C: the window's element (int8 with scales, or bf16).
constexpr int kVerifyWarps = 4;
constexpr int kVerifyStages = 2;  // a 3-stage ring (2 blocks an SM) lost on the H100

template <typename C, int D>
__global__ void __launch_bounds__(kVerifyWarps * 32, 3) verify_attention_kernel(
    const __nv_bfloat16* __restrict__ q,
    const C* __restrict__ k8, long long k_sb, long long k_sh, long long k_sw,
    const float* __restrict__ ks, long long ks_sb, long long ks_sh, long long ks_sw,
    const C* __restrict__ v8, long long v_sb, long long v_sh, long long v_sw,
    const float* __restrict__ vs, long long vs_sb, long long vs_sh, long long vs_sw,
    const __nv_bfloat16* __restrict__ k_chunk, const __nv_bfloat16* __restrict__ v_chunk,
    const int8_t* __restrict__ k8c, const float* __restrict__ ksc,
    const int8_t* __restrict__ v8c, const float* __restrict__ vsc,
    const float* __restrict__ mask, long long m_sb,
    float* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int nkv, int W, int R, int S, int group, int rows, int splits, int piece_len, int vec16,
    float scale, const int* __restrict__ counts) {
  using namespace chunk_attn;
  constexpr bool I8 = Cache<C>::kScaled;
  extern __shared__ __align__(16) unsigned char smem_v[];
  __shared__ Segment seg[2];
  const int n_rg = (R + rows - 1) / rows;
  const int bn = blockIdx.x / n_rg;      // slot * nkv + kv head
  const int row0 = (blockIdx.x % n_rg) * rows;
  const int b = bn / nkv;
  const int n = bn % nkv;
  const int piece = blockIdx.y;
  const long long cb = (long long)bn * S;  // the (slot, head)'s chunk rows
  // Rows of this group at or past the slot's live count (counts[b] chunk
  // positions, G rows each) are parked: they attend nothing and come out
  // zero, written here with one piece and by the join with several.
  const int n_rows = min(rows, R - row0);
  const int n_live =
      counts == nullptr ? n_rows : max(0, min(n_rows, __ldg(counts + b) * group - row0));
  float* out_rows = out + ((long long)bn * R + row0) * D;
  if (n_live == 0) {  // the whole group: no window work
    if (splits == 1) {
      for (int i = threadIdx.x; i < n_rows * D; i += blockDim.x) out_rows[i] = 0.f;
    }
    return;
  }
  if (threadIdx.x == 0) {
    const long long k0 = (long long)piece * piece_len;
    Segment w;
    w.k = reinterpret_cast<const unsigned char*>(k8 + b * k_sb + n * k_sh + k0 * k_sw);
    w.v = reinterpret_cast<const unsigned char*>(v8 + b * v_sb + n * v_sh + k0 * v_sw);
    w.k_sw = k_sw * (long long)sizeof(C);
    w.v_sw = v_sw * (long long)sizeof(C);
    w.ks = I8 ? ks + b * ks_sb + n * ks_sh + k0 * ks_sw : nullptr;
    w.vs = I8 ? vs + b * vs_sb + n * vs_sh + k0 * vs_sw : nullptr;
    w.ks_sw = ks_sw;
    w.vs_sw = vs_sw;
    w.mask = mask + b * m_sb + k0;
    w.n_keys = (int)max(0LL, min((long long)piece_len, (long long)W - k0));
    w.vec16 = vec16;
    w.chunk = 0;
    seg[0] = w;
    Segment ch;  // the chunk: codes and scales (int8) or the exact rows, contiguous
    ch.k = I8 ? reinterpret_cast<const unsigned char*>(k8c + cb * D)
              : reinterpret_cast<const unsigned char*>(k_chunk + cb * D);
    ch.v = I8 ? reinterpret_cast<const unsigned char*>(v8c + cb * D)
              : reinterpret_cast<const unsigned char*>(v_chunk + cb * D);
    ch.k_sw = ch.v_sw = (long long)D * sizeof(C);
    ch.ks = I8 ? ksc + cb : nullptr;
    ch.vs = I8 ? vsc + cb : nullptr;
    ch.ks_sw = ch.vs_sw = 1;
    ch.mask = nullptr;
    ch.n_keys = S;
    ch.vec16 = 1;
    ch.chunk = 1;
    seg[1] = ch;
  }
  __syncthreads();
  const Rows rw{q + ((long long)bn * R + row0) * D, D, n_live, row0, group,
                k_chunk + cb * D, v_chunk + cb * D, D};
  float acc[D / 8][4], m[2], l[2];
  const int ksplit = 64 / rows;
  attend<D, I8, true, kVerifyWarps, kVerifyStages>(seg, piece == splits - 1 ? 2 : 1, rw, ksplit,
                                                   scale * kLog2e, smem_v, acc, m, l);
  const long long prow = ((long long)bn * splits + piece) * R + row0;
  if (splits == 1) {
    finish<D, kVerifyWarps>(acc, m, l, ksplit, rw.n_rows, smem_v, nullptr, out_rows, D, nullptr,
                            nullptr);
    for (int i = n_live * D + threadIdx.x; i < n_rows * D; i += blockDim.x) out_rows[i] = 0.f;
  } else {
    finish<D, kVerifyWarps>(acc, m, l, ksplit, rw.n_rows, smem_v, nullptr, nullptr, 0,
                            part_acc + prow * D, part_ml + prow * 2);
  }
}

// Joins the pieces' partials of 512 / D query rows of one (slot, head) a
// block, D / 2 threads a row.
template <int D>
__global__ void __launch_bounds__(256) verify_attention_kernel_join(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    float* __restrict__ out, int R, int splits, const int* __restrict__ counts, int nkv,
    int group) {
  constexpr int kRows = 512 / D;
  const int bn = blockIdx.x;
  const int r = blockIdx.y * kRows + threadIdx.x / (D / 2);
  if (r >= R) return;
  if (counts != nullptr && r / group >= __ldg(counts + bn / nkv)) {  // a parked row: zeros
    *reinterpret_cast<float2*>(out + ((long long)bn * R + r) * D + 2 * (threadIdx.x % (D / 2))) =
        make_float2(0.f, 0.f);
    return;
  }
  chunk_attn::join_row<D, D / 2>(part_acc, part_ml, (long long)bn * splits * R + r, R, splits,
                                 threadIdx.x % (D / 2), out + ((long long)bn * R + r) * D);
}

struct Args {
  const void* q;
  const void* k8; long long k_s[3];
  const void* ks; long long ks_s[3];
  const void* v8; long long v_s[3];
  const void* vs; long long vs_s[3];
  const void* k_self; const void* v_self;
  const void* mask; long long m_sb;
  void* out; void* part;
  int B, nkv, W, D, chunk, splits;
  float scale;
  // Verify only: rows a (slot, head), chunk positions, the model's group
  // width, and the chunk (k_self / v_self above hold k_chunk / v_chunk).
  int R, S, group;
  const void* k8c; const void* ksc; const void* v8c; const void* vsc;
  // Verify only, may be null: int32 [B], the live chunk positions a slot.
  const int* counts;
};

template <typename T, typename C, int G, int VEC, bool VERIFY>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = ((size_t)G * a.chunk + (size_t)kWarps * G * a.D) * sizeof(float);
  auto kernel = decode_attention_kernel<T, C, G, VEC, VERIFY>;
  if (smem > kSmemNoOptIn) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long slots = (long long)a.B * a.nkv;
  const int tiles = VERIFY ? a.R : 1;  // verify: one query row a block
  float* part_acc = static_cast<float*>(a.part);
  float* part_ml = part_acc ? part_acc + slots * tiles * a.splits * G * a.D : nullptr;
  kernel<<<dim3((unsigned)(slots * a.splits), (unsigned)tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q),
      static_cast<const C*>(a.k8), a.k_s[0], a.k_s[1], a.k_s[2],
      static_cast<const float*>(a.ks), a.ks_s[0], a.ks_s[1], a.ks_s[2],
      static_cast<const C*>(a.v8), a.v_s[0], a.v_s[1], a.v_s[2],
      static_cast<const float*>(a.vs), a.vs_s[0], a.vs_s[1], a.vs_s[2],
      static_cast<const T*>(a.k_self), static_cast<const T*>(a.v_self),
      static_cast<const float*>(a.mask), a.m_sb,
      static_cast<float*>(a.out), part_acc, part_ml, a.nkv, a.W, a.D, a.chunk, a.splits,
      a.R, a.scale, a.counts, a.group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (VERIFY) {
    verify_attention_kernel_merge<T, Cache<C>::kScaled>
        <<<dim3((unsigned)slots, (unsigned)tiles), kThreads, 0, stream>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k_self),
            static_cast<const T*>(a.v_self), static_cast<const int8_t*>(a.k8c),
            static_cast<const float*>(a.ksc), static_cast<const int8_t*>(a.v8c),
            static_cast<const float*>(a.vsc), part_acc, part_ml, static_cast<float*>(a.out),
            a.R, a.group, a.S, a.D, a.splits, a.scale, a.counts, a.nkv);
    return cudaGetLastError();
  }
  if (a.splits == 1) return err;
  decode_attention_kernel_combine<T><<<(unsigned)slots, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_self),
      static_cast<const T*>(a.v_self), part_acc, part_ml, static_cast<float*>(a.out), G, a.D,
      a.splits, a.scale);
  return cudaGetLastError();
}

template <typename T, typename C, int VEC, bool VERIFY>
cudaError_t by_group(int G, const Args& a, cudaStream_t st) {
  if constexpr (VERIFY) {  // one query row a block, whatever the model's group
    return launch<T, C, 1, VEC, true>(a, st);
  } else {
    switch (G) {
      case 1: return launch<T, C, 1, VEC, false>(a, st);
      case 2: return launch<T, C, 2, VEC, false>(a, st);
      case 4: return launch<T, C, 4, VEC, false>(a, st);
      case 8: return launch<T, C, 8, VEC, false>(a, st);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T, typename C, bool VERIFY>
cudaError_t by_vec(int vec, int G, const Args& a, cudaStream_t st) {
  if (vec == 16) return by_group<T, C, 16, VERIFY>(G, a, st);
  if (vec == 4) return by_group<T, C, 4, VERIFY>(G, a, st);
  return cudaErrorInvalidValue;
}

// The window and split arguments both entry points share; 0 if they hold.
bool bad_window(int dtype, int cache, int vec, int B, int nkv, int W, int D, int splits,
                int chunk, const void* part, const void* ks, const void* vs) {
  const int elem = cache == 0 ? 1 : dtype == 1 ? 2 : 4;  // bytes an element of k8/v8
  const int per_load = vec / elem;
  const int row_loads = per_load > 0 ? D / per_load : 0;
  return (cache != 0 && cache != 1) || (dtype != 0 && dtype != 1) || (vec != 16 && vec != 4) ||
         per_load <= 0 || D % per_load != 0 || D > kMaxD ||
         (row_loads <= 32 ? 32 % row_loads != 0 : row_loads % 32 != 0) || B <= 0 ||
         nkv <= 0 || W <= 0 || splits <= 0 || chunk <= 0 || chunk > kMaxChunk ||
         (long long)splits * chunk < W || (splits > 1 && part == nullptr) ||
         (cache == 0 && (ks == nullptr || vs == nullptr)) ||
         (long long)B * nkv * splits > 0x7fffffffLL;
}

int dispatch(int dtype, int cache, int vec, int G, const Args& a, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0) {
    return cache == 0 ? (int)by_vec<float, int8_t, false>(vec, G, a, st)
                      : (int)by_vec<float, float, false>(vec, G, a, st);
  }
  return cache == 0 ? (int)by_vec<bf16, int8_t, false>(vec, G, a, st)
                    : (int)by_vec<bf16, bf16, false>(vec, G, a, st);
}

// The bf16 verify: the pieces, then (several) their join.
template <typename C, int D>
cudaError_t launch_verify(const Args& a, int rows, int vec, cudaStream_t stream) {
  constexpr int bytes =
      chunk_attn::Layout<D, Cache<C>::kScaled, kVerifyStages>::template bytes<kVerifyWarps>();
  auto kernel = verify_attention_kernel<C, D>;
  cudaError_t err = chunk_attn::prefer_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  const long long units = (long long)a.B * a.nkv * ((a.R + rows - 1) / rows);
  float* part_acc = a.splits > 1 ? static_cast<float*>(a.part) : nullptr;
  float* part_ml =
      part_acc ? part_acc + (long long)a.B * a.nkv * a.splits * a.R * D : nullptr;
  kernel<<<dim3((unsigned)units, (unsigned)a.splits), kVerifyWarps * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const C*>(a.k8), a.k_s[0], a.k_s[1], a.k_s[2],
      static_cast<const float*>(a.ks), a.ks_s[0], a.ks_s[1], a.ks_s[2],
      static_cast<const C*>(a.v8), a.v_s[0], a.v_s[1], a.v_s[2],
      static_cast<const float*>(a.vs), a.vs_s[0], a.vs_s[1], a.vs_s[2],
      static_cast<const __nv_bfloat16*>(a.k_self), static_cast<const __nv_bfloat16*>(a.v_self),
      static_cast<const int8_t*>(a.k8c), static_cast<const float*>(a.ksc),
      static_cast<const int8_t*>(a.v8c), static_cast<const float*>(a.vsc),
      static_cast<const float*>(a.mask), a.m_sb, static_cast<float*>(a.out), part_acc, part_ml,
      a.nkv, a.W, a.R, a.S, a.group, rows, a.splits, a.chunk, vec == 16 ? 1 : 0, a.scale,
      a.counts);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  verify_attention_kernel_join<D><<<dim3((unsigned)(a.B * a.nkv), (a.R + 512 / D - 1) / (512 / D)),
                                    256, 0, stream>>>(part_acc, part_ml,
                                                      static_cast<float*>(a.out), a.R, a.splits,
                                                      a.counts, a.nkv, a.group);
  return cudaGetLastError();
}

// Blocks of the bf16 verify kernel an SM holds (the occupancy API, after
// the kernel's shared-memory attributes are set), or -1.
template <typename C>
int verify_occupancy() {
  constexpr int bytes =
      chunk_attn::Layout<128, Cache<C>::kScaled, kVerifyStages>::template bytes<kVerifyWarps>();
  auto kernel = verify_attention_kernel<C, 128>;
  int n = -1;
  if (chunk_attn::prefer_shared(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kVerifyWarps * 32, bytes) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

template <typename C>
cudaError_t verify_by_dim(const Args& a, int rows, int vec, cudaStream_t st) {
  switch (a.D) {
    case 16: return launch_verify<C, 16>(a, rows, vec, st);
    case 32: return launch_verify<C, 32>(a, rows, vec, st);
    case 64: return launch_verify<C, 64>(a, rows, vec, st);
    case 128: return launch_verify<C, 128>(a, rows, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_self and v_self).  cache: 0 =
// int8 k8/v8 with f32 scales ks/vs, 1 = k8/v8 of q's type with no scales
// (ks and vs are ignored and may be null).  vec: the bytes a lane loads of
// a cache row, 16 or 4; the base and the (batch, head, position) strides
// of k8 and v8, in bytes, are multiples of it (strides are in elements).
// splits, chunk: the window is cut into `splits` runs of `chunk` positions
// (splits * chunk >= W); with splits > 1, `part` holds B * nkv * splits *
// G * (D + 2) floats of scratch.  Returns the first launch error;
// nothing is synchronised.
extern "C" int decode_attention_launch(
    int dtype, int cache, int G, int vec, const void* q,
    const void* k8, long long k_sb, long long k_sh, long long k_sw,
    const void* ks, long long ks_sb, long long ks_sh, long long ks_sw,
    const void* v8, long long v_sb, long long v_sh, long long v_sw,
    const void* vs, long long vs_sb, long long vs_sh, long long vs_sw,
    const void* k_self, const void* v_self, const void* mask, long long m_sb,
    void* out, void* part, int B, int nkv, int W, int D, int splits, int chunk, float scale,
    void* stream) {
  if (bad_window(dtype, cache, vec, B, nkv, W, D, splits, chunk, part, ks, vs)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k8, {k_sb, k_sh, k_sw}, ks, {ks_sb, ks_sh, ks_sw}, v8, {v_sb, v_sh, v_sw},
               vs, {vs_sb, vs_sh, vs_sw}, k_self, v_self, mask, m_sb, out, part,
               B, nkv, W, D, chunk, splits, scale, G, 1, G, nullptr, nullptr, nullptr, nullptr,
               nullptr};
  return dispatch(dtype, cache, vec, G, a, static_cast<cudaStream_t>(stream));
}

// The verify chunk.  As above, with q [B, nkv, R, D] (R = S * group rows),
// k_chunk / v_chunk of q's type and, for cache 0, k8c / v8c int8 with
// ksc / vsc f32, all [B, nkv, S, D] (scales [B, nkv, S, 1]), contiguous
// and 16-byte aligned.
// bf16 q (dtype 1): `rows` query rows a block (16, 32 or 64); the window
// is cut into `splits` pieces of `chunk` positions, a multiple of 64
// (the last piece non-empty, and it also takes the S chunk keys); with
// splits > 1, `part` holds B * nkv * splits * R * (D + 2) floats.
// f32 q (dtype 0, `rows` ignored): the grid is (B * nkv * splits) x R
// split blocks of `chunk` positions, then B * nkv x R merge blocks; `part`
// holds B * nkv * R * splits * (D + 2) floats whatever the split count.
// counts: null, or int32 [B] on the device, each slot's live chunk
// positions; a row r with r / group >= counts[b] attends nothing and is
// written as zeros (a block whose rows are all parked does no window work).
// Returns the first launch error.
extern "C" int verify_attention_launch(
    int dtype, int cache, int vec, const void* q,
    const void* k8, long long k_sb, long long k_sh, long long k_sw,
    const void* ks, long long ks_sb, long long ks_sh, long long ks_sw,
    const void* v8, long long v_sb, long long v_sh, long long v_sw,
    const void* vs, long long vs_sb, long long vs_sh, long long vs_sw,
    const void* k_chunk, const void* v_chunk, const void* k8c, const void* ksc,
    const void* v8c, const void* vsc, const void* mask, long long m_sb,
    void* out, void* part, int B, int nkv, int W, int D, int splits, int chunk, int R, int S,
    int group, int rows, float scale, const void* counts, void* stream) {
  if (S < 1 || S > kMaxS || group < 1 || R != S * group ||
      (cache == 0 && (k8c == nullptr || ksc == nullptr || v8c == nullptr || vsc == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k8, {k_sb, k_sh, k_sw}, ks, {ks_sb, ks_sh, ks_sw}, v8, {v_sb, v_sh, v_sw},
               vs, {vs_sb, vs_sh, vs_sw}, k_chunk, v_chunk, mask, m_sb, out, part,
               B, nkv, W, D, chunk, splits, scale, R, S, group, k8c, ksc, v8c, vsc,
               static_cast<const int*>(counts)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if ((cache != 0 && cache != 1) || (vec != 16 && vec != 4) || B <= 0 || nkv <= 0 ||
        W <= 0 || (rows != 16 && rows != 32 && rows != 64) || splits < 1 || splits > 65535 ||
        chunk <= 0 || chunk % chunk_attn::kBK != 0 || (long long)splits * chunk < W ||
        (long long)(splits - 1) * chunk >= W || (splits > 1 && part == nullptr) ||
        (cache == 0 && (ks == nullptr || vs == nullptr)) ||
        (long long)B * nkv * ((R + rows - 1) / rows) > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    return cache == 0 ? (int)verify_by_dim<int8_t>(a, rows, vec, st)
                      : (int)verify_by_dim<__nv_bfloat16>(a, rows, vec, st);
  }
  if (dtype != 0 || bad_window(dtype, cache, vec, B, nkv, W, D, splits, chunk, part, ks, vs) ||
      part == nullptr || R > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return cache == 0 ? (int)by_vec<float, int8_t, true>(vec, 1, a, st)
                    : (int)by_vec<float, float, true>(vec, 1, a, st);
}

// Blocks an SM holds of the bf16 verify kernel at D = 128 on an int8
// (cache 0) or bf16 (cache 1) window.
extern "C" int verify_attention_occupancy(int cache) {
  return cache == 0 ? verify_occupancy<int8_t>() : verify_occupancy<__nv_bfloat16>();
}

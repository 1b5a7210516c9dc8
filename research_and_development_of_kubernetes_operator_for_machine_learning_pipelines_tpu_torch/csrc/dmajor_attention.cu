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
//                             multiples of the load width (16 or 4 bytes), W dense
//   ks, vs    [B, NKV, 1, W]  f32; any batch/head strides, W dense
//   mask      [B, 1, W]       f32 additive (0 / -1e9), W dense
//   out       [B, NKV, D, 1]  f32, contiguous
//
// The rounding order is the Pallas kernel's up to the merge: q * scale
// first, then the reduction over D, then * ks + mask, then exp(s - m),
// then ctx / denom.  There is no early exit and no -inf rule: a row whose
// mask is -1e9 everywhere has every score equal to -1e9 in f32, so it
// comes out as the uniform average over W of vs * v, as the reference
// computes.
//
// Bound on the H100: bytes.  Per (slot, head) the kernel reads the D x W
// int8 K and V once (2 * D * W bytes) and does ~4 * D * W flops: 2 flops a
// byte, far under the f32 CUDA cores' ~20.
//
// Design (flash-decoding over W):
//
// - Grid B x NKV x S.  The host picks S (ops/dmajor_attention.py
//   `dmajor_splits`): enough blocks to fill one wave of one block an SM,
//   >= 64 positions a split, at most 8.  Block (slot, head, split) owns
//   `chunk` consecutive positions (a multiple of 16, so every tile starts
//   16-byte aligned); a block past W owns none.
// - Asynchronous copies.  A split is read in tiles of D rows x TP
//   positions (16 KB), K tiles first, then V tiles, through a ring of
//   kStages shared-memory stages filled with `cp.async` (16 bytes a copy
//   when the bases and strides allow, else 4; the wrapper picks the width
//   and passes it).  A K tile's stage also takes its run of ks and the
//   mask, a V tile's its run of vs (4-byte copies), so no global load
//   waits on the way from a tile to the next.  The first V tile is in
//   flight while the last K tile's scores and the softmax are computed.  A
//   ragged end is zero-filled by the copy (its source size), so no byte
//   past W is read.
// - No I2F: an int8 becomes an exact float by one byte permute into the
//   mantissa of 2^23 and one subtraction (`int8x4_to_f32`), on the full-
//   rate pipes; the quarter-rate conversion had made the kernel bound by
//   conversions, not bytes.
// - Scores from shared memory: a thread owns 4 consecutive positions and
//   D / PARTS rows; the PARTS partial sums meet in shared memory, then
//   * ks + mask go to the split's score row (shared memory, chunk floats).
//   The split's max, exp and its sum follow, p in place.
// - Context from shared memory: one warp per D / 8 rows, a lane owning 4
//   positions a step (a 4-byte V word, a float4 of p times one of vs), the
//   rows' sums kept in registers over the V tiles and reduced by shuffles
//   once.
// - Merge of S > 1 splits: each split writes its (m, l, ctx[D]) to
//   scratch and a merge kernel launched by the same C call rescales by
//   exp(m_i - M).  A merge inside a thread block cluster, through
//   distributed shared memory, lost to it on the H100 at 4 and 8 splits
//   (PERF.md, section 6).  An empty split has m = -inf, l = 0, ctx = 0 and
//   weighs exactly 0 (split 0 always owns a position, so M is finite).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16384;     // a tile's int8: D rows x (16384 / D) positions
constexpr int kStages = 2;            // the ring: 3 or 4 lost at 32 slots (fewer blocks an SM)
constexpr int kMaxChunk = 6144;       // positions a split's score row may hold
constexpr int kMaxSplits = 8;         // the wrapper's MAX_SPLITS
constexpr int kSmemNoOptIn = 48 * 1024;

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

// VEC bytes from global to shared memory, of which the first `bytes` are
// read and the rest zero-filled.
template <int VEC>
__device__ __forceinline__ void cp_async(int8_t* dst, const int8_t* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  }
}
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 4 int8 of a word as exact floats without the quarter-rate I2F: byte
// b + 128 goes into the low mantissa of 2^23 (one PRMT), and 2^23 + 128 is
// subtracted (one FADD): (2^23 + b + 128) - (2^23 + 128) = b exactly.
__device__ __forceinline__ void int8x4_to_f32(int w, float f[4]) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

__device__ __forceinline__ float dot4(int w, float4 p) {
  float f[4];
  int8x4_to_f32(w, f);
  return f[0] * p.x + f[1] * p.y + f[2] * p.z + f[3] * p.w;
}

// 64 registers (4 blocks an SM) where that leaves no spill, D >= 64; 80
// at D <= 32.
template <typename T, int D, int VEC>
__global__ void __launch_bounds__(kThreads, D < 64 ? 3 : 4) dmajor_attention_kernel(
    const T* __restrict__ q,
    const int8_t* __restrict__ k8t, long long k_sb, long long k_sh, long long k_sd,
    const float* __restrict__ ks, long long ks_sb, long long ks_sh,
    const int8_t* __restrict__ v8t, long long v_sb, long long v_sh, long long v_sd,
    const float* __restrict__ vs, long long vs_sb, long long vs_sh,
    const float* __restrict__ mask, long long m_sb,
    float* __restrict__ out, float* __restrict__ part, int nkv, int W, int chunk, int splits,
    float scale) {
  constexpr int TP = kTileBytes / D;        // positions a tile
  constexpr int G4 = TP / 4;                // 4-position groups a tile (>= 32)
  constexpr int PARTS = kThreads / G4;      // D-parts of the score phase
  constexpr int RPP = D / PARTS;            // rows a part sums
  constexpr int RPW = D / kWarps;           // rows a warp owns in the context phase
  constexpr int STAGE = kTileBytes + 2 * TP * 4;  // [D][TP] int8, then [2][TP] f32
  static_assert(G4 >= 32 && kThreads % G4 == 0 && D % PARTS == 0, "tile shape");

  // A stage holds a K tile with its ks and mask, or a V tile with its vs.
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stages = smem;                                  // kStages x STAGE
  float* sm_s = reinterpret_cast<float*>(smem + kStages * STAGE);  // chunk: scores, then p
  __shared__ float sm_q[D];
  __shared__ __align__(16) float sm_part[PARTS > 1 ? PARTS * TP : 1];
  __shared__ float sm_red[kWarps];
  __shared__ float sm_ctx[D];
  __shared__ float sm_ml[2];

  const int bn = blockIdx.x / splits;      // slot * nkv + head
  const int split = blockIdx.x % splits;
  const int b = bn / nkv;
  const int n = bn % nkv;
  const int p0 = split * chunk;
  const int len = max(min(W - p0, chunk), 0);  // 0: a split past W
  const int ntiles = (len + TP - 1) / TP;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int8_t* kb = k8t + (long long)b * k_sb + (long long)n * k_sh + p0;
  const int8_t* vb = v8t + (long long)b * v_sb + (long long)n * v_sh + p0;
  const float* ksb = ks + (long long)b * ks_sb + (long long)n * ks_sh + p0;
  const float* vsb = vs + (long long)b * vs_sb + (long long)n * vs_sh + p0;
  const float* mrow = mask + (long long)b * m_sb + p0;

  // Tile t of the split's 2 * ntiles (K tiles, then V tiles) into stage t % kStages.
  auto issue = [&](int t) {
    if (t < 2 * ntiles) {
      const bool is_v = t >= ntiles;
      const int i0 = (is_v ? t - ntiles : t) * TP;
      const int cnt = min(TP, len - i0);
      const int8_t* src = (is_v ? vb : kb) + i0;
      const long long sd = is_v ? v_sd : k_sd;
      int8_t* dst = reinterpret_cast<int8_t*>(stages + (t % kStages) * STAGE);
      float* aux = reinterpret_cast<float*>(dst + kTileBytes);
      const int per_row = (cnt + VEC - 1) / VEC;
      for (int c = tid; c < D * per_row; c += kThreads) {
        const int d = c / per_row;
        const int col = (c % per_row) * VEC;
        cp_async<VEC>(dst + d * TP + col, src + (long long)d * sd + col, min(VEC, cnt - col));
      }
      for (int i = tid; i < ((cnt + 3) & ~3); i += kThreads) {
        if (i >= cnt) {
          aux[i] = 0.f;  // the last group of 4 reads no stale vs
        } else if (is_v) {
          cp_async_f32(aux + i, vsb + i0 + i);
        } else {
          cp_async_f32(aux + i, ksb + i0 + i);
          cp_async_f32(aux + TP + i, mrow + i0 + i);
        }
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count uniform
  };
#pragma unroll
  for (int t = 0; t < kStages; ++t) issue(t);

  for (int d = tid; d < D; d += kThreads) sm_q[d] = to_f32(q[(long long)bn * D + d]) * scale;

  float acc[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) acc[r] = 0.f;
  float mx = -INFINITY, l = 0.f;

  for (int t = 0; t < 2 * ntiles; ++t) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int8_t* tile = reinterpret_cast<const int8_t*>(stages + (t % kStages) * STAGE);
    const float* aux = reinterpret_cast<const float*>(tile + kTileBytes);
    if (t < ntiles) {
      // Scores of K tile t: 4 positions x RPP rows a thread.
      const int i0 = t * TP;
      const int cnt = min(TP, len - i0);
      const int g = tid % G4;
      const int part = tid / G4;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < RPP; ++r) {
        const int d = part * RPP + r;
        float k[4];
        int8x4_to_f32(*reinterpret_cast<const int*>(tile + d * TP + 4 * g), k);
        const float qd = sm_q[d];
        a[0] += qd * k[0];
        a[1] += qd * k[1];
        a[2] += qd * k[2];
        a[3] += qd * k[3];
      }
      if constexpr (PARTS == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * g + e;
          if (i < cnt) sm_s[i0 + i] = a[e] * aux[i] + aux[TP + i];
        }
      } else {
        *reinterpret_cast<float4*>(&sm_part[part * TP + 4 * g]) = make_float4(a[0], a[1], a[2], a[3]);
        __syncthreads();
        for (int i = tid; i < cnt; i += kThreads) {
          float s = 0.f;
#pragma unroll
          for (int p = 0; p < PARTS; ++p) s += sm_part[p * TP + i];
          sm_s[i0 + i] = s * aux[i] + aux[TP + i];
        }
      }
      if (t == ntiles - 1) {
        // Softmax over the split, while the first V tile lands.
        __syncthreads();
        float x = -INFINITY;
        for (int i = tid; i < len; i += kThreads) x = fmaxf(x, sm_s[i]);
        x = warp_max(x);
        if (lane == 0) sm_red[warp] = x;
        __syncthreads();
        mx = sm_red[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_red[w]);
        __syncthreads();  // every thread has read sm_red before it is reused
        float sum = 0.f;
        const int len4 = (len + 3) & ~3;
        for (int i = tid; i < len4; i += kThreads) {
          if (i < len) {
            const float p = expf(sm_s[i] - mx);
            sum += p;
            sm_s[i] = p;  // times vs with the V tile that brings it
          } else {
            sm_s[i] = 0.f;  // the last group of 4 reads no stale weight
          }
        }
        sum = warp_sum(sum);
        if (lane == 0) sm_red[warp] = sum;
        __syncthreads();
#pragma unroll
        for (int w = 0; w < kWarps; ++w) l += sm_red[w];
      }
    } else {
      // Context of V tile t - ntiles: warp `warp` owns rows [warp * RPW, +RPW).
      const int i0 = (t - ntiles) * TP;
      const int groups = (min(TP, len - i0) + 3) / 4;
      for (int g = lane; g < groups; g += 32) {
        const float4 p = *reinterpret_cast<const float4*>(&sm_s[i0 + 4 * g]);
        const float4 v = *reinterpret_cast<const float4*>(&aux[4 * g]);
        const float4 pv = make_float4(p.x * v.x, p.y * v.y, p.z * v.z, p.w * v.w);
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int w = *reinterpret_cast<const int*>(tile + (warp * RPW + r) * TP + 4 * g);
          acc[r] += dot4(w, pv);
        }
      }
    }
    __syncthreads();  // the stage is free before it is refilled
    issue(t + kStages);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float s = warp_sum(acc[r]);
    if (lane == 0) sm_ctx[warp * RPW + r] = s;
  }
  if (tid == 0) {
    sm_ml[0] = mx;  // -inf and 0 for a split past W
    sm_ml[1] = l;
  }
  __syncthreads();

  if (splits == 1) {
    for (int d = tid; d < D; d += kThreads) out[(long long)bn * D + d] = sm_ctx[d] / sm_ml[1];
    return;
  }
  // The split's partial (m, l, ctx[D]) for the merge kernel.
  float* pp = part + (long long)blockIdx.x * (D + 2);
  for (int d = tid; d < D + 2; d += kThreads) pp[d] = d < 2 ? sm_ml[d] : sm_ctx[d - 2];
}

// Merges the S partials (m, l, ctx[D]) of one (slot, head).
template <int D>
__global__ void __launch_bounds__(D) dmajor_attention_kernel_merge(
    const float* __restrict__ part, float* __restrict__ out, int splits) {
  const int bn = blockIdx.x;
  const int d = threadIdx.x;
  const float* pp = part + (long long)bn * splits * (D + 2);
  float m_all = -INFINITY;
  for (int r = 0; r < splits; ++r) m_all = fmaxf(m_all, pp[r * (D + 2)]);
  float num = 0.f, den = 0.f;
  for (int r = 0; r < splits; ++r) {
    const float f = expf(pp[r * (D + 2)] - m_all);  // 0 for a split past W
    den += pp[r * (D + 2) + 1] * f;
    num += pp[r * (D + 2) + 2 + d] * f;
  }
  out[(long long)bn * D + d] = num / den;
}

struct Args {
  const void* q;
  const void* k8t; long long k_s[3];
  const void* ks; long long ks_s[2];
  const void* v8t; long long v_s[3];
  const void* vs; long long vs_s[2];
  const void* mask; long long m_sb;
  void* out; void* part;
  int B, nkv, W, chunk, splits;
  float scale;
};

template <typename T, int D, int VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = dmajor_attention_kernel<T, D, VEC>;
  const size_t stage = kTileBytes + 2 * (kTileBytes / D) * sizeof(float);
  const size_t smem = (size_t)kStages * stage + (size_t)a.chunk * sizeof(float);
  if (smem > kSmemNoOptIn) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)((long long)a.B * a.nkv * a.splits), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q),
      static_cast<const int8_t*>(a.k8t), a.k_s[0], a.k_s[1], a.k_s[2],
      static_cast<const float*>(a.ks), a.ks_s[0], a.ks_s[1],
      static_cast<const int8_t*>(a.v8t), a.v_s[0], a.v_s[1], a.v_s[2],
      static_cast<const float*>(a.vs), a.vs_s[0], a.vs_s[1],
      static_cast<const float*>(a.mask), a.m_sb,
      static_cast<float*>(a.out), static_cast<float*>(a.part), a.nkv, a.W, a.chunk, a.splits,
      a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  dmajor_attention_kernel_merge<D><<<(unsigned)((long long)a.B * a.nkv), D, 0, stream>>>(
      static_cast<const float*>(a.part), static_cast<float*>(a.out), a.splits);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t by_dim(int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16, VEC>(a, st);
    case 32: return launch<T, 32, VEC>(a, st);
    case 64: return launch<T, 64, VEC>(a, st);
    case 128: return launch<T, 128, VEC>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_vec(int vec, int D, const Args& a, cudaStream_t st) {
  if (vec == 16) return by_dim<T, 16>(D, a, st);
  if (vec == 4) return by_dim<T, 4>(D, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q).  vec: bytes a copy moves, 16 or 4;
// the bases and the (batch, head, row) strides of k8t and v8t are
// multiples of it.  Strides are in elements: k8t and v8t (batch, head, row
// d), ks and vs (batch, head), mask (batch).  The window is cut into
// `splits` (1..8) runs of `chunk` positions (a multiple of 16, at most
// 6144, splits * chunk >= W); with splits > 1, `part` holds B * nkv *
// splits * (D + 2) floats of scratch for the splits' partials, which a
// merge kernel launched here joins.  Returns the first launch error;
// nothing is synchronised.
extern "C" int dmajor_attention_launch(
    int dtype, int vec, const void* q,
    const void* k8t, long long k_sb, long long k_sh, long long k_sd,
    const void* ks, long long ks_sb, long long ks_sh,
    const void* v8t, long long v_sb, long long v_sh, long long v_sd,
    const void* vs, long long vs_sb, long long vs_sh,
    const void* mask, long long m_sb,
    void* out, void* part, int B, int nkv, int D, int W, int splits, int chunk, float scale,
    void* stream) {
  if (B <= 0 || nkv <= 0 || W <= 0 || splits <= 0 || splits > kMaxSplits || chunk <= 0 ||
      chunk % 16 != 0 || chunk > kMaxChunk || (long long)splits * chunk < W ||
      (long long)B * nkv * splits > 0x7fffffffLL || (splits > 1 && part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k8t, {k_sb, k_sh, k_sd}, ks, {ks_sb, ks_sh}, v8t, {v_sb, v_sh, v_sd},
               vs, {vs_sb, vs_sh}, mask, m_sb, out, part, B, nkv, W, chunk, splits, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)by_vec<float>(vec, D, a, st);
  if (dtype == 1) return (int)by_vec<__nv_bfloat16>(vec, D, a, st);
  return (int)cudaErrorInvalidValue;
}

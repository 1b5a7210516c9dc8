// Flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_flash_kernel` of the JAX package's
// ops/flash_attention.py (line 62; its pallas_call at line 136):
// blockwise online-softmax attention where a query tile stays resident
// and key/value tiles stream through it, so the score matrix never
// reaches device memory.
//
//   q     [B, S, H, D] or [B, H, S, D]: any batch/head/position strides, D dense
//   k, v  [B, T, NKV, D] likewise, H % NKV == 0 (grouped-query attention:
//         query head h reads K/V head h / (H / NKV) through the strides)
//   bias  [B, T]       optional f32 additive key bias (BERT's mask_bias), T dense
//   o     [B, S, H, D] any batch/head/position strides, D dense; q's type
//
// scores = (q . k) * scale in f32, plus bias[b, key]; then the kv_len mask
// (key >= kv_len) and the causal mask (key > q_offset + query) each REPLACE the score
// with -1e30, as the Pallas kernel does, and masked keys still take part
// in the softmax: kv_len <= 0 masks every key, all T scores are -1e30, and
// the row comes out as the mean of V over the T keys, as the kernel's
// oracle `attention_reference` gives.  Keys past T, which only pad the
// ragged last tile, take no part (-inf).  The running max starts at -1e30,
// not -inf, so a tile whose keys are all -1e30 or padding never computes
// exp(-inf - -inf).  Any S and T: ragged query and key tiles are masked
// here, nothing is padded on the host.
//
// Log-sum-exp output (ring attention's blocks).  With `lse` given, each
// row also writes m + log(l) of its scaled scores, in natural units (the
// bf16 kernel keeps m in log2 units and l as the sum of the rounded p), to
// a contiguous f32 [B, H, S]; a row with no visible key (kv_len <= 0: its
// max is still -1e30) writes -inf, and its output is the mean of V as
// before.  A caller that merges two blocks' outputs weighs each by
// exp(lse - logaddexp(lse_a, lse_b)).  Without it the kernels run as they
// did: the one added store sits behind a null test after the key loop.
//
// Query offset (Llama's chunked prefill).  Query row i sits at key
// position q_offset + i: a chunk of S queries at cache offset q_offset
// attends the cached prefix and itself (q_offset + S <= T, checked by the
// wrapper).  The offset moves the diagonal: each query tile skips the key
// tiles past its last query's position, so a chunk reads only the prefix
// it needs.  Grouped heads cost nothing extra: the G query heads of one
// K/V head are neighbouring blocks, so the second to G-th read its K/V
// tiles from L2.
//
// Bound on the H100.  At BERT-base (S = T = 128, D = 64) each (batch,
// head) reads 3 * S * D inputs and does 4 * S * T * D flops: 43 flops a
// byte in bf16, far under the ~295 a byte where the bf16 tensor cores
// (989 TFLOP/s) would set the pace, so the bound is the bytes.  At S = T =
// 1024, D = 128 it is 256 flops a byte, and the operations bound it.
//
// bf16 (the serving type): tensor cores, FA2-style.  One block of 4 warps
// per (batch * head, 64-row query tile); each warp owns 16 query rows.
// Q . K^T and P . V are `mma.sync.m16n8k16` bf16 x bf16 -> f32, with the
// accumulators in registers.  The Q tile and 64-key K/V tiles go to shared
// memory with 16-byte `cp.async`, K/V double-buffered (tile j + 1 loads
// while tile j computes), the tile's 64 bias values beside them with
// 4-byte `cp.async`; rows past S or T are zero-filled by the copy.
// Each shared row is padded by 16 bytes, so the 8 rows an `ldmatrix`
// (`.trans` for V) reads fall in 8 different bank groups: no conflicts.
// The online softmax runs on the accumulator fragments: a lane holds two
// query rows (lane / 4 and lane / 4 + 8) and two columns of every n8 key
// tile, so the row max and sum take two quad shuffles, and each lane reads
// only its own keys' bias (a float2 from shared memory).  Scores are kept
// in log2 units (scale * log2 e folded into one multiply), so each
// probability is one ex2.  The output tile goes back through the warp's
// rows of the Q tile, so it leaves with 16-byte stores.  P is rounded to
// bf16 in registers and reused
// directly as the A operand of P . V (the C fragment of Q . K^T is the A
// fragment of the next product), never staged in shared memory.  The
// rounding is relative 2^-9 per probability, taken after the running max
// is subtracted, so each p is in [0, 1]; the row sum adds the ROUNDED
// values, so the output stays a convex combination of V's rows.  It is
// the one rounding the CUDA-core kernel did not make, well inside the
// 2e-2 bf16 tolerance (the CPU tests emulate it at BERT-base width).
// Key tiles wholly past kv_len, or (causal) past the position of the
// tile's last query (q_offset + q0 + 63), are skipped; with kv_len <= 0
// none is.  Tiles wholly below the diagonal still go through the masks
// (see below).
//
// What still holds it back: `mma.sync` reaches a fraction of the tensor
// cores' peak (wgmma and TMA are the next step, and matter where the
// operations bound it: long S at D = 128); 4 blocks of 4 warps an SM at
// D <= 64 and 2 at D = 128 hide little of a tile's copy latency; every
// score goes through the masks (a path that skips them on unmasked tiles
// was slower at BERT's shape); and at S = 128 the two query tiles of a
// head each read its K/V (the second from L2).
//
// f32 (kept for exactness checks; no model serves it): the CUDA-core
// kernel.  One 256-thread block per (batch * head, 64-row query tile);
// four threads share a query row, each owning D/4 of its elements in
// interleaved 16-byte groups, with q (pre-scaled) and the f32 accumulator
// in registers; K/V tiles of 64 rows (32 at D = 128) staged in shared
// memory; keys in chunks of 16 with one online-softmax rescale each.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "chunk_attention.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kBQ = 64;            // query rows per block (both kernels)
constexpr int kSmemNoOptIn = 48 * 1024;  // bytes a block may use without opting in

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kMmaBK = 64;        // keys per tile

template <int D>
struct MmaLayout {
  static constexpr int kLd = D + 8;                     // bf16 per padded shared row
  static constexpr int kTile = kMmaBK * kLd;            // one K or V tile
  // Q, K[2] and V[2] in bf16, then two tiles' bias in f32.
  static constexpr int kBytes = (kBQ * kLd + 4 * kTile) * 2 + 2 * kMmaBK * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false writes 16 zero bytes instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared; `valid` false writes 4 zero bytes instead.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  sum += __low2float(h) + __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D <= 64 keeps to 128 registers, so 4 blocks fit an SM (shared memory
// allows 4 at D = 64); D = 128 fits 2 by its 87.6 KB of shared memory.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kMmaThreads, D <= 64 ? 4 : 2) flash_attention_kernel_bf16(
    const __nv_bfloat16* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const __nv_bfloat16* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
    const __nv_bfloat16* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
    const float* __restrict__ bias, long long bias_sb,
    __nv_bfloat16* __restrict__ o, long long o_sb, long long o_sh, long long o_ss,
    float* __restrict__ lse,
    int H, int S, int T_len, int kv_len, int q_offset, int group, float scale) {
  using L = MmaLayout<D>;
  constexpr int LD = L::kLd;
  constexpr int CPR = D / 8;   // 16-byte chunks per row
  constexpr int KS = D / 16;   // k-steps of Q . K^T
  constexpr int DN = D / 8;    // n8 tiles of the output
  constexpr int NT = kMmaBK / 8;  // n8 tiles of a key tile
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kBQ * LD;        // [2][kMmaBK][LD]
  __nv_bfloat16* sv = sk + 2 * L::kTile;    // [2][kMmaBK][LD]
  float* sb = reinterpret_cast<float*>(sv + 2 * L::kTile);  // [2][kMmaBK] key bias

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;  // the K/V head of this query head
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const __nv_bfloat16* qbase = q + (long long)b * q_sb + (long long)h * q_sh;
  const __nv_bfloat16* kbase = k + (long long)b * k_sb + (long long)hk * k_sh;
  const __nv_bfloat16* vbase = v + (long long)b * v_sb + (long long)hk * v_sh;
  const float* brow = bias ? bias + (long long)b * bias_sb : nullptr;

  const int kv_eff = kv_len < T_len ? kv_len : T_len;
  const bool no_key = kv_eff <= 0;  // every key masked: the row averages all T
  int kv_end = no_key ? T_len : kv_eff;
  // keys past the position of the tile's last query
  if (!no_key && CAUSAL && q_offset + q0 + kBQ < kv_end) kv_end = q_offset + q0 + kBQ;
  const int n_tiles = (kv_end + kMmaBK - 1) / kMmaBK;              // >= 1

  for (int idx = tid; idx < kBQ * CPR; idx += kMmaThreads) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * 8;
    const bool ok = q0 + r < S;
    cp_async16(sq + r * LD + c, ok ? qbase + (long long)(q0 + r) * q_ss + c : qbase, ok);
  }
  // One tile's K and V rows and its keys' bias (zero-filled past T).
  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * kMmaBK;
    for (int idx = tid; idx < kMmaBK * CPR; idx += kMmaThreads) {
      const int r = idx / CPR;
      const int c = (idx % CPR) * 8;
      const int key = k0 + r;
      const bool ok = key < T_len;
      cp_async16(sk + buf * L::kTile + r * LD + c,
                 ok ? kbase + (long long)key * k_st + c : kbase, ok);
      cp_async16(sv + buf * L::kTile + r * LD + c,
                 ok ? vbase + (long long)key * v_st + c : vbase, ok);
    }
    if (brow != nullptr && tid < kMmaBK) {
      const bool ok = k0 + tid < T_len;
      cp_async4(sb + buf * kMmaBK + tid, ok ? brow + k0 + tid : brow, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // This lane's query rows: row0 and row0 + 8 of the block's tile; qi0 is
  // row0's key position.
  const int row0 = warp * 16 + lane / 4;
  const int qi0 = q_offset + q0 + row0;
  const int col = 2 * (lane % 4);  // this lane's first column of an n8 tile
  // Scores are kept in log2 units (times log2 e), so each exponential is
  // one ex2; the masks and the -1e30 floor compare alike in either unit.
  constexpr float kLog2e = 1.4426950408889634f;
  const float sl = scale * kLog2e;
  uint32_t qf[KS][4];
  float oacc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        ldmatrix_x4(qf[ks], sq + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                ks * 16 + (lane / 16) * 8);
      }
    }
    const __nv_bfloat16* skt = sk + buf * L::kTile;
    const __nv_bfloat16* svt = sv + buf * L::kTile;
    const float* sbt = sb + buf * kMmaBK;

    // S = Q . K^T over the 64 keys: 8 n8 tiles of f32 accumulators.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, skt + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + ks * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // Scale, bias, masks; the running max over the quad.
    const int k0 = t * kMmaBK;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float2 bj = make_float2(0.f, 0.f);
      if (brow != nullptr) bj = *reinterpret_cast<const float2*>(sbt + j * 8 + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + col + (e & 1);
        const int qi = qi0 + (e >> 1) * 8;
        float x = fmaf(s[j][e], sl, ((e & 1) ? bj.y : bj.x) * kLog2e);
        const bool masked = key >= kv_eff || (CAUSAL && key > qi);
        x = key >= T_len ? -INFINITY : masked ? kNegInf : x;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < DN; ++i) {
      oacc[i][0] *= corr[0]; oacc[i][1] *= corr[0];
      oacc[i][2] *= corr[1]; oacc[i][3] *= corr[1];
    }

    // P in bf16, laid out as the A fragments of four k16 steps over the keys.
    uint32_t pf[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pf[j / 2][(j % 2) * 2] = pack_bf16(exp2f(s[j][0] - m_run[0]),
                                         exp2f(s[j][1] - m_run[0]), l_run[0]);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(exp2f(s[j][2] - m_run[1]),
                                             exp2f(s[j][3] - m_run[1]), l_run[1]);
    }

    // O += P . V: V's rows are keys, so ldmatrix.trans gives the col-major B.
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, svt + (kt * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(oacc[2 * dp], pf[kt], vb[0], vb[1]);
        mma_bf16(oacc[2 * dp + 1], pf[kt], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before tile t + 2 loads into it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // l >= 1: the key that set the final max has p = 1, exact in bf16.
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  if (lse != nullptr && lane % 4 == 0) {
    // The row's log-sum-exp in natural units: m and l are in log2 units.
    // A row whose every key is masked (max still -1e30) has none: -inf.
    constexpr float kLn2 = 0.6931471805599453f;
    float* lrow = lse + (long long)bh * S + q0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (q0 + row0 + r * 8 < S) {
        lrow[row0 + r * 8] =
            m_run[r] > kNegInf ? (m_run[r] + log2f(l_run[r])) * kLn2 : -INFINITY;
      }
    }
  }
  __nv_bfloat16* obase = o + (long long)b * o_sb + (long long)h * o_sh;
  // This warp's 16 rows go through its own rows of the Q tile (read into
  // registers at the first tile), then out with 16-byte stores.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < DN; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(sq + (row0 + r * 8) * LD + i * 8 + col) =
          __floats2bfloat162_rn(oacc[i][2 * r] * inv[r], oacc[i][2 * r + 1] * inv[r]);
    }
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int r = warp * 16 + idx / CPR;
    const int c = (idx % CPR) * 8;
    if (q0 + r < S) {
      *reinterpret_cast<uint4*>(obase + (long long)(q0 + r) * o_ss + c) =
          *reinterpret_cast<const uint4*>(sq + r * LD + c);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTPR = kThreads / kBQ;  // threads per query row
constexpr int kChunk = 16;            // keys per online-softmax step
constexpr int kW = 4;                 // floats per 16-byte group

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel_f32(
    const float* __restrict__ q, long long q_sb, long long q_sh, long long q_ss,
    const float* __restrict__ k, long long k_sb, long long k_sh, long long k_st,
    const float* __restrict__ v, long long v_sb, long long v_sh, long long v_st,
    const float* __restrict__ bias, long long bias_sb,
    float* __restrict__ o, long long o_sb, long long o_sh, long long o_ss,
    float* __restrict__ lse,
    int H, int S, int T_len, int kv_len, int q_offset, int group, float scale) {
  constexpr int DS = D / kTPR;            // elements a thread owns
  constexpr int NG = DS / kW;             // 16-byte groups a thread owns
  constexpr int BK = D == 128 ? 32 : 64;  // key rows per tile
  static_assert(D % (kTPR * kW) == 0, "head dim must split into thread groups");

  __shared__ __align__(16) float sk[BK * D];
  __shared__ __align__(16) float sv[BK * D];
  __shared__ float sbias[BK];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int row = tid / kTPR;
  const int sub = tid % kTPR;
  const int qi = q0 + row;
  const int qpos = q_offset + qi;  // this row's key position
  const bool row_valid = qi < S;

  // Element e of this thread's slice lives at d = (sub + kTPR * (e / kW)) * kW + e % kW.
  float qr[DS], acc[DS];
  {
    const float* qrow = q + (long long)b * q_sb + (long long)h * q_sh + (long long)qi * q_ss;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        const int d = (sub + kTPR * g) * kW + w;
        qr[g * kW + w] = row_valid ? qrow[d] * scale : 0.f;
        acc[g * kW + w] = 0.f;
      }
    }
  }
  float m = kNegInf, l = 0.f;

  const int kv_eff = kv_len < T_len ? kv_len : T_len;
  const bool no_key = kv_eff <= 0;  // every key masked: the row averages all T
  int kv_end = no_key ? T_len : kv_eff;
  // keys past the position of the tile's last query
  if (!no_key && CAUSAL && q_offset + q0 + kBQ < kv_end) kv_end = q_offset + q0 + kBQ;
  const float* kbase = k + (long long)b * k_sb + (long long)(h / group) * k_sh;
  const float* vbase = v + (long long)b * v_sb + (long long)(h / group) * v_sh;
  const float* brow = bias ? bias + (long long)b * bias_sb : nullptr;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * (D / kW); idx += kThreads) {
      const int r = idx / (D / kW);
      const int c = (idx % (D / kW)) * kW;
      const int key = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < T_len) {
        kx = *reinterpret_cast<const float4*>(kbase + (long long)key * k_st + c);
        vx = *reinterpret_cast<const float4*>(vbase + (long long)key * v_st + c);
      }
      *reinterpret_cast<float4*>(sk + r * D + c) = kx;
      *reinterpret_cast<float4*>(sv + r * D + c) = vx;
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
        const float* krow = sk + (c0 + j) * D;
        float dot = 0.f;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float kf[kW];
          load4(krow + (sub + kTPR * g) * kW, kf);
#pragma unroll
          for (int w = 0; w < kW; ++w) dot = fmaf(qr[g * kW + w], kf[w], dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int key = k0 + c0 + j;
        dot += sbias[c0 + j];
        const bool masked = key >= kv_eff || (CAUSAL && key > qpos);
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
        const float* vrow = sv + (c0 + j) * D;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float vf[kW];
          load4(vrow + (sub + kTPR * g) * kW, vf);
#pragma unroll
          for (int w = 0; w < kW; ++w) acc[g * kW + w] = fmaf(p, vf[w], acc[g * kW + w]);
        }
      }
      m = m_new;
    }
  }

  if (row_valid && lse != nullptr && sub == 0) {
    // The row's log-sum-exp; a row whose every key is masked has none: -inf.
    lse[(long long)bh * S + qi] = m > kNegInf ? m + logf(l) : -INFINITY;
  }
  if (row_valid) {
    const float inv = 1.f / l;  // l >= 1: the largest score gives p = 1
    float* orow = o + (long long)b * o_sb + (long long)h * o_sh + (long long)qi * o_ss;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int w = 0; w < kW; ++w) orow[(sub + kTPR * g) * kW + w] = acc[g * kW + w] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// Ragged packed prefill: a cache row's window, then the chunk (bf16 MMA)
// ---------------------------------------------------------------------------
//
// The attention of packed multi-admission prefill (the JAX package's
// `_block_verify_deferred` lines, models/llama.py:1039-1169, run by
// `prefill_chunks_ragged` at the prefill chunk): query j of packed row b
// and head h attends keys 0 .. offsets[b] - 1 of cache row slots[b]
// ([NS, NKV, T, D], head-major) and the chunk keys i <= j ([B, C, NKV, D])
// in one softmax.  A row whose offset is at capacity (a parked pad row) or
// whose slot is out of range reads no window.  I8 (the int8 cache): the
// window and the chunk below the diagonal are codes with one f32 scale a
// (position, head), the key scale on the score and the value scale on p
// before its bf16 rounding (the reference's order); the diagonal is exact.
// !I8 (the bf16 cache): every key exact.
//
// Bound on the H100 (Llama-2-7B, B_p = 4, C = 256, offsets 0/256/768/3840,
// H = NKV = 32, D = 128, int8): ~83 MB of inputs and output, ~0.025 ms at
// 3.35 TB/s, against ~22.6 GFLOP of products, ~0.023 ms at 989 TFLOP/s:
// the bytes, with the operations close behind (bf16 cache: 113 MB).
//
// Design: `flash_ragged_kernel<D, I8, NW>`, the core of chunk_attention.cuh
// (the same one the verify chunk runs) with p rounded to bf16.
// - Grid (B * H * query tiles of NW * 16 rows) x pieces.  The host's plan
//   (ops/flash_attention.py `ragged_plan`) fixes the piece length (a
//   multiple of 64 keys) and the piece count from T alone, so the grid
//   needs no sync: a block reads slots[b] and offsets[b] itself, and one
//   whose piece lies past its row's window exits at once.  A row's window
//   is cut into ceil(offset / piece) pieces; the last also attends the
//   chunk keys up to its query tile's diagonal.  The pieces of a long
//   window run side by side, so a 3840-key window no longer runs 60 tiles
//   in series.
// - A row of one piece (a window no longer than a piece, or none) is
//   written by its block.  Otherwise every piece writes an f32 partial
//   and `flash_ragged_kernel_merge`, launched by the same C call, joins
//   them (max-rescale) into the bf16 output.
// - Tiles stream through a 2-stage `cp.async` ring as raw int8 codes
//   (+ scales) or bf16 rows; int8 is converted once a tile in shared
//   memory.  4 warps of 16 query rows a block (a 64-row query tile), 3
//   blocks an SM; 8-warp blocks (one an SM) and a 3-stage ring (two
//   blocks an SM) were slower on the H100 (chip_smoke.py's sweeps).
//
// What still holds it back (H100 80GB HBM3, 700 W, chip_smoke.py: 0.20
// device ms int8, 0.15 bf16 at the shape above, 8x and 4.5x the bound):
// latency at 12 warps an SM (168 registers, 73 KB of shared memory) with
// a 16-key `mma.sync` softmax step, not wgmma/TMA; each query tile of a
// (row, head) reads the window again (from L2 after the first); the int8
// conversion (~0.05 ms here) runs between two barriers; the partials of a
// split window cost (D + 2) * 4 bytes a query row a piece.
constexpr int kRagWarps = 4;   // 8-warp blocks (one an SM) lost on the H100
constexpr int kRagStages = 2;  // so did a 3-stage ring (2 blocks an SM)

template <int D, bool I8>
__global__ void __launch_bounds__(kRagWarps * 32, 3) flash_ragged_kernel(
    const __nv_bfloat16* __restrict__ q,                          // [B, C, H, D]
    const void* __restrict__ kwin, const void* __restrict__ vwin,  // [NS, NKV, T, D]
    const float* __restrict__ kwin_s, const float* __restrict__ vwin_s,  // [NS, NKV, T]
    const int* __restrict__ slots, const int* __restrict__ offsets,      // [B]
    const __nv_bfloat16* __restrict__ kn, const __nv_bfloat16* __restrict__ vn,  // [B, C, NKV, D]
    const int8_t* __restrict__ k8n, const float* __restrict__ kn_s,      // [B, C, NKV, (D)]
    const int8_t* __restrict__ v8n, const float* __restrict__ vn_s,
    __nv_bfloat16* __restrict__ o,                                // [B, C, H, D]
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int H, int NKV, int C, int T_len, int n_slots, int n_pieces, int piece_len, float scale) {
  using namespace chunk_attn;
  constexpr int NW = kRagWarps;
  constexpr int kRows = NW * 16;
  constexpr long long kElem = I8 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Segment seg[2];
  const int n_qt = (C + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / NKV);  // the K/V head of this query head
  const int piece = blockIdx.y;
  const int slot = slots[b];
  const int off = offsets[b];
  const int win = (slot < 0 || slot >= n_slots || off <= 0 || off >= T_len) ? 0 : off;
  const int nw = win > 0 ? (win + piece_len - 1) / piece_len : 1;  // this row's pieces
  if (piece >= nw) return;  // past the row's window: the whole block leaves
  const bool with_win = win > 0;
  const bool with_chunk = piece == nw - 1;
  const long long n_ss = (long long)NKV * D;  // the chunk's K/V: one position
  const long long chunk_head = (long long)b * C * n_ss + (long long)hk * D;
  if (threadIdx.x == 0) {
    int ns = 0;
    if (with_win) {
      const int k0 = piece * piece_len;
      const long long at = ((long long)slot * NKV + hk) * T_len + k0;  // in positions
      Segment w;
      w.k = static_cast<const unsigned char*>(kwin) + at * D * kElem;
      w.v = static_cast<const unsigned char*>(vwin) + at * D * kElem;
      w.k_sw = w.v_sw = D * kElem;
      w.ks = I8 ? kwin_s + at : nullptr;
      w.vs = I8 ? vwin_s + at : nullptr;
      w.ks_sw = w.vs_sw = 1;
      w.mask = nullptr;
      w.n_keys = min(piece_len, win - k0);
      w.vec16 = 1;
      w.chunk = 0;
      seg[ns++] = w;
    }
    if (with_chunk) {
      Segment ch;
      ch.k = I8 ? reinterpret_cast<const unsigned char*>(k8n + chunk_head)
                : reinterpret_cast<const unsigned char*>(kn + chunk_head);
      ch.v = I8 ? reinterpret_cast<const unsigned char*>(v8n + chunk_head)
                : reinterpret_cast<const unsigned char*>(vn + chunk_head);
      ch.k_sw = ch.v_sw = n_ss * kElem;
      ch.ks = I8 ? kn_s + (long long)b * C * NKV + hk : nullptr;
      ch.vs = I8 ? vn_s + (long long)b * C * NKV + hk : nullptr;
      ch.ks_sw = ch.vs_sw = NKV;
      ch.mask = nullptr;
      ch.n_keys = C;
      ch.vec16 = 1;
      ch.chunk = 1;
      seg[ns++] = ch;
    }
  }
  __syncthreads();
  const long long q_ss = (long long)H * D;  // q and o: one chunk position
  const long long row_at = ((long long)b * C + q0) * q_ss + (long long)h * D;
  const Rows rw{q + row_at, q_ss, min(kRows, C - q0), q0, 1, kn + chunk_head, vn + chunk_head,
                n_ss};
  float acc[D / 8][4], m[2], l[2];
  attend<D, I8, false, NW, kRagStages>(seg, (with_win ? 1 : 0) + (with_chunk ? 1 : 0), rw, 1,
                                       scale * kLog2e, smem_raw, acc, m, l);
  if (nw == 1) {
    finish<D, NW>(acc, m, l, 1, rw.n_rows, smem_raw, o + row_at, nullptr, q_ss, nullptr, nullptr);
  } else {
    const long long prow = ((long long)bh * n_pieces + piece) * C + q0;
    finish<D, NW>(acc, m, l, 1, rw.n_rows, smem_raw, nullptr, nullptr, 0, part_acc + prow * D,
                  part_ml + prow * 2);
  }
}

// Joins the pieces of every row split over more than one: 32 query rows
// of one (packed row, head) a block, 8 threads a row; rows of one piece
// were written by their block, and a block of such rows leaves at once.
template <int D>
__global__ void __launch_bounds__(256) flash_ragged_kernel_merge(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ slots, const int* __restrict__ offsets,
    __nv_bfloat16* __restrict__ o, int H, int C, int T_len, int n_slots, int n_pieces,
    int piece_len) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int slot = slots[b];
  const int off = offsets[b];
  const int win = (slot < 0 || slot >= n_slots || off <= 0 || off >= T_len) ? 0 : off;
  const int nw = (win + piece_len - 1) / piece_len;
  const int j = blockIdx.y * 32 + threadIdx.x / 8;
  if (nw <= 1 || j >= C) return;
  chunk_attn::join_row<D, 8>(part_acc, part_ml, (long long)bh * n_pieces * C + j, C, nw,
                             threadIdx.x % 8, o + (((long long)b * C + j) * H + (bh - b * H)) * D);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q; long long qs[3];
  const void* k; long long ks[3];
  const void* v; long long vs[3];
  const float* bias; long long bias_sb;
  void* o; long long os[3];
  float* lse;
  int B, H, S, T_len, kv_len, q_offset, group;
  float scale;
};

template <int D, bool CAUSAL>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr int bytes = MmaLayout<D>::kBytes;
  auto kernel = flash_attention_kernel_bf16<D, CAUSAL>;
  if (bytes > kSmemNoOptIn) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.S + kBQ - 1) / kBQ));
  kernel<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), a.qs[0], a.qs[1], a.qs[2],
      static_cast<const T*>(a.k), a.ks[0], a.ks[1], a.ks[2],
      static_cast<const T*>(a.v), a.vs[0], a.vs[1], a.vs[2],
      a.bias, a.bias_sb, static_cast<T*>(a.o), a.os[0], a.os[1], a.os[2], a.lse,
      a.H, a.S, a.T_len, a.kv_len, a.q_offset, a.group, a.scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.S + kBQ - 1) / kBQ));
  flash_attention_kernel_f32<D, CAUSAL><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(a.q), a.qs[0], a.qs[1], a.qs[2],
      static_cast<const float*>(a.k), a.ks[0], a.ks[1], a.ks[2],
      static_cast<const float*>(a.v), a.vs[0], a.vs[1], a.vs[2],
      a.bias, a.bias_sb, static_cast<float*>(a.o), a.os[0], a.os[1], a.os[2], a.lse,
      a.H, a.S, a.T_len, a.kv_len, a.q_offset, a.group, a.scale);
  return cudaGetLastError();
}

template <bool BF16, bool CAUSAL>
cudaError_t by_dim(int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 16: return BF16 ? launch_bf16<16, CAUSAL>(a, st) : launch_f32<16, CAUSAL>(a, st);
    case 32: return BF16 ? launch_bf16<32, CAUSAL>(a, st) : launch_f32<32, CAUSAL>(a, st);
    case 64: return BF16 ? launch_bf16<64, CAUSAL>(a, st) : launch_f32<64, CAUSAL>(a, st);
    case 128: return BF16 ? launch_bf16<128, CAUSAL>(a, st) : launch_f32<128, CAUSAL>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

struct RagArgs {
  const void *q, *kwin, *vwin;
  const float *kwin_s, *vwin_s;
  const int *slots, *offsets;
  const void *kn, *vn, *k8n;
  const float* kn_s;
  const void* v8n;
  const float* vn_s;
  void* o;
  float* part;
  int B, H, NKV, C, T_len, n_slots, n_pieces, piece_len;
  float scale;
};

template <int D, bool I8>
cudaError_t launch_ragged(const RagArgs& a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr int NW = kRagWarps;
  constexpr int bytes = chunk_attn::Layout<D, I8, kRagStages>::template bytes<NW>();
  auto kernel = flash_ragged_kernel<D, I8>;
  cudaError_t err = chunk_attn::prefer_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.C + NW * 16 - 1) / (NW * 16);
  float* part_acc = a.n_pieces > 1 ? a.part : nullptr;
  float* part_ml =
      part_acc ? part_acc + (long long)a.B * a.H * a.n_pieces * a.C * D : nullptr;
  const dim3 grid((unsigned)((long long)a.B * a.H * n_qt), (unsigned)a.n_pieces);
  kernel<<<grid, NW * 32, bytes, stream>>>(
      static_cast<const T*>(a.q), a.kwin, a.vwin, a.kwin_s, a.vwin_s, a.slots, a.offsets,
      static_cast<const T*>(a.kn), static_cast<const T*>(a.vn),
      static_cast<const int8_t*>(a.k8n), a.kn_s, static_cast<const int8_t*>(a.v8n), a.vn_s,
      static_cast<T*>(a.o), part_acc, part_ml, a.H, a.NKV, a.C, a.T_len, a.n_slots, a.n_pieces,
      a.piece_len, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_pieces == 1) return err;
  flash_ragged_kernel_merge<D><<<dim3((unsigned)(a.B * a.H), (a.C + 31) / 32), 256, 0, stream>>>(
      part_acc, part_ml, a.slots, a.offsets, static_cast<T*>(a.o), a.H, a.C, a.T_len,
      a.n_slots, a.n_pieces, a.piece_len);
  return cudaGetLastError();
}

// Blocks of the ragged kernel an SM holds (the occupancy API, after the
// kernel's shared-memory attributes are set), or -1.
template <bool I8>
int ragged_occupancy() {
  constexpr int bytes = chunk_attn::Layout<128, I8, kRagStages>::template bytes<kRagWarps>();
  auto kernel = flash_ragged_kernel<128, I8>;
  int n = -1;
  if (chunk_attn::prefer_shared(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kRagWarps * 32, bytes) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}


}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// kernel).  Strides are in elements, ordered (batch, head, position); the
// last axis of q, k, v and o is dense, and for bf16 the bases and strides
// of q, k, v and o are 16-byte aligned (the wrapper checks q, k and v, and
// allocates o).  bias may be null.  q and o have H heads, k and v H /
// group; query row i sits at key position q_offset + i.  lse, when not
// null, is a contiguous f32 [B, H, S] that receives each row's
// log-sum-exp of its scaled scores (-inf for a row with no visible key);
// null leaves the kernels as they were.  Returns the launch's
// cudaError_t; nothing is synchronised.
extern "C" int flash_attention_launch(
    int dtype, int D, int causal,
    const void* q, long long q_sb, long long q_sh, long long q_ss,
    const void* k, long long k_sb, long long k_sh, long long k_st,
    const void* v, long long v_sb, long long v_sh, long long v_st,
    const float* bias, long long bias_sb,
    void* o, long long o_sb, long long o_sh, long long o_ss, float* lse,
    int B, int H, int S, int T_len, int kv_len, int q_offset, int group, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T_len <= 0 || group <= 0 || H % group != 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL || (S + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidValue;
  const Args a{q, {q_sb, q_sh, q_ss}, k, {k_sb, k_sh, k_st}, v, {v_sb, v_sh, v_st},
               bias, bias_sb, o, {o_sb, o_sh, o_ss}, lse, B, H, S, T_len, kv_len, q_offset,
               group, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return causal ? (int)by_dim<false, true>(D, a, st) : (int)by_dim<false, false>(D, a, st);
  }
  if (dtype == 1) {
    return causal ? (int)by_dim<true, true>(D, a, st) : (int)by_dim<true, false>(D, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The ragged instance (packed prefill).  Every array is contiguous, rows
// 16-byte aligned (the wrapper checks): q and o [B, C, H, D] bf16; the
// cache layer k/v [NS, NKV, T, D], int8 with f32 scales [NS, NKV, T]
// (cache_int8 = 1) or bf16 with null scales; slots and offsets [B] int32
// on the device; the chunk's exact k/v [B, C, NKV, D] bf16 and, int8 only,
// its round-trip codes [B, C, NKV, D] int8 with scales [B, C, NKV].
// H % NKV == 0, D in {64, 128}.  The plan: 64 query rows a block, windows
// cut into pieces of `piece_len` keys (a
// multiple of 64), `n_pieces` >= ceil((T - 1) / piece_len) of them a row
// (>= 1); with n_pieces > 1, `part` holds B * H * n_pieces * C * (D + 2)
// floats.  Returns the first launch error; nothing is synchronised.
extern "C" int flash_ragged_launch(
    int cache_int8, int D,
    const void* q, const void* kwin, const void* vwin,
    const float* kwin_s, const float* vwin_s,
    const int* slots, const int* offsets,
    const void* kn, const void* vn,
    const void* k8n, const float* kn_s, const void* v8n, const float* vn_s,
    void* o, void* part, int B, int H, int NKV, int C, int T_len, int n_slots, int n_pieces,
    int piece_len, float scale, void* stream) {
  if (B <= 0 || H <= 0 || NKV <= 0 || C <= 0 || T_len <= 0 || n_slots <= 0 || H % NKV != 0 ||
      piece_len <= 0 || piece_len % chunk_attn::kBK != 0 ||
      n_pieces < 1 || n_pieces > 65535 || (long long)n_pieces * piece_len < T_len - 1 ||
      (n_pieces > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * ((C + kRagWarps * 16 - 1) / (kRagWarps * 16)) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (cache_int8 && (!kwin_s || !vwin_s || !k8n || !kn_s || !v8n || !vn_s))
    return (int)cudaErrorInvalidValue;
  const RagArgs a{q, kwin, vwin, kwin_s, vwin_s, slots, offsets, kn, vn, k8n, kn_s, v8n, vn_s,
                  o, static_cast<float*>(part), B, H, NKV, C, T_len, n_slots, n_pieces,
                  piece_len, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (cache_int8 ? 1 : 0)) {
    case 128: return (int)launch_ragged<64, false>(a, st);
    case 129: return (int)launch_ragged<64, true>(a, st);
    case 256: return (int)launch_ragged<128, false>(a, st);
    case 257: return (int)launch_ragged<128, true>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks an SM holds of the ragged kernel at D = 128 on an int8
// (cache_int8 = 1) or bf16 cache.
extern "C" int flash_ragged_occupancy(int cache_int8) {
  return cache_int8 ? ragged_occupancy<true>() : ragged_occupancy<false>();
}

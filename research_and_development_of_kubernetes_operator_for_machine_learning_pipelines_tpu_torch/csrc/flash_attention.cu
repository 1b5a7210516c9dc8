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
// `prefill_chunks_ragged` at the prefill chunk).  One block of 4 warps per
// (packed row b * head, 64-row query tile), the MMA core of the bf16 kernel
// above; keys stream in two phases through one softmax:
//
//   1. the window: keys 0 .. offsets[b] - 1 of cache row slots[b]
//      ([NS, NKV, T, D], head-major), both read from device memory by the
//      block, so the host never syncs; a row whose offset is at capacity
//      (a parked pad row) or whose slot is out of range reads none;
//   2. the chunk ([B, C, NKV, D]): keys up to the query tile's diagonal,
//      causal.
//
// I8 (the int8 cache): the window and the chunk below the diagonal are
// int8 codes with one f32 scale a (position, head).  Codes are exact in
// bf16, so a tile is staged by 16-byte loads, converted in registers (the
// PRMT-into-2^23 trick of dmajor_attention.cu, no quarter-rate I2F) and
// stored as bf16: Q . K and P . V stay bf16 tensor-core products.  The key
// scale multiplies the score, the value scale the probability before it is
// rounded to bf16 (the reference's order).  The diagonal is exact: each
// row's q_j . k_j is a CUDA-core dot (f32) taken once before the tile
// loop and put in place of the code score in the last (diagonal) tile,
// where the diagonal's probability is kept out of the MMA and
// p_jj * v_j is added in f32 from the exact V row.  Under the causal
// mask that tile is a query tile's last, so no rescale follows.  !I8 (the
// bf16 cache): bf16 tiles copied as they are, every chunk key exact.
//
// Bound on the H100 (Llama-2-7B, B_p = 4, C = 256, offsets 0/256/768/3840,
// H = NKV = 32, D = 128, int8): ~83 MB of inputs and output, ~0.025 ms at
// 3.35 TB/s, against ~22.6 GFLOP of products, ~0.023 ms at 989 TFLOP/s:
// the bytes.  What holds this first version back: tiles are staged
// synchronously (no copy overlaps the block's own MMA; the other blocks of
// the SM hide part of it), each query tile of a (row, head) reads its
// window again (the second from L2), and a long row's blocks run 60 window
// tiles while a short one's run 1-4 (no split over the window).
constexpr int kRagThreads = 128;  // 4 warps x 16 query rows
constexpr int kRagBK = 64;        // keys per tile

template <int D>
struct RagLayout {
  static constexpr int kLd = D + 8;           // bf16 per padded shared row
  static constexpr int kTile = kRagBK * kLd;  // one Q, K or V tile
  // Q, K and V in bf16, then the tile's key and value scales and the
  // query rows' exact diagonal scores in f32.
  static constexpr int kBytes = 3 * kTile * 2 + 3 * kRagBK * 4;
};

// 16 int8 codes -> 16 bf16 at dst (exact: |code| <= 127).
__device__ __forceinline__ void codes16_to_bf16(const uint4 w, __nv_bfloat16* dst) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u = words[i] ^ 0x80808080u;
    float f[4];
    f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
    f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
    f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
    f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    out[2 * i] = *reinterpret_cast<const uint32_t*>(&lo);
    out[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(out[0], out[1], out[2], out[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

template <int D, bool I8>
__global__ void __launch_bounds__(kRagThreads, D <= 64 ? 4 : 2) flash_ragged_kernel(
    const __nv_bfloat16* __restrict__ q,                          // [B, C, H, D]
    const void* __restrict__ kwin, const void* __restrict__ vwin,  // [NS, NKV, T, D]
    const float* __restrict__ kwin_s, const float* __restrict__ vwin_s,  // [NS, NKV, T]
    const int* __restrict__ slots, const int* __restrict__ offsets,      // [B]
    const __nv_bfloat16* __restrict__ kn, const __nv_bfloat16* __restrict__ vn,  // [B, C, NKV, D]
    const int8_t* __restrict__ k8n, const float* __restrict__ kn_s,      // [B, C, NKV, (D)]
    const int8_t* __restrict__ v8n, const float* __restrict__ vn_s,
    __nv_bfloat16* __restrict__ o,                                // [B, C, H, D]
    int H, int NKV, int C, int T_len, int n_slots, float scale) {
  using L = RagLayout<D>;
  constexpr int LD = L::kLd;
  constexpr int CPR = D / 8;      // 16-byte chunks of a bf16 row
  constexpr int CPR8 = D / 16;    // 16-byte chunks of an int8 row
  constexpr int KS = D / 16;      // k-steps of Q . K^T
  constexpr int DN = D / 8;       // n8 tiles of the output
  constexpr int NT = kRagBK / 8;  // n8 tiles of a key tile
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + L::kTile;
  __nv_bfloat16* sv = sk + L::kTile;
  float* sks = reinterpret_cast<float*>(sv + L::kTile);  // the tile's key scales
  float* svs = sks + kRagBK;                             // and value scales
  float* sdiag = svs + kRagBK;                           // q_j . k_j of each query row

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / NKV);  // the K/V head of this query head
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int slot = slots[b];
  const int off = offsets[b];
  const int win = (slot < 0 || slot >= n_slots || off <= 0 || off >= T_len) ? 0 : off;
  const int n_win = (win + kRagBK - 1) / kRagBK;
  const int chunk_end = C < q0 + kBQ ? C : q0 + kBQ;  // keys past the tile's last query
  const int n_tiles = n_win + (chunk_end + kRagBK - 1) / kRagBK;  // the last holds the diagonal
  const long long q_ss = (long long)H * D;  // q and o: one chunk position
  const long long n_ss = (long long)NKV * D;  // the chunk's K/V: one position

  const __nv_bfloat16* qbase = q + (long long)b * C * q_ss + (long long)h * D;
  for (int idx = tid; idx < kBQ * CPR; idx += kRagThreads) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * 8;
    const bool ok = q0 + r < C;
    cp_async16(sq + r * LD + c, ok ? qbase + (long long)(q0 + r) * q_ss + c : qbase, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int row0 = warp * 16 + lane / 4;  // this lane's rows: row0 and row0 + 8
  const int qi0 = q0 + row0;              // row0's chunk position
  const int col = 2 * (lane % 4);
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    ldmatrix_x4(qf[ks], sq + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                            ks * 16 + (lane / 16) * 8);
  }
  const long long chunk_head = (long long)b * C * n_ss + (long long)hk * D;
  if (I8) {
    // Each row's exact diagonal score, two threads a row.
    const int r = tid / 2;
    const int half = (tid % 2) * (D / 2);
    float dot = 0.f;
    if (q0 + r < C) {
      const __nv_bfloat16* kr = kn + chunk_head + (long long)(q0 + r) * n_ss + half;
      const __nv_bfloat16* qr = sq + r * LD + half;
#pragma unroll 8
      for (int e = 0; e < D / 2; e += 2) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + e));
        const float2 kk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr + e));
        dot = fmaf(a.x, kk.x, dot);
        dot = fmaf(a.y, kk.y, dot);
      }
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (tid % 2 == 0) sdiag[r] = dot;
  }

  constexpr float kLog2e = 1.4426950408889634f;
  const float sl = scale * kLog2e;
  float oacc[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums
  const long long win_head = ((long long)slot * NKV + hk) * T_len;  // in positions

  for (int t = 0; t < n_tiles; ++t) {
    const bool in_win = t < n_win;
    const int k0 = (in_win ? t : t - n_win) * kRagBK;
    const int k_lim = in_win ? win : chunk_end;  // keys at or past it take no part
    __syncthreads();  // the previous tile (and the diagonal scores) are done
    if (I8) {
      const int8_t* kb = in_win ? static_cast<const int8_t*>(kwin) : k8n;
      const int8_t* vb = in_win ? static_cast<const int8_t*>(vwin) : v8n;
      for (int idx = tid; idx < kRagBK * CPR8; idx += kRagThreads) {
        const int r = idx / CPR8;
        const int c = (idx % CPR8) * 16;
        const int key = k0 + r;
        uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
        if (key < k_lim) {
          const long long at = in_win ? (win_head + key) * D + c
                                      : chunk_head + (long long)key * n_ss + c;
          kw = __ldg(reinterpret_cast<const uint4*>(kb + at));
          vw = __ldg(reinterpret_cast<const uint4*>(vb + at));
        }
        codes16_to_bf16(kw, sk + r * LD + c);
        codes16_to_bf16(vw, sv + r * LD + c);
      }
      if (tid < kRagBK) {
        const int key = k0 + tid;
        float ksv = 0.f, vsv = 0.f;
        if (key < k_lim) {
          const long long at = in_win ? win_head + key
                                      : ((long long)b * C + key) * NKV + hk;
          ksv = in_win ? kwin_s[at] : kn_s[at];
          vsv = in_win ? vwin_s[at] : vn_s[at];
        }
        sks[tid] = ksv;
        svs[tid] = vsv;
      }
    } else {
      const __nv_bfloat16* kb = in_win ? static_cast<const __nv_bfloat16*>(kwin) : kn;
      const __nv_bfloat16* vb = in_win ? static_cast<const __nv_bfloat16*>(vwin) : vn;
      for (int idx = tid; idx < kRagBK * CPR; idx += kRagThreads) {
        const int r = idx / CPR;
        const int c = (idx % CPR) * 8;
        const int key = k0 + r;
        uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
        if (key < k_lim) {
          const long long at = in_win ? (win_head + key) * D + c
                                      : chunk_head + (long long)key * n_ss + c;
          kw = __ldg(reinterpret_cast<const uint4*>(kb + at));
          vw = __ldg(reinterpret_cast<const uint4*>(vb + at));
        }
        *reinterpret_cast<uint4*>(sk + r * LD + c) = kw;
        *reinterpret_cast<uint4*>(sv + r * LD + c) = vw;
      }
    }
    __syncthreads();

    // S = Q . K^T over the 64 keys: 8 n8 tiles of f32 accumulators.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, sk + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + ks * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // Scale (times the key scale), the exact diagonal, the masks.
    const bool diag_tile = I8 && t == n_tiles - 1;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + col + (e & 1);
        const int key = k0 + kl;
        const int qi = qi0 + (e >> 1) * 8;
        float x = s[j][e] * sl;
        if (I8) x *= sks[kl];
        if (diag_tile && key == qi) x = sdiag[qi - q0] * sl;
        const bool ok = key < k_lim && (in_win || key <= qi);
        x = ok ? x : -INFINITY;
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

    // P (times the value scale) in bf16 as the A fragments of P . V; the
    // row sums take the f32 probabilities, the diagonal's kept apart.
    uint32_t pf[NT / 2][4];
    float pd[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + col + (e & 1);
        const float p = exp2f(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        pv[e] = I8 ? p * svs[kl] : p;
        if (diag_tile && k0 + kl == qi0 + (e >> 1) * 8) {
          pd[e >> 1] = p;
          pv[e] = 0.f;
        }
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(pv[0], pv[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(pv[2], pv[3]);
      pf[j / 2][(j % 2) * 2] = *reinterpret_cast<const uint32_t*>(&lo);
      pf[j / 2][(j % 2) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
    }

    // O += P . V: V's rows are keys, so ldmatrix.trans gives the col-major B.
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sv + (kt * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(oacc[2 * dp], pf[kt], vb[0], vb[1]);
        mma_bf16(oacc[2 * dp + 1], pf[kt], vb[2], vb[3]);
      }
    }

    if (diag_tile) {
      // p_jj * v_j from the exact V row: one lane of the quad holds p_jj.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 1);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 2);
        const int qi = qi0 + r * 8;
        if (qi < C) {
          const __nv_bfloat16* vr = vn + chunk_head + (long long)qi * n_ss + col;
#pragma unroll
          for (int i = 0; i < DN; ++i) {
            const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vr + i * 8));
            oacc[i][2 * r] = fmaf(pd[r], vv.x, oacc[i][2 * r]);
            oacc[i][2 * r + 1] = fmaf(pd[r], vv.y, oacc[i][2 * r + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // l >= 1: the key that set the final max has p = 1 (every row has a key).
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  // This warp's 16 rows go out through its own rows of the Q tile (the
  // diagonal scores read a thread's own warp's rows, before the tile loop).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < DN; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(sq + (row0 + r * 8) * LD + i * 8 + col) =
          __floats2bfloat162_rn(oacc[i][2 * r] * inv[r], oacc[i][2 * r + 1] * inv[r]);
    }
  }
  __syncwarp();
  __nv_bfloat16* obase = o + (long long)b * C * q_ss + (long long)h * D;
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int r = warp * 16 + idx / CPR;
    const int c = (idx % CPR) * 8;
    if (q0 + r < C) {
      *reinterpret_cast<uint4*>(obase + (long long)(q0 + r) * q_ss + c) =
          *reinterpret_cast<const uint4*>(sq + r * LD + c);
    }
  }
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
      a.bias, a.bias_sb, static_cast<T*>(a.o), a.os[0], a.os[1], a.os[2],
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
      a.bias, a.bias_sb, static_cast<float*>(a.o), a.os[0], a.os[1], a.os[2],
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
  int B, H, NKV, C, T_len, n_slots;
  float scale;
};

template <int D, bool I8>
cudaError_t launch_ragged(const RagArgs& a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  constexpr int bytes = RagLayout<D>::kBytes;
  auto kernel = flash_ragged_kernel<D, I8>;
  if (bytes > kSmemNoOptIn) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.C + kBQ - 1) / kBQ));
  kernel<<<grid, kRagThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), a.kwin, a.vwin, a.kwin_s, a.vwin_s, a.slots, a.offsets,
      static_cast<const T*>(a.kn), static_cast<const T*>(a.vn),
      static_cast<const int8_t*>(a.k8n), a.kn_s, static_cast<const int8_t*>(a.v8n), a.vn_s,
      static_cast<T*>(a.o), a.H, a.NKV, a.C, a.T_len, a.n_slots, a.scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// kernel).  Strides are in elements, ordered (batch, head, position); the
// last axis of q, k, v and o is dense, and for bf16 the bases and strides
// of q, k, v and o are 16-byte aligned (the wrapper checks q, k and v, and
// allocates o).  bias may be null.  q and o have H heads, k and v H /
// group; query row i sits at key position q_offset + i.  Returns the
// launch's cudaError_t; nothing is synchronised.
extern "C" int flash_attention_launch(
    int dtype, int D, int causal,
    const void* q, long long q_sb, long long q_sh, long long q_ss,
    const void* k, long long k_sb, long long k_sh, long long k_st,
    const void* v, long long v_sb, long long v_sh, long long v_st,
    const float* bias, long long bias_sb,
    void* o, long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int S, int T_len, int kv_len, int q_offset, int group, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T_len <= 0 || group <= 0 || H % group != 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL || (S + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidValue;
  const Args a{q, {q_sb, q_sh, q_ss}, k, {k_sb, k_sh, k_st}, v, {v_sb, v_sh, v_st},
               bias, bias_sb, o, {o_sb, o_sh, o_ss}, B, H, S, T_len, kv_len, q_offset, group,
               scale};
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
// H % NKV == 0, D in {64, 128}.  Returns the launch's cudaError_t; nothing
// is synchronised.
extern "C" int flash_ragged_launch(
    int cache_int8, int D,
    const void* q, const void* kwin, const void* vwin,
    const float* kwin_s, const float* vwin_s,
    const int* slots, const int* offsets,
    const void* kn, const void* vn,
    const void* k8n, const float* kn_s, const void* v8n, const float* vn_s,
    void* o, int B, int H, int NKV, int C, int T_len, int n_slots, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || NKV <= 0 || C <= 0 || T_len <= 0 || n_slots <= 0 || H % NKV != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 0x7fffffffLL || (C + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (cache_int8 && (!kwin_s || !vwin_s || !k8n || !kn_s || !v8n || !vn_s))
    return (int)cudaErrorInvalidValue;
  const RagArgs a{q, kwin, vwin, kwin_s, vwin_s, slots, offsets, kn, vn, k8n, kn_s, v8n, vn_s,
                  o, B, H, NKV, C, T_len, n_slots, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (cache_int8 ? 1 : 0)) {
    case 128: return (int)launch_ragged<64, false>(a, st);
    case 129: return (int)launch_ragged<64, true>(a, st);
    case 256: return (int)launch_ragged<128, false>(a, st);
    case 257: return (int)launch_ragged<128, true>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The sampled decode step around the sort: a prep kernel and a draw kernel.
//
// Not a Pallas port: the JAX package samples in XLA (``models/sampling.py``
// ``sample_chain_step``: split the row key, scale by the temperature,
// ``jnp.argsort(-scaled)``, the top-k and top-p masks in sorted order, then
// ``jax.random.categorical``).  A sampled step on the card is three calls:
//
//   sample_prep_kernel   logits [B, V] as the decode hands them (f32 or bf16)
//       neg[b, n] = -fl(logit / max(T_b, 1e-6))    (IEEE division, exact sign flip)
//       a block's greedy partial: the largest logit, NaN first, lowest index
//       a block's softmax partial: m = max of its scaled values (NaN first),
//                                  z = sum of exp(scaled - m)
//       block 0 of a row: the key split, carry -> out, use -> scratch;
//       every block zeroes its chunk's flag of the draw (block 0 the tickets)
//   torch.sort(neg, stable) ascending, the reference's argsort of -scaled
//       (NaN last, ties in their original order)
//   sample_draw_kernel   over the sorted row, s = -sorted
//       M, Z        the row's max and softmax sum, from the prep partials
//       mass[r]     (exclusive prefix of exp(s - M) in sorted order) / Z
//       keep[r]     r < k_eff and mass[r] < clip(p, 0, 1)
//       score[r]    kept: s[r] + gumbel(threefry(use, (0, r)));
//                   masked: -1e30 with no hash (-1e30 + g == -1e30 in f32 for
//                   every Gumbel of this uniform, |g| < 16 against a spacing
//                   of 7.6e22 at 1e30)
//       choice      argmax of score, NaN first, lowest index
//       token       T > 0 ? order[choice] : the greedy token
//
// which is ``models/sampling``'s plain chain (``ops/sample_step.py``) with the
// sums taken in another order: the softmax sum and the exclusive mass are
// f32 sums over up to V terms, so a keep decision can differ from the plain
// version's only where the plain mass lies within a few f32 roundings of p.
// The scaled values, the greedy token, the top-k mask and the carry key are
// exact; the Gumbel of a kept rank is the device's logf of a bit-equal
// uniform, within an ulp or two of the CPU's.
//
// What bounds it on the H100.  Bytes: the logits read and the negated scaled
// values written (prep), the sorted chunks the draw needs read back, one
// order element a row.  Exponentials: V a row in prep, and one a rank the
// draw examines.  Integer operations: 74 a KEPT rank (the counter's add, 20
// threefry rounds of add / rotate / xor, five two-add key injections, the
// uniform's xor / shift / or) plus the row's two key splits.  With the
// smoke's filter (T 0.8, top-k 40-50, top-p 0.95) a row keeps some 50 of its
// 32000 ranks, so hashing every counter, as a draw over the masked row would,
// is gone and the step is two launches' fixed cost and the prep pass's bytes.
//
// The design.  Both kernels cut a row into chunks of CHUNK positions, a block
// a (chunk, row).  Prep reads its chunk striped (coalesced), writes the
// negated scaled values and one partial (greedy value, greedy index, m, z).
// The draw takes its chunk index from a per-row start ticket, so a block only
// ever waits on blocks that already run; a block whose chunk starts at or past
// k_eff (or of a greedy row) does no work but its partial.  A working block
// stages its chunk in shared memory, exponentiates, scans the chunk (a
// thread's four ranks in order, a warp's Hillis-Steele scan, the warps in
// order), publishes the chunk's sum as a flagged 64-bit word, sums its
// predecessors' published sums (one warp, each lane its own subset in order,
// then a shuffle tree), then decides each rank and hashes the kept ones, four
// chains a thread in flight when all four of its ranks are kept.  Each block
// writes its best (score, rank) (the first masked rank at -1e30 included);
// the last block of the row to finish (a finish ticket) reduces them and the
// greedy partials, writes the token and zeroes the row's tickets and flags
// again.  The tickets and flags are scratch of the step that its prep kernel
// zeroes, so steps on different streams share nothing, and a draw launched
// again on the same scratch finds it zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;                // positions a thread
constexpr int CHUNK = THREADS * ITEMS;  // positions a block, in both kernels
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr float TINY = 1.17549435e-38f;  // the smallest normal f32
constexpr float MASKED = -1e30f;         // the reference's _NEG_INF
constexpr int NONE = 0x7fffffff;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

#define TF_MIX(r) \
  a += b;         \
  b = rotl(b, r) ^ a;
#define TF_EVEN TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
#define TF_ODD TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)

// Threefry-2x32, 20 rounds (``models/prng.threefry2x32``).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                             uint32_t x1, uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  uint32_t a = x0 + k0, b = x1 + k1;
  TF_EVEN a += k1; b += k2 + 1u;
  TF_ODD  a += k2; b += k0 + 2u;
  TF_EVEN a += k0; b += k1 + 3u;
  TF_ODD  a += k1; b += k2 + 4u;
  TF_EVEN a += k2; b += k0 + 5u;
  o0 = a;
  o1 = b;
}

// ``prng.gumbel`` of one word of random bits.
__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, 1.0f), TINY), TINY);
  return -logf(-logf(u));
}

// (v, i) beats (bv, bi): NaN first, then the larger value, then the lower
// index (torch.argmax's and jnp.argmax's rule).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// The larger of two values, NaN first (torch.max's rule).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(FULL, v, off);
    const int oi = __shfl_down_sync(FULL, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// A warp's sum, lane i adding lane i + off for off = 16, 8, 4, 2, 1: the
// total in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// One block a (chunk, row): the negated scaled values of the chunk, and the
// chunk's partial (greedy value, greedy index as bits, m, z).
template <typename T>
__global__ void __launch_bounds__(THREADS)
sample_prep_kernel(const T* __restrict__ logits, long long row_stride, int V,
                   const float* __restrict__ temp, long long temp_stride,
                   const long long* __restrict__ keys, long long key_row, long long key_col,
                   float* __restrict__ neg, float4* __restrict__ part,
                   uint32_t* __restrict__ use, long long* __restrict__ carry,
                   unsigned long long* __restrict__ flags, unsigned* __restrict__ tickets) {
  const int s = blockIdx.x, row = blockIdx.y, splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float t0 = temp[row * temp_stride];
  const float t = isnan(t0) ? t0 : fmaxf(t0, 1e-6f);  // torch.clamp(min=1e-6)
  const int lo = s * CHUNK, rem = min(CHUNK, V - lo);
  const T* x = logits + row * row_stride + lo;
  float* y = neg + (long long)row * V + lo;
  float sv[ITEMS];
  float gv = -INFINITY, m = -INFINITY;
  int gi = NONE;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int o = j * THREADS + tid;
    if (o < rem) {
      const float v = to_f32(x[o]);
      if (better(v, lo + o, gv, gi)) {
        gv = v;
        gi = lo + o;
      }
      sv[j] = __fdiv_rn(v, t);
      y[o] = -sv[j];
      m = nanmax(m, sv[j]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nanmax(m, __shfl_xor_sync(FULL, m, off));
  warp_best(gv, gi);
  __shared__ float sm[WARPS], sz[WARPS], sgv[WARPS];
  __shared__ int sgi[WARPS];
  if (lane == 0) {
    sm[warp] = m;
    sgv[warp] = gv;
    sgi[warp] = gi;
  }
  __syncthreads();
  float mb = sm[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mb = nanmax(mb, sm[w]);
  float z = 0.0f;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (j * THREADS + tid < rem) z = __fadd_rn(z, expf(__fsub_rn(sv[j], mb)));
  z = warp_sum(z);
  if (lane == 0) sz[warp] = z;
  __syncthreads();
  if (tid == 0) {
    float zb = sz[0], bv = sgv[0];
    int bi = sgi[0];
    for (int w = 1; w < WARPS; ++w) {
      zb = __fadd_rn(zb, sz[w]);
      if (better(sgv[w], sgi[w], bv, bi)) {
        bv = sgv[w];
        bi = sgi[w];
      }
    }
    part[(long long)row * splits + s] = make_float4(bv, __int_as_float(bi), mb, zb);
    flags[(long long)row * splits + s] = 0ull;
    if (s == 0) {  // the row's key split, once: threefry(key, (0, 0)) and (0, 1)
      tickets[2 * row] = 0u;
      tickets[2 * row + 1] = 0u;
      const uint32_t k0 = (uint32_t)keys[row * key_row], k1 = (uint32_t)keys[row * key_row + key_col];
      uint32_t c0, c1, u0, u1;
      threefry2x32(k0, k1, 0u, 0u, c0, c1);
      threefry2x32(k0, k1, 0u, 1u, u0, u1);
      carry[2 * row] = (long long)c0;
      carry[2 * row + 1] = (long long)c1;
      use[2 * row] = u0;
      use[2 * row + 1] = u1;
    }
  }
}

// One block a (chunk, row) over the sorted row; the last block of a row to
// finish writes its token.  ``tickets[2 * row]`` hands out chunk indices,
// ``tickets[2 * row + 1]`` counts finished blocks; ``flags[row * splits +
// c]`` holds chunk c's sum of exp(s - M) with 1 in its high word once
// published.  All three are zero at entry (the prep kernel of the same
// step, or the last draw on them, zeroed them) and are left zero.
__global__ void __launch_bounds__(THREADS)
sample_draw_kernel(const float* __restrict__ sorted, const long long* __restrict__ order, int V,
                   const float* __restrict__ temp, long long temp_stride,
                   const int* __restrict__ topk, long long topk_stride,
                   const float* __restrict__ topp, long long topp_stride,
                   const float4* __restrict__ part, const uint32_t* __restrict__ use,
                   unsigned long long* flags, unsigned* tickets, float2* best,
                   int* __restrict__ tokens) {
  const int row = blockIdx.y, splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ float4 stage[THREADS];  // the chunk, ITEMS ranks a thread
  __shared__ float swt[WARPS], s_M, s_Z, s_P;
  __shared__ float sbv[WARPS];
  __shared__ int sbi[WARPS], sfm[WARPS], s_split, s_last;
  if (tid == 0) s_split = (int)atomicAdd(&tickets[2 * row], 1u);
  // The row's parameters and use key, loaded while the ticket comes back.
  const float T = temp[row * temp_stride];
  const int k = topk[row * topk_stride];
  const float p0 = topp[row * topp_stride];
  const uint32_t u0 = use[2 * row], u1 = use[2 * row + 1];
  __syncthreads();
  const int c = s_split;
  if (c >= splits) return;  // tickets that were not zero: never wait on a chunk that is not there
  const int lo = c * CHUNK, rem = min(CHUNK, V - lo);
  const int keff = k <= 0 ? V : k;
  const float p = isnan(p0) ? p0 : fminf(fmaxf(p0, 0.0f), 1.0f);  // torch.clamp(0, 1)
  const bool sampled = T > 0.0f;
  unsigned long long* rflags = flags + (long long)row * splits;

  float bv = -INFINITY;
  int bi = NONE, first_masked = NONE;
  if (sampled && lo < keff) {
    if (warp == 0) {  // the row's max and softmax sum from the prep partials
      const float4* pr = part + (long long)row * splits;
      float mx = -INFINITY;
      for (int j = lane; j < splits; j += 32) mx = nanmax(mx, pr[j].z);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = nanmax(mx, __shfl_xor_sync(FULL, mx, off));
      float z = 0.0f;
      for (int j = lane; j < splits; j += 32) {
        const float4 q = pr[j];
        if (q.z != -INFINITY) z = __fadd_rn(z, __fmul_rn(q.w, expf(__fsub_rn(q.z, mx))));
      }
      z = warp_sum(z);
      if (lane == 0) {
        s_M = mx;
        s_Z = z;
      }
    }
    const float* src = sorted + (long long)row * V + lo;
    float* st = reinterpret_cast<float*>(stage);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int o = j * THREADS + tid;
      st[o] = o < rem ? -src[o] : 0.0f;
    }
    __syncthreads();
    const float4 q4 = stage[tid];
    const float sv[ITEMS] = {q4.x, q4.y, q4.z, q4.w};
    const float M = s_M, Z = s_Z;
    const int base = tid * ITEMS;  // this thread's first rank in the chunk
    float x[ITEMS], run = 0.0f;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      x[j] = run;
      if (base + j < rem) run = __fadd_rn(run, expf(__fsub_rn(sv[j], M)));
    }
    float inc = run;  // the warp's inclusive scan of the threads' sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc = __fadd_rn(inc, o);
    }
    const float excl = __shfl_up_sync(FULL, inc, 1);
    if (lane == 31) swt[warp] = inc;
    __syncthreads();
    float wpre = 0.0f, agg = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) wpre = __fadd_rn(wpre, swt[w]);
      agg = __fadd_rn(agg, swt[w]);
    }
    if (tid == 0) {
      atomicExch(&rflags[c], (1ull << 32) | (unsigned long long)__float_as_uint(agg));
    }
    if (warp == 0) {  // the chunks before this one, as they are published
      float pre = 0.0f;
      for (int j = lane; j < c; j += 32) {
        unsigned long long f;
        do {
          f = *reinterpret_cast<volatile unsigned long long*>(&rflags[j]);
        } while ((f >> 32) == 0ull);
        pre = __fadd_rn(pre, __uint_as_float((uint32_t)f));
      }
      pre = warp_sum(pre);
      if (lane == 0) s_P = pre;
    }
    __syncthreads();
    const float P = s_P;
    const float tex = __fadd_rn(wpre, lane == 0 ? 0.0f : excl);
    bool kept[ITEMS];
    int nk = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int r = lo + base + j;
      kept[j] = false;
      if (base + j < rem) {
        const float mass = __fdiv_rn(__fadd_rn(P, __fadd_rn(tex, x[j])), Z);
        kept[j] = r < keff && mass < p;
        if (!kept[j] && first_masked == NONE) first_masked = r;
      }
      nk += kept[j];
    }
    if (nk == ITEMS) {  // four chains in flight
      uint32_t a[ITEMS], b[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) threefry2x32(u0, u1, 0u, (uint32_t)(lo + base + j), a[j], b[j]);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const float score = __fadd_rn(sv[j], gumbel_of(a[j] ^ b[j]));
        if (better(score, lo + base + j, bv, bi)) {
          bv = score;
          bi = lo + base + j;
        }
      }
    } else if (nk > 0) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (!kept[j]) continue;
        uint32_t a, b;
        threefry2x32(u0, u1, 0u, (uint32_t)(lo + base + j), a, b);
        const float score = __fadd_rn(sv[j], gumbel_of(a ^ b));
        if (better(score, lo + base + j, bv, bi)) {
          bv = score;
          bi = lo + base + j;
        }
      }
    }
  } else if (sampled) {
    first_masked = lo;  // every rank of the chunk is past k_eff
  }

  // The block's best, with its first masked rank at -1e30.
  warp_best(bv, bi);
  int fm = first_masked;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) fm = min(fm, __shfl_down_sync(FULL, fm, off));
  if (lane == 0) {
    sbv[warp] = bv;
    sbi[warp] = bi;
    sfm[warp] = fm;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w) {
      fm = min(fm, sfm[w]);
      if (better(sbv[w], sbi[w], bv, bi)) {
        bv = sbv[w];
        bi = sbi[w];
      }
    }
    if (fm != NONE && better(MASKED, fm, bv, bi)) {
      bv = MASKED;
      bi = fm;
    }
    best[(long long)row * splits + c] = make_float2(bv, __int_as_float(bi));
    __threadfence();
    s_last = atomicAdd(&tickets[2 * row + 1], 1u) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!s_last) return;

  // The last block of the row: the choice, the greedy token, the token.
  __threadfence();
  if (warp == 0) {
    float cv = -INFINITY, gv = -INFINITY;
    int ci = NONE, gi = NONE;
    for (int j = lane; j < splits; j += 32) {
      const float2 q = __ldcg(&best[(long long)row * splits + j]);
      if (better(q.x, __float_as_int(q.y), cv, ci)) {
        cv = q.x;
        ci = __float_as_int(q.y);
      }
      const float4 g = part[(long long)row * splits + j];
      if (better(g.x, __float_as_int(g.y), gv, gi)) {
        gv = g.x;
        gi = __float_as_int(g.y);
      }
    }
    warp_best(cv, ci);
    warp_best(gv, gi);
    if (lane == 0) tokens[row] = sampled ? (int)order[(long long)row * V + ci] : gi;
  }
  for (int j = tid; j < splits; j += THREADS) rflags[j] = 0ull;
  if (tid == 0) {
    tickets[2 * row] = 0u;
    tickets[2 * row + 1] = 0u;
  }
}

}  // namespace

// dtype: 0 f32 logits, 1 bf16.  part: [B, splits] float4; use: [B, 2] u32;
// flags: [B, splits] u64 and tickets: [B, 2] u32, zeroed here for the draw.
extern "C" int sample_prep_launch(const void* logits, int dtype, long long row_stride, int B,
                                  int V, int splits, const float* temp, long long temp_stride,
                                  const long long* keys, long long key_row, long long key_col,
                                  float* neg, float* part, uint32_t* use, long long* carry,
                                  unsigned long long* flags, unsigned* tickets, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(splits, B);
  float4* p4 = reinterpret_cast<float4*>(part);
  if (dtype == 0) {
    sample_prep_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(logits), row_stride, V, temp, temp_stride, keys, key_row,
        key_col, neg, p4, use, carry, flags, tickets);
  } else if (dtype == 1) {
    sample_prep_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), row_stride, V, temp, temp_stride, keys,
        key_row, key_col, neg, p4, use, carry, flags, tickets);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// best: [B, splits] float2 scratch; flags and tickets zero, as the prep
// kernel of the same step (or a draw on them) left them.
extern "C" int sample_draw_launch(const float* sorted, const long long* order, int B, int V,
                                  int splits, const float* temp, long long temp_stride,
                                  const int* topk, long long topk_stride, const float* topp,
                                  long long topp_stride, const float* part,
                                  const uint32_t* use, unsigned long long* flags,
                                  unsigned* tickets, float* best, int* tokens, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sample_draw_kernel<<<dim3(splits, B), THREADS, 0, st>>>(
      sorted, order, V, temp, temp_stride, topk, topk_stride, topp, topp_stride,
      reinterpret_cast<const float4*>(part), use, flags, tickets,
      reinterpret_cast<float2*>(best), tokens);
  return (int)cudaGetLastError();
}

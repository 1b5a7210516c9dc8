// Fused threefry-Gumbel categorical draw for the sampled decode chain.
//
// Not a Pallas port: the JAX package samples in XLA (``jax.random.split``,
// ``jax.random.categorical``).  One call of ``gumbel_argmax_launch`` does,
// for every row b of a masked logit batch [B, V] (f32):
//
//   carry, use = split(keys[b])        threefry(key, (0, 0)), (0, 1)
//   bits[n]    = a ^ b of threefry(use, (n >> 32, n & 0xFFFFFFFF))
//   u[n]       = max((bitcast((bits >> 9) | 0x3F800000) - 1) * 1 + tiny, tiny)
//   g[n]       = -log(-log(u[n]))
//   choice[b]  = argmax_n(masked[b, n] + g[n]), the lowest index among
//                equal maxima (torch.argmax's and jnp.argmax's rule; a NaN
//                is the largest value, as torch.argmax takes it)
//
// which is ``models/prng.split_keys`` + ``models/prng.categorical`` in one
// pass: the plain chain's ~300 elementwise launches over [B, V] int64
// tensors become two launches.  The uniform is formed with round-to-nearest
// intrinsics (no contraction into an FMA) and the logs are the accurate
// ``logf`` (this source builds without fast math), so u is bit-equal to the
// plain chain's and g within an ulp or two.
//
// What bounds it on the H100: integer operations.  Each element costs 74:
// the counter's add into the key, the 20 rounds of threefry (an add, a
// rotate and a xor each), the five key injections (two adds each), and the
// xor, shift and or that make the uniform's bits; its two logs are f32
// work, on other pipes than the integer lanes.  That is against one 4-byte read of the
// masked logit: at B = 32, V = 32000, ~4 MB and ~76 M integer operations.
// The design spreads the elements over enough blocks to fill the card at
// small B: a grid of (V splits) x (rows), each thread hashing a strided run
// of counters and keeping its best (value, index), a warp shuffle and a
// block reduction into one partial per split, then a merge kernel (one warp
// a row) that reduces the partials and writes the carry key.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr float TINY = 1.17549435e-38f;  // the smallest normal f32

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

// (v, i) beats (bv, bi): NaN first, then the larger value, then the
// lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
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

// One block a (split, row): the best (masked + gumbel, index) over the
// split's counters [s * chunk, min(V, (s + 1) * chunk)).
__global__ void __launch_bounds__(THREADS)
gumbel_argmax_partial_kernel(const float* __restrict__ masked, long long row_stride,
                             const long long* __restrict__ keys, int V, int chunk,
                             int splits, float* __restrict__ part_v,
                             int* __restrict__ part_i) {
  const int s = blockIdx.x, row = blockIdx.y;
  const uint32_t k0 = (uint32_t)keys[2 * row], k1 = (uint32_t)keys[2 * row + 1];
  uint32_t u0, u1;
  threefry2x32(k0, k1, 0u, 1u, u0, u1);  // the "use" half of the split
  const float* x = masked + (long long)row * row_stride;
  const int lo = s * chunk, hi = min(V, lo + chunk);
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int n = lo + (int)threadIdx.x; n < hi; n += THREADS) {
    uint32_t a, b;
    threefry2x32(u0, u1, 0u, (uint32_t)n, a, b);  // V < 2^31: the high word is 0
    const float score = x[n] + gumbel_of(a ^ b);
    if (better(score, n, bv, bi)) {
      bv = score;
      bi = n;
    }
  }
  warp_best(bv, bi);
  __shared__ float sv[WARPS];
  __shared__ int si[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < WARPS ? sv[lane] : -INFINITY;
    bi = lane < WARPS ? si[lane] : 0x7fffffff;
    warp_best(bv, bi);
    if (lane == 0) {
      part_v[row * splits + s] = bv;
      part_i[row * splits + s] = bi;
    }
  }
}

// One warp a row: the best of the row's partials, and the carry key.
__global__ void __launch_bounds__(32)
gumbel_argmax_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                           int splits, const long long* __restrict__ keys,
                           long long* __restrict__ carry, long long* __restrict__ choice) {
  const int row = blockIdx.x, lane = threadIdx.x;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int s = lane; s < splits; s += 32) {
    const float v = part_v[row * splits + s];
    const int i = part_i[row * splits + s];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  warp_best(bv, bi);
  if (lane == 0) {
    uint32_t c0, c1;
    threefry2x32((uint32_t)keys[2 * row], (uint32_t)keys[2 * row + 1], 0u, 0u, c0, c1);
    carry[2 * row] = (long long)c0;
    carry[2 * row + 1] = (long long)c1;
    choice[row] = (long long)bi;
  }
}

}  // namespace

extern "C" int gumbel_argmax_launch(const float* masked, long long row_stride,
                                    const long long* keys, int B, int V, int chunk,
                                    int splits, float* part_v, int* part_i,
                                    long long* carry, long long* choice, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gumbel_argmax_partial_kernel<<<dim3(splits, B), THREADS, 0, st>>>(
      masked, row_stride, keys, V, chunk, splits, part_v, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gumbel_argmax_merge_kernel<<<B, 32, 0, st>>>(part_v, part_i, splits, keys, carry, choice);
  return (int)cudaGetLastError();
}

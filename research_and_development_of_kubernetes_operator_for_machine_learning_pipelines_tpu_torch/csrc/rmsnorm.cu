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
// flops an element).  Design: x is read once and held in registers.
//
// - A row is cut into C contiguous pieces (a cluster of C CTAs, C = 1..8)
//   of `per_cta` vectors; a group of `tpr` threads (a power of two) holds
//   one piece, NV vectors a thread.  A vector is VEC elements: 16 bytes of
//   x (8 bf16 or 4 f32) where x, out and scale are 16-byte aligned and a
//   row is a whole number of 16 bytes, else one element (the scalar
//   instance).  Every load of x and of the scale is issued before the
//   reduction; nothing of x is read twice.
// - The f32 sum of squares: each thread's elements in order, shuffles
//   within the group, then the group's warps through shared memory.  With
//   C > 1 each CTA leaves its partial in shared memory; after a cluster
//   barrier every CTA adds the C partials in rank order through
//   distributed shared memory (the same total in each), scales its
//   registers and writes.  It arrives at a second barrier after its reads
//   and waits on it only before exiting, so its peers' shared memory
//   outlives every read of it.
// - The host picks the plan (ops/rmsnorm.py `rmsnorm_plan`) and passes
//   it: 256 threads a row (two 16-byte loads a thread at H = 4096 bf16),
//   several short rows a CTA, and a cluster only for a row longer than one
//   CTA holds.  On the H100 a cluster of 8 CTAs of 64 threads a 4096-wide
//   bf16 row was slower than one CTA (the barrier and the remote reads
//   cost more than the SMs they add), and 256 threads a row beat 512 and
//   128 (PERF.md: the smoke's plan sweep).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxVecThreads = 512;  // the 16-byte instances keep 128 registers a thread

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

// N elements of U, loaded and stored as whole 16-byte words where they span them.
template <typename U, int N>
struct alignas(sizeof(U) * N >= 16 ? 16 : sizeof(U) * N) Pack {
  U v[N];
};

template <typename T, typename S, int VEC, int NV>
__global__ void __launch_bounds__(VEC > 1 ? kMaxVecThreads : kMaxThreads) rmsnorm_kernel(
    const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out, int rows,
    int H, int per_cta, int tpr, int cluster, float eps) {
  __shared__ float red[kMaxThreads / 32];
  __shared__ float part;
  const int tid = threadIdx.x;
  const int grp = tid / tpr;
  const int j = tid % tpr;
  const int rank = blockIdx.x % cluster;
  const long long row = cluster > 1 ? (long long)(blockIdx.x / cluster)
                                    : (long long)blockIdx.x * (blockDim.x / tpr) + grp;
  const bool live = row < rows;
  const int nvec = H / VEC;
  const Pack<T, VEC>* xr = reinterpret_cast<const Pack<T, VEC>*>(x + row * H);
  const Pack<S, VEC>* sr = reinterpret_cast<const Pack<S, VEC>*>(scale);
  Pack<T, VEC>* orow = reinterpret_cast<Pack<T, VEC>*>(out + row * H);

  Pack<T, VEC> xv[NV];
  Pack<S, VEC> sv[NV];
  int idx[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int local = k * tpr + j;
    idx[k] = rank * per_cta + local;
    if (!live || local >= per_cta || idx[k] >= nvec) idx[k] = -1;
    if (idx[k] >= 0) {
      xv[k] = xr[idx[k]];
      sv[k] = sr[idx[k]];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (idx[k] >= 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(xv[k].v[e]);
        ss += f * f;
      }
    }
  }
  // The group's lanes (a group of tpr < 32 threads is aligned in its warp).
  for (int off = (tpr < 32 ? tpr : 32) / 2; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (tpr > 32) {  // the group's warps, in order
    const int warp = tid / 32;
    if (tid % 32 == 0) red[warp] = ss;
    __syncthreads();
    const int w0 = grp * (tpr / 32);
    ss = 0.f;
    for (int w = 0; w < tpr / 32; ++w) ss += red[w0 + w];
  }
  if (cluster > 1) {  // one row a cluster: add the C partials in rank order
    cg::cluster_group cl = cg::this_cluster();
    if (tid == 0) part = ss;
    cl.sync();
    ss = 0.f;
    for (int r = 0; r < cluster; ++r) ss += *cl.map_shared_rank(&part, r);
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  const float rs = rsqrtf(ss / (float)H + eps);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (idx[k] >= 0) {
      Pack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        o.v[e] = from_f32<T>(to_f32(xv[k].v[e]) * rs * to_f32(sv[k].v[e]));
      }
      orow[idx[k]] = o;
    }
  }
  if (cluster > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Plan {
  int rows, H, vec, nv, cluster, per_cta, tpr, threads;
};

template <typename T, typename S, int VEC, int NV>
cudaError_t launch(const void* x, const void* scale, void* out, const Plan& p, float eps,
                   cudaStream_t stream) {
  const int rpb = p.threads / p.tpr;
  const long long grid = p.cluster > 1 ? (long long)p.rows * p.cluster
                                       : ((long long)p.rows + rpb - 1) / rpb;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(p.threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, rmsnorm_kernel<T, S, VEC, NV>, static_cast<const T*>(x),
                            static_cast<const S*>(scale), static_cast<T*>(out), p.rows, p.H,
                            p.per_cta, p.tpr, p.cluster, eps);
}

template <typename T, typename S, int VEC>
cudaError_t by_nv(const void* x, const void* scale, void* out, const Plan& p, float eps,
                  cudaStream_t st) {
  switch (p.nv) {
    case 1: return launch<T, S, VEC, 1>(x, scale, out, p, eps, st);
    case 2: return launch<T, S, VEC, 2>(x, scale, out, p, eps, st);
    case 4: return launch<T, S, VEC, 4>(x, scale, out, p, eps, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename S>
cudaError_t by_vec(const void* x, const void* scale, void* out, const Plan& p, float eps,
                   cudaStream_t st) {
  if (p.vec == 1) return by_nv<T, S, 1>(x, scale, out, p, eps, st);
  if (p.vec * (int)sizeof(T) == 16) return by_nv<T, S, 16 / sizeof(T)>(x, scale, out, p, eps, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x_dtype, scale_dtype: 0 = float32, 1 = bfloat16.  plan: int[6], the
// plan of ops/rmsnorm.py `rmsnorm_plan` in its order: vec elements a load (1, or 16 bytes of
// x; then x, out and scale are 16-byte aligned and H a multiple of vec),
// nv vectors a thread (1, 2, 4), at most 512 threads a CTA with 16-byte
// vectors and 1024 with one element, a cluster of `cluster` CTAs a row (1..8),
// `per_cta` vectors a CTA's piece of a row, `tpr` threads a row piece (a
// power of two), `threads` a CTA (a multiple of tpr; tpr when cluster >
// 1).  Returns the launch's cudaError_t; nothing is synchronised.
extern "C" int rmsnorm_launch(int x_dtype, int scale_dtype, const void* x, const void* scale,
                              void* out, int rows, int H, const int* plan, float eps,
                              void* stream) {
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const int vec = plan[0], nv = plan[1], cluster = plan[2], per_cta = plan[3], tpr = plan[4],
            threads = plan[5];
  if (rows <= 0 || H <= 0 || vec <= 0 || H % vec != 0 || cluster < 1 || cluster > 8 ||
      tpr <= 0 || (tpr & (tpr - 1)) != 0 || threads <= 0 ||
      threads > (vec > 1 ? kMaxVecThreads : kMaxThreads) ||
      threads % tpr != 0 || (cluster > 1 && threads != tpr) ||
      (long long)cluster * per_cta < H / vec || (long long)tpr * nv < per_cta ||
      (long long)rows * cluster > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p{rows, H, vec, nv, cluster, per_cta, tpr, threads};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0) return (int)by_vec<float, float>(x, scale, out, p, eps, st);
  if (x_dtype == 0 && scale_dtype == 1)
    return (int)by_vec<float, __nv_bfloat16>(x, scale, out, p, eps, st);
  if (x_dtype == 1 && scale_dtype == 0)
    return (int)by_vec<__nv_bfloat16, float>(x, scale, out, p, eps, st);
  if (x_dtype == 1 && scale_dtype == 1)
    return (int)by_vec<__nv_bfloat16, __nv_bfloat16>(x, scale, out, p, eps, st);
  return (int)cudaErrorInvalidValue;
}

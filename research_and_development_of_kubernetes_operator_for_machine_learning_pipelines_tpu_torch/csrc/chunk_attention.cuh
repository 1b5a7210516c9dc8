// The shared core of the two chunk-against-window kernels (sm_90a): the
// verify chunk of decode_attention.cu and the ragged packed prefill of
// flash_attention.cu.  Both compute the attention lines of the JAX
// package's models/llama.py `_block_verify_deferred` (1039-1169, an
// einsum chain there, no Pallas kernel): a run of query rows against a
// cache window, then the causal chunk, with the exact diagonal and, on
// the int8 cache, the quantize round-trip below it, in one softmax.
//
// One block attends one PIECE of keys for one group of query rows: up to
// two SEGMENTS, a run of window keys and (in the last piece) the chunk.
// Its result is either final (the row's only piece) or an f32 partial
// (m, l, acc[D]) that a merge kernel joins with the row's other pieces by
// the usual max-rescale.  m is kept in log2 units (scores times log2 e).
//
// - Staging.  Key tiles of 64 rows go through a ring of NST stages in
//   dynamic shared memory with 16-byte `cp.async` (4-byte copies where the
//   window's rows are not 16-byte aligned), the raw rows as they lie in
//   the cache: int8 codes or bf16.  The key and value scales (int8) and
//   the additive mask (verify window) go beside them with 4-byte copies.
//   Tile t + NST - 1 is in flight while tile t is multiplied; keys past a
//   segment's end are zero-filled by the copy and masked.
// - int8 on the tensor cores.  Codes are exact in bf16, so once a raw tile
//   has landed the block converts it, once, into a bf16 tile (PRMT into
//   2^23 and back by the high half, exact, no I2F) that every warp reads
//   with `ldmatrix`: half the copy and ring bytes of a staged bf16 tile.
// - Warps.  A block of NW warps holds NW / ksplit row tiles of 16 rows;
//   the ksplit warps of a row tile take every ksplit-th 16-key slice of
//   each tile, each with its own online softmax, joined in shared memory
//   at the end.  Q . K and P . V are `mma.sync.m16n8k16` bf16 -> f32 with
//   q in registers for the whole piece; one online-softmax step a 16-key
//   slice, the rescale skipped while no row's max moves.
// - Precision.  PSPLIT (verify, f32 probabilities): p (times the value
//   scale) goes into P . V as a hi/lo pair of bf16, hi = bf16(p), lo =
//   bf16(p - hi), so p reaches the product within 2^-17 of itself.  Else
//   (ragged) p is rounded to bf16 once, as the flash kernel does.  Row sums
//   take the f32 p.
// - The diagonal (int8 chunk).  A row's score against its own chunk
//   position is the exact bf16 q . k in f32 (a CUDA-core dot before the
//   tile loop) in place of the round-trip score; its p stays out of the
//   MMA and p * v (the exact V row, f32) is added to the accumulator.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace chunk_attn {

constexpr int kBK = 64;            // keys a staged tile
constexpr int kSlice = 16;         // keys a warp takes a softmax step
constexpr float kFloor = -1e30f;   // the running max's start: exp2(-inf - kFloor) = 0
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (4) bytes global -> shared; `valid` false writes zeros instead.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 int8 codes -> 16 bf16 at dst.  Each code goes into 2^23 + 128 + code
// as an f32 (PRMT), loses the 2^23 + 128, and its high half is its bf16:
// integers of at most 8 bits are exact in bf16, so dropping the low half
// rounds nothing.
__device__ __forceinline__ void codes16_to_bf16(const uint4 w, __nv_bfloat16* dst) {
  const unsigned words[4] = {w.x, w.y, w.z, w.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u = words[i] ^ 0x80808080u;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
    out[2 * i] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    out[2 * i + 1] = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(out[0], out[1], out[2], out[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// 2^x (ex2.approx: relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two probabilities as a bf16 pair (hi) and, PSPLIT, the pair of what hi
// left out (lo).
template <bool PSPLIT>
__device__ __forceinline__ void pack_p(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  if (PSPLIT) {
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// A kernel's dynamic shared memory (opted in above 48 KB) and the largest
// shared-memory carveout, so as many blocks fit an SM as the bytes allow.
template <typename K>
cudaError_t prefer_shared(K kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// A run of keys: row i of K at k + i * k_sw bytes (V likewise), int8 scales
// at ks[i * ks_sw] (null for bf16), an additive f32 bias at mask[i] (or
// null).  `chunk`: the causal chunk, key j visible to a row at chunk
// position p iff j <= p; on the int8 cache j == p is the exact diagonal.
struct Segment {
  const unsigned char* k;
  const unsigned char* v;
  long long k_sw, v_sw;
  const float* ks;
  const float* vs;
  long long ks_sw, vs_sw;
  const float* mask;
  int n_keys;
  int vec16;
  int chunk;
};

// The block's query rows: row r (0 <= r < n_rows) at q + r * q_rs, at
// chunk position (row_base + r) / group; kx / vx: the chunk's exact K / V
// rows of q's type, position p at p * x_sw (int8 diagonal).
struct Rows {
  const __nv_bfloat16* q;
  long long q_rs;
  int n_rows, row_base, group;
  const __nv_bfloat16* kx;
  const __nv_bfloat16* vx;
  long long x_sw;
};

template <int D, bool I8, int NST>
struct Layout {
  static constexpr int kRowBytes = I8 ? D : 2 * D;   // a raw K or V row
  static constexpr int kRawLd = kRowBytes + 16;      // padded: ldmatrix rows hit 8 bank groups
  static constexpr int kLd = D + 8;                  // bf16 a converted (or bf16 raw) row
  static constexpr int kTile = kBK * kRawLd;         // one raw K or V tile
  static constexpr int kStage = 2 * kTile + 3 * kBK * 4;  // K, V, key scale, value scale, mask
  static constexpr int kConv = I8 ? 2 * kBK * kLd * 2 : 0;  // the converted K and V tiles
  static constexpr int kRing = NST * kStage + kConv;
  // The join of a row tile's warps reuses the ring.
  template <int NW>
  static constexpr int bytes() {
    return kRing > NW * 16 * (D + 2) * 4 ? kRing : NW * 16 * (D + 2) * 4;
  }
};

// Attends segments seg[0 .. nseg) (shared memory) for the block's rows.
// Leaves each warp's state: acc (the C fragments of its 16 rows x D), the
// running max m (log2 units) and the row sum l of its lanes' two rows,
// summed over the quad.  Every thread of the block calls it.
template <int D, bool I8, bool PSPLIT, int NW, int NST>
__device__ __forceinline__ void attend(const Segment* seg, int nseg, const Rows& rw, int ksplit,
                                       float sl, unsigned char* smem, float (&acc)[D / 8][4],
                                       float (&m_run)[2], float (&l_run)[2]) {
  using L = Layout<D, I8, NST>;
  constexpr int KS = D / 16;             // k-steps of Q . K^T
  constexpr int DN = D / 8;              // n8 tiles of the output
  constexpr int NT = NW * 32;
  constexpr int CPR = L::kRowBytes / 16; // 16-byte pieces of a raw row
  static_assert(D % 16 == 0 && NT >= kBK, "head dim a multiple of 16, a block of >= 2 warps");
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rt = warp / ksplit;          // this warp's row tile
  const int sub = warp % ksplit;         // its first slice of a tile
  const int g = lane >> 2;
  const int c = lane & 3;
  const int r0 = rt * 16 + g;            // this lane's rows: r0 and r0 + 8
  const int last = rw.n_rows - 1;
  const int pos0 = (rw.row_base + r0) / rw.group;
  const int pos1 = (rw.row_base + r0 + 8) / rw.group;
  const bool live = rt * 16 <= last;     // the warp's tile holds a real row
  const int pos_lo = (rw.row_base + rt * 16) / rw.group;
  const int pos_hi = (rw.row_base + min(rt * 16 + 15, last)) / rw.group;
  const int pos_last = (rw.row_base + last) / rw.group;

#pragma unroll
  for (int i = 0; i < DN; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  m_run[0] = m_run[1] = kFloor;
  l_run[0] = l_run[1] = 0.f;

  // Keys of each segment; the chunk's past the block's last position take no part.
  const int nk0 = seg[0].chunk ? min(seg[0].n_keys, pos_last + 1) : seg[0].n_keys;
  const int nk1 = nseg < 2 ? 0 : seg[1].chunk ? min(seg[1].n_keys, pos_last + 1) : seg[1].n_keys;
  const int nt0 = (nk0 + kBK - 1) / kBK;
  const int n_tiles = nt0 + (nk1 + kBK - 1) / kBK;
  const bool has_chunk = seg[0].chunk || (nseg > 1 && seg[1].chunk);

  // One tile's raw K/V rows and their per-key floats into stage t % NST.
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int si = t < nt0 ? 0 : 1;
      const Segment& sg = seg[si];
      const int k0 = (t - (si ? nt0 : 0)) * kBK;
      const int nk = si ? nk1 : nk0;
      unsigned char* st = smem + (t % NST) * L::kStage;
      const bool v16 = sg.vec16;
      const unsigned char* kbase = sg.k;
      const unsigned char* vbase = sg.v;
      const long long k_sw = sg.k_sw, v_sw = sg.v_sw;
#pragma unroll 4
      for (int idx = tid; idx < kBK * CPR; idx += NT) {
        const int r = idx / CPR;
        const int cc = (idx % CPR) * 16;
        const bool ok = k0 + r < nk;
        const long long key = ok ? k0 + r : 0;
        const unsigned char* ksrc = kbase + key * k_sw + cc;
        const unsigned char* vsrc = vbase + key * v_sw + cc;
        unsigned char* kd = st + r * L::kRawLd + cc;
        unsigned char* vd = kd + L::kTile;
        if (v16) {
          cp16(kd, ksrc, ok);
          cp16(vd, vsrc, ok);
        } else {
#pragma unroll
          for (int w = 0; w < 16; w += 4) {
            cp4(kd + w, ksrc + w, ok);
            cp4(vd + w, vsrc + w, ok);
          }
        }
      }
      if (tid < kBK) {
        float* sc = reinterpret_cast<float*>(st + 2 * L::kTile);
        const bool ok = k0 + tid < nk;
        const long long key = ok ? k0 + tid : 0;
        if (I8) {
          cp4(sc + tid, sg.ks + key * sg.ks_sw, ok);
          cp4(sc + kBK + tid, sg.vs + key * sg.vs_sw, ok);
        }
        if (sg.mask != nullptr) cp4(sc + 2 * kBK + tid, sg.mask + key, ok);
      }
    }
    commit();  // an empty group past the last tile keeps the count uniform
  };

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) issue(t);

  // Q as the A fragments of KS k-steps (rows past n_rows are zeros).
  uint32_t qf[KS][4];
  {
    const bool ok0 = r0 <= last, ok1 = r0 + 8 <= last;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(rw.q + (ok0 ? r0 : 0) * rw.q_rs);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(rw.q + (ok1 ? r0 + 8 : 0) * rw.q_rs);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qf[ks][0] = ok0 ? __ldg(q0 + ks * 8 + c) : 0u;
      qf[ks][1] = ok1 ? __ldg(q1 + ks * 8 + c) : 0u;
      qf[ks][2] = ok0 ? __ldg(q0 + ks * 8 + 4 + c) : 0u;
      qf[ks][3] = ok1 ? __ldg(q1 + ks * 8 + 4 + c) : 0u;
    }
  }

  // The exact diagonal scores of this lane's two rows (int8 chunk only).
  float dg[2] = {0.f, 0.f};
  if (I8 && has_chunk) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = 0.f;
      if (r0 + 8 * r <= last) {
        const __nv_bfloat162* qr =
            reinterpret_cast<const __nv_bfloat162*>(rw.q + (r0 + 8 * r) * rw.q_rs);
        const __nv_bfloat162* kr =
            reinterpret_cast<const __nv_bfloat162*>(rw.kx + (r ? pos1 : pos0) * rw.x_sw);
#pragma unroll 4
        for (int w = c; w < D / 2; w += 4) {
          const float2 a = __bfloat1622float2(qr[w]);
          const float2 b = __bfloat1622float2(kr[w]);
          s = fmaf(a.x, b.x, s);
          s = fmaf(a.y, b.y, s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dg[r] = s * sl;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    wait_groups<NST - 2>();  // this thread's copies of tile t have landed
    __syncthreads();         // everyone's have; tile t - 1 is consumed
    issue(t + NST - 1);      // into the stage tile t - 1 held
    const unsigned char* st = smem + (t % NST) * L::kStage;
    const __nv_bfloat16* sk;
    const __nv_bfloat16* sv;
    if constexpr (I8) {
      // The codes to bf16: by the whole block, or, when each warp owns one
      // 16-key slice of a tile (ksplit 4), by that warp alone.
      __nv_bfloat16* ck = reinterpret_cast<__nv_bfloat16*>(smem + NST * L::kStage);
      const bool own = ksplit == kBK / kSlice;
      const int first = own ? sub * kSlice * CPR + lane : tid;
      const int end = own ? (sub + 1) * kSlice * CPR : kBK * CPR;
      for (int idx = first; idx < end; idx += own ? 32 : NT) {
        const int r = idx / CPR;
        const int cc = (idx % CPR) * 16;
        codes16_to_bf16(*reinterpret_cast<const uint4*>(st + r * L::kRawLd + cc),
                        ck + r * L::kLd + cc);
        codes16_to_bf16(*reinterpret_cast<const uint4*>(st + L::kTile + r * L::kRawLd + cc),
                        ck + (kBK + r) * L::kLd + cc);
      }
      if (own) {
        __syncwarp();
      } else {
        __syncthreads();
      }
      sk = ck;
      sv = ck + kBK * L::kLd;
    } else {
      sk = reinterpret_cast<const __nv_bfloat16*>(st);
      sv = reinterpret_cast<const __nv_bfloat16*>(st + L::kTile);
    }
    if (!live) continue;  // no barrier follows in this iteration
    const float* sf = reinterpret_cast<const float*>(st + 2 * L::kTile);
    const int si = t < nt0 ? 0 : 1;
    const int k0 = (t - (si ? nt0 : 0)) * kBK;
    const int nk = si ? nk1 : nk0;
    const bool is_chunk = seg[si].chunk;
    const bool has_mask = seg[si].mask != nullptr;

    for (int sl_i = sub; sl_i < kBK / kSlice; sl_i += ksplit) {
      const int kb = k0 + sl_i * kSlice;  // the slice's first key in its segment
      if (kb >= nk || (is_chunk && kb > pos_hi)) break;  // warp-uniform

      // S = Q . K^T over the slice's 16 keys: two n8 tiles, the k-steps in
      // two interleaved accumulator chains (even and odd) joined at the end.
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kf[4];
        ldsm_x4(kf, sk + (sl_i * kSlice + (lane & 7) + (lane >> 4) * 8) * L::kLd + ks * 16 +
                        ((lane >> 3) & 1) * 8);
        mma((ks & 1) ? s2[0] : s[0], qf[ks], kf[0], kf[1]);
        mma((ks & 1) ? s2[1] : s[1], qf[ks], kf[2], kf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
      }

      // Scale (times the key scale) plus the mask, as a lane's key pairs
      // (2c, 2c + 1) of each n8 tile; then, unless every key of the slice
      // is visible to every row of the tile (`plain`), the exact diagonal
      // and the masks.
      const bool plain = kb + kSlice <= nk && (!is_chunk || kb + kSlice <= pos_lo);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = sl_i * kSlice + j * 8 + 2 * c;  // this lane's first key in the tile
        const float2 ksc = I8 ? *reinterpret_cast<const float2*>(sf + kl) : make_float2(1.f, 1.f);
        float2 bias = make_float2(0.f, 0.f);
        if (has_mask) {
          bias = *reinterpret_cast<const float2*>(sf + 2 * kBK + kl);
          bias.x *= kLog2e;
          bias.y *= kLog2e;
        }
        const float sx = sl * ksc.x, sy = sl * ksc.y;
        s[j][0] = fmaf(s[j][0], sx, bias.x);
        s[j][1] = fmaf(s[j][1], sy, bias.y);
        s[j][2] = fmaf(s[j][2], sx, bias.x);
        s[j][3] = fmaf(s[j][3], sy, bias.y);
        if (!plain) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + kl + (e & 1);
            const int pos = (e >> 1) ? pos1 : pos0;
            if (I8 && is_chunk && key == pos) s[j][e] = dg[e >> 1];
            if (!(key < nk && (!is_chunk || key <= pos))) s[j][e] = -INFINITY;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      if (__any_sync(0xffffffffu, mx[0] != m_run[0] || mx[1] != m_run[1])) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float corr = ex2(m_run[r] - mx[r]);
          m_run[r] = mx[r];
          l_run[r] *= corr;
#pragma unroll
          for (int i = 0; i < DN; ++i) {
            acc[i][2 * r] *= corr;
            acc[i][2 * r + 1] *= corr;
          }
        }
      }

      // P (times the value scale) as the A fragment of one k16 step.
      uint32_t ph[4], pl[4];
      float pd[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = sl_i * kSlice + j * 8 + 2 * c;
        const float2 vsc =
            I8 ? *reinterpret_cast<const float2*>(sf + kBK + kl) : make_float2(1.f, 1.f);
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[j][e] - m_run[e >> 1]);
          l_run[e >> 1] += p;
          pv[e] = p * ((e & 1) ? vsc.y : vsc.x);
          if (I8 && !plain && is_chunk && k0 + kl + (e & 1) == ((e >> 1) ? pos1 : pos0)) {
            pd[e >> 1] = p;
            pv[e] = 0.f;
          }
        }
        pack_p<PSPLIT>(pv[0], pv[1], ph[2 * j], pl[2 * j]);
        pack_p<PSPLIT>(pv[2], pv[3], ph[2 * j + 1], pl[2 * j + 1]);
      }

      // O += P . V: V's rows are keys, so ldmatrix.trans gives the col-major B.
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, sv + (sl_i * kSlice + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kLd +
                          dp * 16 + (lane >> 4) * 8);
        mma(acc[2 * dp], ph, vf[0], vf[1]);
        mma(acc[2 * dp + 1], ph, vf[2], vf[3]);
        if (PSPLIT) {
          mma(acc[2 * dp], pl, vf[0], vf[1]);
          mma(acc[2 * dp + 1], pl, vf[2], vf[3]);
        }
      }

      // p_jj * v_j from the exact V row: one lane of the quad holds p_jj.
      if (I8 && is_chunk && pos_lo < kb + kSlice && pos_hi >= kb) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 1);
          pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 2);
          const int pos = r ? pos1 : pos0;
          if (r0 + 8 * r <= last && pos >= kb && pos < kb + kSlice) {
            const __nv_bfloat162* vr =
                reinterpret_cast<const __nv_bfloat162*>(rw.vx + pos * rw.x_sw) + c;
#pragma unroll
            for (int i = 0; i < DN; ++i) {
              const float2 vv = __bfloat1622float2(vr[i * 4]);
              acc[i][2 * r] = fmaf(pd[r], vv.x, acc[i][2 * r]);
              acc[i][2 * r + 1] = fmaf(pd[r], vv.y, acc[i][2 * r + 1]);
            }
          }
        }
      }
    }
  }
  wait_groups<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
}

// Writes the block's n_rows rows, the ksplit warps of a row tile joined
// first (through shared memory, which the ring no longer needs): with
// part_acc, the piece's partial (acc [D] at part_acc + r * D, then m and
// l at part_ml + 2 r); else the final row acc / l, bf16 (out_bf) or f32
// (out_f), at r * out_rs.  Every thread of the block calls it.
template <int D, int NW>
__device__ __forceinline__ void finish(float (&acc)[D / 8][4], const float (&m)[2],
                                       const float (&l)[2], int ksplit, int n_rows,
                                       unsigned char* smem, __nv_bfloat16* out_bf, float* out_f,
                                       long long out_rs, float* part_acc, float* part_ml) {
  constexpr int DN = D / 8;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  if (ksplit == 1) {
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= n_rows) continue;
      if (part_acc != nullptr) {
        float* pa = part_acc + (long long)row * D + 2 * c;
#pragma unroll
        for (int i = 0; i < DN; ++i) {
          *reinterpret_cast<float2*>(pa + i * 8) = make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
        }
        if (c == 0) {
          part_ml[2 * row] = m[r];
          part_ml[2 * row + 1] = l[r];
        }
      } else {
        const float inv = 1.f / l[r];
        if (out_bf != nullptr) {
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out_bf + row * out_rs) + c;
#pragma unroll
          for (int i = 0; i < DN; ++i) {
            o[i * 4] = __floats2bfloat162_rn(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
          }
        } else {
          float* o = out_f + row * out_rs + 2 * c;
#pragma unroll
          for (int i = 0; i < DN; ++i) {
            *reinterpret_cast<float2*>(o + i * 8) =
                make_float2(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
          }
        }
      }
    }
    return;
  }
  __syncthreads();  // every warp is past the ring
  float* sacc = reinterpret_cast<float*>(smem);  // [NW][16][D]
  float* sml = sacc + NW * 16 * D;               // [NW][16][2]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = warp * 16 + g + 8 * r;
#pragma unroll
    for (int i = 0; i < DN; ++i) {
      *reinterpret_cast<float2*>(sacc + rr * D + i * 8 + 2 * c) =
          make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
    }
    if (c == 0) {
      sml[2 * rr] = m[r];
      sml[2 * rr + 1] = l[r];
    }
  }
  __syncthreads();
  const int rows = (NW / ksplit) * 16;
  for (int idx = tid; idx < rows * D; idx += NW * 32) {
    const int row = idx / D;
    const int d = idx % D;
    if (row >= n_rows) continue;
    const int w0 = (row / 16) * ksplit * 16 + row % 16;  // the row in its first warp's slab
    float mx = sml[2 * w0];
    for (int k = 1; k < ksplit; ++k) mx = fmaxf(mx, sml[2 * (w0 + 16 * k)]);
    float lsum = 0.f, a = 0.f;
    for (int k = 0; k < ksplit; ++k) {
      const int w = w0 + 16 * k;
      const float f = exp2f(sml[2 * w] - mx);
      lsum += sml[2 * w + 1] * f;
      a += sacc[w * D + d] * f;
    }
    if (part_acc != nullptr) {
      part_acc[(long long)row * D + d] = a;
      if (d == 0) {
        part_ml[2 * row] = mx;
        part_ml[2 * row + 1] = lsum;
      }
    } else if (out_bf != nullptr) {
      out_bf[row * out_rs + d] = __float2bfloat16(a / lsum);
    } else {
      out_f[row * out_rs + d] = a / lsum;
    }
  }
}

// Joins a row's f32 partials with TPR threads (thread t of the row takes
// the column pairs 2 t + 2 TPR k, so the row's threads read its partials
// contiguously): the row's partial of piece p at row index row + p *
// stride of part_acc (D floats) and part_ml (m, l); the result acc / l
// over `pieces` pieces by the max-rescale, to out (f32 or bf16).
template <int D, int TPR, typename T>
__device__ __forceinline__ void join_row(const float* __restrict__ part_acc,
                                         const float* __restrict__ part_ml, long long row,
                                         long long stride, int pieces, int t,
                                         T* __restrict__ out) {
  constexpr int kPairs = D / (2 * TPR);
  static_assert(kPairs >= 1 && D % (2 * TPR) == 0, "TPR threads must split the row's pairs");
  float mx = kFloor;
  for (int p = 0; p < pieces; ++p) mx = fmaxf(mx, part_ml[2 * (row + p * stride)]);
  float lsum = 0.f;
  float2 a[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) a[k] = make_float2(0.f, 0.f);
  for (int p = 0; p < pieces; ++p) {
    const long long at = row + p * stride;
    const float f = exp2f(part_ml[2 * at] - mx);
    lsum += part_ml[2 * at + 1] * f;
    const float* src = part_acc + at * D + 2 * t;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const float2 x = *reinterpret_cast<const float2*>(src + 2 * TPR * k);
      a[k].x = fmaf(x.x, f, a[k].x);
      a[k].y = fmaf(x.y, f, a[k].y);
    }
  }
  const float inv = 1.f / lsum;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    T* o = out + 2 * t + 2 * TPR * k;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(o) = make_float2(a[k].x * inv, a[k].y * inv);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a[k].x * inv, a[k].y * inv);
    }
  }
}

}  // namespace chunk_attn

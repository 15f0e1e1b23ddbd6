// Pieces shared by the composed-attention forward (composed_attn.cu) and
// backward (composed_attn_bwd.cu) kernels: tile geometry, cp.async and
// ldmatrix/mma.sync wrappers for the bf16 kernels, the float32 tile loops,
// and the Philox4x32-10 generator of the attention-dropout keep-mask.
//
// Keep-mask (the counterpart of pltpu.prng_seed / prng_random_bits in the
// TPU kernels, whose bits cannot be reproduced here).  For row r (seed
// seeds[r], one uint32 per row drawn by the caller), head h, query q and key
// k, with thr = round(p * 2^32):
//
//   words = philox4x32_10(counter = (q >> 1, k >> 1, h, 0), key = (seed, 0))
//   bits  = words[2 * (q & 1) + (k & 1)]          keep  iff  bits >= thr
//
// One call covers a 2 x 2 block of (query, key).  The plain version
// (vidsgg_big_tpu_torch/ops/philox.py) computes the same function, so the
// forward kernel, the backward kernel and the plain version agree bit for
// bit.
#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;   // composite width
constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == BK, "the tile loaders copy BK rows for Q, K and V");

// ---- Philox4x32-10 (Salmon et al., SC'11; Random123's constants) --------
struct Words4 {
  uint32_t x[4];
};

__device__ __forceinline__ Words4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return Words4{{c0, c1, c2, c3}};
}

// The keep bits of the four weights a lane holds in an m16n8 accumulator
// fragment whose rows are queries qa and qa + 8 and whose columns are keys
// k and k + 1 (k even): kp = {(qa, k), (qa, k+1), (qa+8, k), (qa+8, k+1)}.
// Lanes L and L ^ 4 hold rows qa and qa ^ 1, so they share both Philox
// counters: each computes one call and they trade the halves the other
// needs.  The warp's first row must be even; all 32 lanes must call.
__device__ __forceinline__ void keep_frag_q(uint32_t seed, int h, int qa,
                                            int k, uint32_t thr,
                                            bool kp[4]) {
  const bool odd = qa & 1;
  const Words4 w = philox4x32_10((uint32_t)(odd ? qa + 8 : qa) >> 1,
                                 (uint32_t)k >> 1, (uint32_t)h, 0u, seed,
                                 0u);
  const uint32_t r0 = __shfl_xor_sync(FULL, odd ? w.x[0] : w.x[2], 4);
  const uint32_t r1 = __shfl_xor_sync(FULL, odd ? w.x[1] : w.x[3], 4);
  kp[0] = (odd ? r0 : w.x[0]) >= thr;
  kp[1] = (odd ? r1 : w.x[1]) >= thr;
  kp[2] = (odd ? w.x[2] : r0) >= thr;
  kp[3] = (odd ? w.x[3] : r1) >= thr;
}

// The same for a transposed fragment, rows keys ka and ka + 8, columns
// queries q and q + 1 (q even): kp = {(q, ka), (q+1, ka), (q, ka+8),
// (q+1, ka+8)}.  Lanes L and L ^ 4 hold keys ka and ka ^ 1.
__device__ __forceinline__ void keep_frag_k(uint32_t seed, int h, int q,
                                            int ka, uint32_t thr,
                                            bool kp[4]) {
  const bool odd = ka & 1;
  const Words4 w = philox4x32_10((uint32_t)q >> 1,
                                 (uint32_t)(odd ? ka + 8 : ka) >> 1,
                                 (uint32_t)h, 0u, seed, 0u);
  // the word of (q + i, k) is 2 i + (k & 1)
  const uint32_t r0 = __shfl_xor_sync(FULL, odd ? w.x[0] : w.x[1], 4);
  const uint32_t r1 = __shfl_xor_sync(FULL, odd ? w.x[2] : w.x[3], 4);
  kp[0] = (odd ? r0 : w.x[0]) >= thr;
  kp[1] = (odd ? r1 : w.x[2]) >= thr;
  kp[2] = (odd ? w.x[1] : r0) >= thr;
  kp[3] = (odd ? w.x[3] : r1) >= thr;
}

// the keep bit of one (q, k)
__device__ __forceinline__ bool keep_one(uint32_t seed, int h, int q, int k,
                                         uint32_t thr) {
  const Words4 w = philox4x32_10((uint32_t)q >> 1, (uint32_t)k >> 1,
                                 (uint32_t)h, 0u, seed, 0u);
  return w.x[2 * (q & 1) + (k & 1)] >= thr;
}

// ---- bfloat16 kernels: tensor cores ---------------------------------------
constexpr int TC_WARPS = 4;                 // 16 rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int LDH = D + 8;    // bf16 row stride of a tile: 272 B, so the 8
                              // rows of an ldmatrix hit distinct banks
constexpr int TILE = BK * LDH;
static_assert(TC_WARPS * 16 == BQ, "one warp per 16 rows");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row major) b (16 x 8, bf16, col major)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// BK rows x D bf16 from global (row stride D) into shared (row stride LDH),
// 16 bytes a thread per step
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int tid) {
  constexpr int VEC = D / 8;
  static_assert(BK * VEC % TC_THREADS == 0, "whole steps per thread");
#pragma unroll
  for (int step = 0; step < BK * VEC / TC_THREADS; ++step) {
    const int i = tid + step * TC_THREADS, r = i / VEC, c = i % VEC;
    cp_async16(dst + r * LDH + c * 8, src + (size_t)r * D + c * 8);
  }
}

// s (16 x 64, the warp's rows of a x b^T) = a rows [16] . b rows [64]^T,
// a and b tiles in shared memory with D channels per row; accumulator
// layout of m16n8: s[j] covers columns 8 j .. 8 j + 7
__device__ __forceinline__ void warp_scores(const bf16* a, const bf16* b,
                                            int lane, float s[BK / 8][4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * LDH + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < BK / 16; ++jp) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (jp * 16 + lane % 8 + 8 * (lane / 16)) * LDH +
                      kk * 16 + 8 * ((lane / 8) % 2));
      mma_bf16(s[2 * jp], af, bf[0], bf[1]);
      mma_bf16(s[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// o (16 x 128) += p (16 x 16, an A fragment) v[16 rows from v0] (16 x 128),
// v a shared tile with D channels per row
__device__ __forceinline__ void warp_accumulate(float o[D / 8][4],
                                                const uint32_t p[4],
                                                const bf16* v, int lane) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t bf[4];
    ldsm_x4_trans(bf, v + (lane % 8 + 8 * ((lane / 8) % 2)) * LDH +
                          np * 16 + 8 * (lane / 16));
    mma_bf16(o[2 * np], p, bf[0], bf[1]);
    mma_bf16(o[2 * np + 1], p, bf[2], bf[3]);
  }
}

// ---- float32 kernels: CUDA cores --------------------------------------------
constexpr int F_THREADS = 256;   // 16 x 16
constexpr int LDF = D + 1;       // float row stride of the (rows x D) tiles
constexpr int LDA = BK + 1;      // float row stride of a (64 x 64) tile

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int tid) {
  for (int i = tid; i < BK * D; i += F_THREADS)
    dst[(i / D) * LDF + i % D] = __ldg(src + i);
}

// s[i][j] = <a row ty + 16 i, b row tx + 16 j>
__device__ __forceinline__ void thread_scores(const float* sa, const float* sb,
                                              int ty, int tx, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sa[(ty + 16 * i) * LDF + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = sb[(tx + 16 * j) * LDF + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// o[i][j] += sum_kk p[ty + 16 i][kk] v[kk][tx + 16 j]: p a (64 x LDA) tile,
// v a (64 x LDF) tile
__device__ __forceinline__ void thread_accumulate(float o[4][8],
                                                  const float* p,
                                                  const float* v, int ty,
                                                  int tx) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float vv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) vv[j] = v[kk * LDF + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = p[(ty + 16 * i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] = fmaf(a, vv[j], o[i][j]);
    }
  }
}

// reductions over the 16 lanes that share ty (lane % 16 = tx)
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// reduction over the 4 lanes of an mma quad (the lanes that share a row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

}  // namespace

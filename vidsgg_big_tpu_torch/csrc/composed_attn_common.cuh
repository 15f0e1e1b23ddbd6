// Pieces shared by the composed-attention forward (composed_attn.cu) and
// backward (composed_attn_bwd.cu) kernels: tile geometry, cp.async
// wrappers, wgmma on 128-byte swizzled tiles, float32 products on the tensor
// cores as 3xTF32, and the Philox4x32-10 generator of the attention-dropout
// keep-mask.  Every helper is inline, so a kernel's machine code depends
// only on the helpers it calls.
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
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

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

// ---- cp.async, bf16 packing, quad sums -------------------------------------
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// reduction over the 4 lanes of an mma quad (the lanes that share a row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// ---- bfloat16 on wgmma (sm_90a) ---------------------------------------------
// One warpgroup (4 warps, 128 threads) issues each product of a 64-row tile.
// Tiles of 64 rows x D = 128 bf16 live in shared memory in the 128-byte
// swizzle: two 8 KB halves of 64 columns, each row 128 bytes with its 16-byte
// chunk c stored at chunk c ^ (row % 8).  A tile must start 1024-byte
// aligned.  The accumulator of m64nN gives warp w rows 16 w + g and 16 w + g
// + 8 and, per 8-column group j, d[4 j + e] at (row g + 8 (e / 2), column
// 8 j + 2 tg + (e & 1)): the m16n8 layout, so an accumulator turns into the
// A fragments of a register-A product in place, as in the mma.sync kernels.
constexpr int WG_THREADS = 128;
constexpr int SW_TILE = 64 * D * 2;   // bytes of a swizzled 64 x 128 tile

// the first 1024-byte boundary at or after p (dynamic shared memory is only
// 16-byte aligned; allocate 1 KB of slack)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - smem_addr(p) % 1024u) % 1024u);
}

// byte offset of (row r, 8-column chunk c in 0..15) in a swizzled tile
__device__ __forceinline__ uint32_t sw_offset(int r, int c) {
  return (uint32_t)((c >> 3) * (SW_TILE / 2) + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// 64 rows x D bf16 from global (row stride D) into a swizzled tile
__device__ __forceinline__ void load_tile_sw(unsigned char* dst,
                                             const bf16* src, int tid) {
#pragma unroll
  for (int step = 0; step < 64 * (D / 8) / WG_THREADS; ++step) {
    const int i = tid + step * WG_THREADS, r = i >> 4, c = i & 15;
    cp_async16(dst + sw_offset(r, c), src + (size_t)r * D + c * 8);
  }
}

// shared-memory matrix descriptor, 128-byte swizzle (offsets in bytes)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// a tile as a K-major operand (rows are M or N, columns are K): the 16
// columns of step kk
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return wg_desc(tile + (kk >> 2) * (SW_TILE / 2) + (kk & 3) * 32, 16, 1024);
}

// a tile as an MN-major B operand (rows are K, columns are N): rows
// 16 ks .. 16 ks + 15, all 128 columns
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks) {
  return wg_desc(tile + ks * 2048, SW_TILE / 2, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// all but the most recent group done
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// pins registers of an asynchronous product in place: before wg_fence (so
// that their last writes are not moved past it) and after wg_wait (so that
// no read is moved before it); without it ptxas serialises the products
// with warpgroup.wait of its own
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wg_hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// shared-memory writes of the generic proxy (cp.async) made visible to
// wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64) += a (64 x 16) b (64 x 16)^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_n64_ss(float (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128) += a (64 x 16, A fragments in registers) b (16 x 128), b
// MN-major in shared memory
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64],
                                              const uint32_t a[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- float32 on the tensor cores: 3xTF32 -----------------------------------
// mma.sync m16n8k8 takes TF32 operands (10 explicit mantissa bits; the
// tensor core reads the top 19 bits of each register).  Each float32
// operand v is split into hi = v rounded to TF32 (half a TF32 ulp added to
// the encoding, then the low 13 bits cleared: to nearest, ties away from
// zero) and lo = v - hi (exact, |lo| <= 2^-11 |v|, read truncated to TF32,
// an error of at most 2^-21 |v|), and a b ~= a_lo b_hi + a_hi b_lo + a_hi
// b_hi, small terms first, into a float32 accumulator: the dropped a_lo b_lo
// is about 2^-22 of a b, so a product keeps float32's precision to a few
// units in the last place, where one TF32 pass keeps about three decimal
// digits.  (This is the kernels' own arithmetic; cuBLAS and cuDNN keep
// allow_tf32 off, utils/device.strict_float32.)  Tiles are float32 with row
// stride LDT = D + 4, so fragment loads of rows g or 2 tg at columns tg or g
// hit 32 distinct banks.
constexpr int LDT = D + 4;

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8, row major) b (8 x 8, col major), one TF32 pass
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32; a is split already, b's two values are split here
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ahi[4],
                                           const uint32_t alo[4], float b0,
                                           float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(c, alo, h0, h1);
  mma_tf32(c, ahi, l0, l1);
  mma_tf32(c, ahi, h0, h1);
}

// ROWS x D float32 from global (row stride D) into shared (row stride LDT),
// by one warpgroup
template <int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int tid) {
  constexpr int VEC = D / 4;
  static_assert(ROWS * VEC % WG_THREADS == 0, "whole steps per thread");
#pragma unroll
  for (int step = 0; step < ROWS * VEC / WG_THREADS; ++step) {
    const int i = tid + step * WG_THREADS, r = i / VEC, c = i % VEC;
    cp_async16(dst + r * LDT + c * 4, src + (size_t)r * D + c * 4);
  }
}

// s (16 x 8 NJ) = a rows [16] . b rows [8 NJ]^T over D, in 3xTF32; a and b
// LDT tiles; accumulator layout of m16n8: s[j] covers columns 8 j .. 8 j + 7
template <int NJ>
__device__ __forceinline__ void warp_scores_tf32(const float* a,
                                                 const float* b, int g,
                                                 int tg, float s[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    const float* pa = a + g * LDT + kk * 8 + tg;
    uint32_t hi[4], lo[4];
    split_tf32(pa[0], hi[0], lo[0]);
    split_tf32(pa[8 * LDT], hi[1], lo[1]);
    split_tf32(pa[4], hi[2], lo[2]);
    split_tf32(pa[8 * LDT + 4], hi[3], lo[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* pb = b + (8 * j + g) * LDT + kk * 8 + tg;
      mma_3xtf32(s[j], hi, lo, pb[0], pb[4]);
    }
  }
}

// o (16 x 128) += p (16 x 8 NJ, accumulator layout) v rows [8 NJ] (x D), in
// 3xTF32.  Within each group of 8 columns of p, k = tg and tg + 4 of the A
// fragment stand for columns 2 tg and 2 tg + 1 (a sum does not depend on
// the order of its terms), so the accumulator is an A fragment in place,
// and v's rows are read in the same order.
template <int NJ>
__device__ __forceinline__ void warp_accumulate_tf32(float o[D / 8][4],
                                                     const float p[NJ][4],
                                                     const float* v, int g,
                                                     int tg) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t hi[4], lo[4];
    split_tf32(p[j][0], hi[0], lo[0]);
    split_tf32(p[j][2], hi[1], lo[1]);
    split_tf32(p[j][1], hi[2], lo[2]);
    split_tf32(p[j][3], hi[3], lo[3]);
    const float* pv = v + (8 * j + 2 * tg) * LDT + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      mma_3xtf32(o[n], hi, lo, pv[8 * n], pv[LDT + 8 * n]);
  }
}

}  // namespace

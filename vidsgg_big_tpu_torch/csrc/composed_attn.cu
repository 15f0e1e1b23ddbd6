// Head-composed QANet self-attention, forward, for Hopper (sm_90a), with a
// plain C interface bound through ctypes (vidsgg_big_tpu_torch/ops/
// composed_attn.py).
//
// Replaces the TPU kernel `_fwd_kernel` of vidsgg_big_tpu/ops/
// pallas_attention.py (:67-86, launched by `_fwd_call` :140-165 under
// `fused_composed_attention` :333-359).  For one row r of R = B*Q rows and
// each of H = 8 heads, with the composed operands built outside (qh = x Wqk_h
// + wb_h, vt = x Wvo_h):
//
//   S_h = qh_h x^T * scale + bias      scale = 1/sqrt(hd), hd = d/H = 16
//   A_h = softmax(S_h)                 over all T keys, in float32
//   Ã_h = A_h * keep_h / (1 - p)       train mode with dropout p only
//   out = sum_h cast(Ã_h) vt_h         cast: to the input dtype; f32 sums
//
// bias is 0 for valid and -1e30 for masked keys, added in float32: a fully
// masked row gives a uniform softmax (the mean of vt over T), as on the TPU;
// callers re-zero such rows.
//
// Two instances of each kernel.  The train instance (TRAIN = true) adds the
// attention-dropout keep-mask (composed_attn_common.cuh: Philox keyed by the
// row's seed, the head, the query and the key; thr = round(p * 2^32), keep
// iff bits >= thr, rescale 1/(1 - thr/2^32), as `_drop_consts` :56-59) and
// writes each (row, head, query)'s softmax statistics (the row max m and
// 1/l, in the kernel's own units: base 2 for bf16, base e for float32) for
// the backward kernels (composed_attn_bwd.cu).  With the online softmax the
// mask goes on the unnormalised weights: l sums exp(S - m) over every key,
// the dropped weights are zeroed before the second product, and the head's
// output is multiplied by (1/l) / (1 - p) at the head's end.  The two lanes
// that share a Philox counter split its call (keep_frag_q).
//
// Design.  One block of two warpgroups (256 threads) owns a 128-row query
// tile of one row r, 64 rows per warpgroup; the grid is R * ceil(T / 128)
// blocks, the query tiles of a row next to each other so that the row's x
// and vt stay in L2.  Each key tile of x and of vt_h lands in shared memory
// once for both warpgroups.  A block walks the heads and, per head, the
// keys in tiles of 64 once, with an online softmax (running row max m and
// sum l; the head's output o is rescaled by exp(m_old - m_new) when the max
// grows, and o / l is added to the sum over heads at the head's end).  Every
// exp runs on the special-function unit (ex2.approx).  When T % 128 == 64
// the last block's second warpgroup has no rows and writes nothing.
// Against the TPU kernel's order (normalise A, round it, multiply) the bf16
// path rounds the unnormalised exp(S - m) to bf16 and divides after the
// product: either way each weight carries one bf16 rounding (relative
// 2^-9), so the two agree to the bf16 tolerance (chip_smoke.py: 1e-2), not
// bit for bit.  A fully masked row stays uniform: every logit is exactly
// -1e30, so every exp is 1.
//   bfloat16: wgmma.  S (64 x 64 a warpgroup) is m64n64k16 of the 128-byte
//     swizzled Q and X tiles (k = 128 in 8 steps); its accumulator is
//     rounded in registers to the bf16 A fragments of the m64n128k16
//     product against the vt tile (B read MN-major); softmax in base 2.  The
//     x and vt tiles come by TMA (tensor maps encoded on the host, boxes of
//     64 x 64 in the same swizzle) into a ring of three stages with full and
//     empty mbarriers; the first thread of warpgroup 1 asks for the tiles
//     two steps ahead once every warp has released the stage.  Each step
//     issues S(it + 1) and P V(it) back to back, so the softmax of it + 1
//     (and its keep bits) runs while P V(it) does (FlashAttention-3's
//     intra-warpgroup overlap).  The sum over heads lives in shared memory
//     (64 floats a thread), so that the accumulators and fragments of both
//     products in flight fit in registers; each warpgroup reloads its own Q
//     tile (cp.async) once its last S product of a head is done.  No branch
//     separates a product from its wait (ptxas would serialise every wgmma
//     behind it): the warpgroup without rows runs the same steps on a stale
//     Q tile.
//   float32: mma.sync m16n8k8 on TF32 operands as 3xTF32
//     (composed_attn_common.cuh: every operand split into hi + lo in
//     registers, three products small terms first, float32's precision where
//     one TF32 pass keeps three digits).  8 warps of 16 rows; S = Q X^T and
//     o += P vt with P's accumulator serving as the A fragments in place;
//     softmax in base e.  Tiles (row stride LDT) through two cp.async
//     stages; the next head's Q loads as soon as the head's last S product
//     is done with it, and the sum over heads stays in registers.
// Both need the composite width d = 128 (every grounding config of the
// repo); the wrapper checks it and T % 64 == 0 (the layer's gate lets only
// T % 128 == 0 through).
//
// Bound on the card.  At the bench geometry (R = 1024, T = 512, d = 128,
// H = 8) the function is 4 T^2 d H R = 1.10e12 FLOP
// (fused_attention_flops, pallas_attention.py:314-330) and moves qh and vt
// (1.07 GB each in bf16), x and out (0.13 GB each): about 2.42 GB in bf16,
// 4.83 GB in f32.  On the H100 SXM at 700 W (989 TFLOP/s bf16 dense, 495
// TFLOP/s TF32, 3.35 TB/s; PERF.md's figures): bf16 1.112 ms by operations
// (bytes 0.72 ms), f32 6.664 ms by operations as 3xTF32 (three TF32
// products each; CUDA-core FMA at 67 TFLOP/s would take 16.4 ms), bytes
// 1.44 ms.  The f32 kernel also spends integer and float instructions on
// the hi/lo splits beside each TF32 product.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "composed_attn_common.cuh"

namespace {

constexpr int FWD_THREADS = 2 * WG_THREADS;   // two warpgroups
constexpr int QT = 128;                        // query rows per block
constexpr int KT = 64;                         // keys per tile
constexpr int STAGES = 3;                      // bf16 ring of key tiles

__host__ __device__ int query_tiles(int T) { return (T + QT - 1) / QT; }

// 2^v on the special-function unit (relative error about 2^-22; subnormal
// results flush to 0)
__device__ __forceinline__ float fast_exp2(float v) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(v));
  return y;
}

// ---- bfloat16: wgmma --------------------------------------------------------
// mbarriers (shared memory, 8 bytes each)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// a named barrier of `n` threads (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// TMA: a 64 x 64 bf16 box at (column c0, row c1) of a 2-D tensor map into
// shared memory (128-byte swizzle), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// Q of the two warpgroups, STAGES x (X, V_h) key tiles, the sum over heads
// (64 floats a thread), the bias [T] and the stages' mbarriers; 1 KB of
// slack aligns the tiles
size_t bf16_smem_bytes(int T) {
  return 1024 + (2 + 2 * STAGES) * (size_t)SW_TILE +
         sizeof(float) * (64 * (size_t)FWD_THREADS + T) +
         2 * STAGES * sizeof(uint64_t);
}

template <bool TRAIN>
__global__ void __launch_bounds__(FWD_THREADS, 1)
composed_attn_bf16_kernel(const __grid_constant__ CUtensorMap tmx,
                          const __grid_constant__ CUtensorMap tmv,
                          const bf16* __restrict__ qh,
                          const float* __restrict__ bias,
                          bf16* __restrict__ out, int H, int T, float scale,
                          const uint32_t* __restrict__ seeds, uint32_t thr,
                          float drop_scale, float2* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* sQ = sm;                      // [warpgroup] a head's Q
  unsigned char* sX = sm + 2 * SW_TILE;        // [STAGES] key tiles of x
  unsigned char* sV = sX + STAGES * SW_TILE;   // [STAGES] the keys of vt_h
  // the sum over heads, element i of thread t at [i][t]: out of the
  // registers, so that the products' accumulators fit beside the rest
  float* sAcc = reinterpret_cast<float*>(sV + STAGES * SW_TILE);
  float* sBias = sAcc + 64 * FWD_THREADS;      // [T], * log2 e
  uint64_t* full = reinterpret_cast<uint64_t*>(sBias + T);   // [STAGES]
  uint64_t* empty = full + STAGES;                           // [STAGES]

  const int nq = query_tiles(T), nk = T / KT, steps = H * nk;
  const int r = blockIdx.x / nq;
  const int tid = threadIdx.x, wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int warp = wtid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int qw = (blockIdx.x % nq) * QT + wg * 64;   // warpgroup's 1st query
  const bool live = qw < T;
  const int qa = qw + warp * 16 + g;                 // rows qa and qa + 8
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, FWD_THREADS / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < T; i += FWD_THREADS)
    sBias[i] = bias[(size_t)r * T + i] * LOG2E;
  const float scale2 = scale * LOG2E;                // softmax in base 2
  uint32_t seed = 0;
  if constexpr (TRAIN) seed = seeds[r];
  const uint32_t aQ = smem_addr(sQ) + wg * SW_TILE, aX = smem_addr(sX),
                 aV = smem_addr(sV);
  __syncthreads();   // the mbarriers and the bias

  // TMA of the x and vt_h tiles of step it (head it / nk, key tile it % nk)
  // into stage it % STAGES, completing on full[stage], by the first thread
  // of warpgroup 1, once every warp has released the stage's last step
  // (it - STAGES)
  auto load_kv = [&](int it) {
    if (tid != WG_THREADS) return;
    const int st = it % STAGES, k0 = (it % nk) * KT;
    if (it >= STAGES) mbar_wait(empty + st, (it / STAGES - 1) & 1);
    mbar_expect_tx(full + st, 2 * SW_TILE);
    const int xrow = r * T + k0, vrow = (r * H + it / nk) * T + k0;
    for (int half = 0; half < 2; ++half) {
      tma_load(sX + st * SW_TILE + half * (SW_TILE / 2), &tmx, 64 * half,
               xrow, full + st);
      tma_load(sV + st * SW_TILE + half * (SW_TILE / 2), &tmv, 64 * half,
               vrow, full + st);
    }
  };
  // this warpgroup's 64 queries of head h into its Q buffer (cp.async),
  // once every warp's last S product of head h - 1 is done with it
  auto load_q = [&](int h) {
    bar_sync(1 + wg, WG_THREADS);
    if (live)
      load_tile_sw(sQ + wg * SW_TILE,
                   qh + (((size_t)r * H + h) * T + qw) * D, wtid);
    cp_async_commit();
  };
  auto q_ready = [&] {   // the Q asked for is in, for every warp
    cp_async_wait<0>();
    fence_async_smem();
    bar_sync(1 + wg, WG_THREADS);
  };

  float o[64];     // this head's unnormalised output
  float s[32];     // one tile's scores (64 queries x 64 keys), then P
  uint32_t a[4][4];   // P in bf16: the A fragments of 4 k-steps
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    o[i] = 0.f;
    sAcc[i * FWD_THREADS + tid] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float al0 = 0.f, al1 = 0.f;     // the rescale of o that the tile brings
  float inv0 = 0.f, inv1 = 0.f;   // 1/l (x 1/(1-p)) of the last whole head

  // S = Q X^T of step it, issued (one wgmma group)
  auto issue_s = [&](int it) {
    const uint32_t xt = aX + (it % STAGES) * SW_TILE, qt = aQ;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg_hold(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_n64_ss(s, desc_k(qt, kk), desc_k(xt, kk));
    wg_commit();
  };
  // o (64 x 128) += P (64 x 64) V (64 x 128) of step it, issued
  auto issue_pv = [&](int it) {
    wg_hold(a);
    wg_hold(o);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_n128_rs(o, a[ks], desc_mn(aV + (it % STAGES) * SW_TILE, ks));
    wg_commit();
  };
  // the keep bits of step it, bit 4 j + e for element 4 j + e of s
  auto keep_bits = [&](int it) {
    uint32_t bits = FULL;
    if (TRAIN && thr != 0u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bool kp[4];
        keep_frag_q(seed, it / nk, qa, (it % nk) * KT + 8 * j + 2 * tg, thr,
                    kp);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!kp[e]) bits &= ~(1u << (4 * j + e));
      }
    }
    return bits;
  };
  // online softmax of step it's scores in place, base 2: s becomes exp(S -
  // m), al0 / al1 the rescale of the head's output.  Element 4 j + e:
  // query qa + 8 (e / 2), key 8 j + 2 tg + (e & 1) of the tile; the four
  // lanes of a quad share a row
  auto softmax = [&](int it) {
    const float* bt = sBias + (it % nk) * KT;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b0 = bt[8 * j + 2 * tg], b1 = bt[8 * j + 2 * tg + 1];
      s[4 * j] = fmaf(s[4 * j], scale2, b0);
      s[4 * j + 1] = fmaf(s[4 * j + 1], scale2, b1);
      s[4 * j + 2] = fmaf(s[4 * j + 2], scale2, b0);
      s[4 * j + 3] = fmaf(s[4 * j + 3], scale2, b1);
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    al0 = fast_exp2(m0 - mn0);   // 0 on the head's first tile
    al1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = fast_exp2(s[4 * j + e] - (e < 2 ? mn0 : mn1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * al0 + sum0;   // this lane's share; the quad sums at the end
    l1 = l1 * al1 + sum1;
  };
  // P, dropped where the keep bits say (l kept every key), rounded to bf16
  // into the A fragments
  auto to_a = [&](uint32_t bits) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = TRAIN && !((bits >> (4 * j + e)) & 1u) ? 0.f : s[4 * j + e];
      a[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      a[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
    }
  };
  // head h's sums are complete: its 1/l (and statistics), and the next
  // head's softmax starts afresh
  auto end_head = [&](int h) {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    inv0 = 1.f / l0;
    inv1 = 1.f / l1;
    if constexpr (TRAIN) {
      if (tg == 0 && live) {
        const size_t row = ((size_t)r * H + h) * T + qa;
        stats[row] = make_float2(m0, inv0);
        stats[row + 8] = make_float2(m1, inv1);
      }
      inv0 *= drop_scale;
      inv1 *= drop_scale;
    }
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
  };
  // the last head's output / l into the sum over heads (element 4 n + e
  // of o: row qa + 8 (e / 2))
  auto add_head = [&] {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      sAcc[i * FWD_THREADS + tid] += o[i] * ((i & 2) ? inv1 : inv0);
  };
  // before step it's P V: on a head's first tile the last head's output
  // goes into the sum over heads (o is complete) and o restarts; else o
  // moves to the tile's max
  auto rescale_o = [&](int it) {
    if (it % nk == 0) {
      add_head();
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= al0;
        o[4 * n + 1] *= al0;
        o[4 * n + 2] *= al1;
        o[4 * n + 3] *= al1;
      }
    }
  };

  for (int it = 0; it < STAGES - 1 && it < steps; ++it) load_kv(it);
  // head h + 1's Q is asked for once head h's last S product (step
  // (h + 1) nk - 1) is done, and waited for before its first
  const auto last_of_head = [&](int it) { return it % nk == nk - 1; };
  // A warpgroup without rows (T % 128 == 64) runs the same steps on
  // whatever its Q buffer holds and writes nothing: no branch on it splits
  // a product from its wait, which would make ptxas serialise the wgmmas
  load_q(0);
  q_ready();
  mbar_wait(full, 0);
  issue_s(0);
  {
    const uint32_t bits = keep_bits(0);
    wg_wait();
    wg_hold(s);
    if (last_of_head(0) && H > 1) load_q(1);
    softmax(0);
    to_a(bits);
  }
  // Step it issues S(it + 1) and P V(it) back to back: the softmax of it + 1
  // waits for S only and runs while P V(it) does (FlashAttention-3's
  // intra-warpgroup overlap), and P(it + 1) goes into the A fragments once
  // P V(it) is done with them
  for (int it = 0; it + 1 < steps; ++it) {
    const int nx = it + 1;
    if (it + STAGES - 1 < steps) load_kv(it + STAGES - 1);
    if (nx % nk == 0) q_ready();
    mbar_wait(full + nx % STAGES, (nx / STAGES) & 1);
    issue_s(nx);
    rescale_o(it);
    issue_pv(it);
    if (nx % nk == 0) end_head(it / nk);
    const uint32_t bits = keep_bits(nx);
    wg_wait1();   // S(it + 1) is done; P V(it) may still run
    wg_hold(s);
    if (last_of_head(nx) && nx / nk + 1 < H) load_q(nx / nk + 1);
    softmax(nx);
    wg_wait();
    wg_hold(o);
    wg_hold(a);
    to_a(bits);
    if (lane == 0) mbar_arrive(empty + it % STAGES);   // the warp is done
  }
  rescale_o(steps - 1);
  issue_pv(steps - 1);
  wg_wait();
  wg_hold(o);
  end_head(H - 1);
  add_head();
  if (!live) return;

  bf16* orow = out + ((size_t)r * T + qa) * D + 2 * tg;
  const float* acc = sAcc + tid;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(orow + n * 8) =
        pack_bf16(acc[(4 * n) * FWD_THREADS], acc[(4 * n + 1) * FWD_THREADS]);
    *reinterpret_cast<uint32_t*>(orow + 8 * D + n * 8) = pack_bf16(
        acc[(4 * n + 2) * FWD_THREADS], acc[(4 * n + 3) * FWD_THREADS]);
  }
}

// A 2-D tensor map over `rows` rows of D bf16 (row stride D), boxes of
// 64 x 64 in the 128-byte swizzle
CUresult encode_rows(CUtensorMap* map, const void* base, size_t rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return CUDA_ERROR_NOT_FOUND;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64}, step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// ---- float32: 3xTF32 on mma.sync ------------------------------------------
// Q of the block's 128 queries, two stages of (X, V_h) key tiles and the
// bias [T]
size_t f32_smem_bytes(int T) {
  return sizeof(float) * ((size_t)(QT + 4 * KT) * LDT + T);
}

template <bool TRAIN>
__global__ void __launch_bounds__(FWD_THREADS, 1)
composed_attn_f32_kernel(const float* __restrict__ qh,
                         const float* __restrict__ x,
                         const float* __restrict__ vt,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int H, int T, float scale,
                         const uint32_t* __restrict__ seeds, uint32_t thr,
                         float drop_scale, float2* __restrict__ stats) {
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;                    // [QT][LDT] this head's queries
  float* sX = sQ + QT * LDT;          // [2][KT][LDT] key tiles of x
  float* sV = sX + 2 * KT * LDT;      // [2][KT][LDT] the same keys of vt_h
  float* sBias = sV + 2 * KT * LDT;   // [T]

  const int nq = query_tiles(T), nk = T / KT, steps = H * nk;
  const int r = blockIdx.x / nq, q0 = (blockIdx.x % nq) * QT;
  const int tid = threadIdx.x, wg = tid / WG_THREADS, wtid = tid % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tg = lane % 4;
  const int qw = q0 + wg * 64;   // the warpgroup's first query
  const bool live = qw < T;
  const int qa = q0 + warp * 16 + g;   // rows qa and qa + 8
  for (int i = tid; i < T; i += FWD_THREADS)
    sBias[i] = bias[(size_t)r * T + i];
  uint32_t seed = 0;
  if constexpr (TRAIN) seed = seeds[r];

  // the x tile (warpgroup 0) or the vt_h tile (warpgroup 1) of step it
  // into stage it % 2
  auto load_kv = [&](int it) {
    const int st = it & 1, k0 = (it % nk) * KT;
    if (wg == 0)
      load_rows_f32<KT>(sX + st * KT * LDT, x + ((size_t)r * T + k0) * D,
                        wtid);
    else
      load_rows_f32<KT>(sV + st * KT * LDT,
                        vt + (((size_t)r * H + it / nk) * T + k0) * D, wtid);
  };
  auto load_q = [&](int h) {   // the warpgroup's 64 queries of head h
    if (live)
      load_rows_f32<64>(sQ + wg * 64 * LDT,
                        qh + (((size_t)r * H + h) * T + qw) * D, wtid);
  };
  load_q(0);
  load_kv(0);
  cp_async_commit();

  float acc[D / 8][4], o[D / 8][4];   // sum over heads; this head's output
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = o[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int h = it / nk, kt = it % nk, st = it & 1;
    if (it + 1 < steps) {
      load_kv(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // step it's tiles (and head h's Q) are in

    // S = Q X^T (16 queries x 64 keys a warp); element e of s[j]: query
    // qa + 8 (e / 2), key 8 j + 2 tg + (e & 1) of the tile
    float s[KT / 8][4];
    if (live)
      warp_scores_tf32<KT / 8>(sQ + (warp * 16) * LDT, sX + st * KT * LDT, g,
                               tg, s);
    if (kt == nk - 1 && h + 1 < H) {
      __syncthreads();   // every warp's S product is done with sQ
      load_q(h + 1);
      cp_async_commit();
    }
    if (live) {
      // online softmax, base e
      const float* bt = sBias + kt * KT;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const float b0 = bt[8 * j + 2 * tg], b1 = bt[8 * j + 2 * tg + 1];
        s[j][0] = fmaf(s[j][0], scale, b0);
        s[j][1] = fmaf(s[j][1], scale, b1);
        s[j][2] = fmaf(s[j][2], scale, b0);
        s[j][3] = fmaf(s[j][3], scale, b1);
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // exp(v) as 2^(v log2 e) on the special-function unit
      const float al0 = fast_exp2((m0 - mn0) * LOG2E),   // 0 at start
          al1 = fast_exp2((m1 - mn1) * LOG2E);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = fast_exp2((s[j][e] - (e < 2 ? mn0 : mn1)) * LOG2E);
        sum0 += s[j][0] + s[j][1];
        sum1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + sum0;   // this lane's share; the quad sums at the end
      l1 = l1 * al1 + sum1;
      if constexpr (TRAIN) {
        if (thr != 0u) {   // l keeps every key, the product does not
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            bool kp[4];
            keep_frag_q(seed, h, qa, kt * KT + 8 * j + 2 * tg, thr, kp);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!kp[e]) s[j][e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
      warp_accumulate_tf32<KT / 8>(o, s, sV + st * KT * LDT, g, tg);

      if (kt == nk - 1) {   // the head is done: acc += o / l
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        float inv0 = 1.f / l0, inv1 = 1.f / l1;
        if constexpr (TRAIN) {
          if (tg == 0) {
            const size_t row = ((size_t)r * H + h) * T + qa;
            stats[row] = make_float2(m0, inv0);
            stats[row + 8] = make_float2(m1, inv1);
          }
          inv0 *= drop_scale;
          inv1 *= drop_scale;
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][0] = fmaf(o[n][0], inv0, acc[n][0]);
          acc[n][1] = fmaf(o[n][1], inv0, acc[n][1]);
          acc[n][2] = fmaf(o[n][2], inv1, acc[n][2]);
          acc[n][3] = fmaf(o[n][3], inv1, acc[n][3]);
          o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
        }
        m0 = m1 = -INFINITY;
        l0 = l1 = 0.f;
      }
    }
    __syncthreads();   // every warp is done with stage st before it refills
  }
  if (!live) return;

  float* orow = out + ((size_t)r * T + qa) * D + 2 * tg;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(orow + n * 8) = make_float2(acc[n][0],
                                                           acc[n][1]);
    *reinterpret_cast<float2*>(orow + 8 * D + n * 8) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

template <bool TRAIN>
int launch_forward(const void* qh, const void* x, const void* vt,
                   const float* bias, const uint32_t* seeds, void* out,
                   float2* stats, int R, int H, int T, int bf16_inputs,
                   float scale, uint32_t thr, float drop_scale,
                   cudaStream_t s) {
  // T % 64 == 0; the TMA row coordinates (rows of vt) fit an int32
  if (R <= 0 || H <= 0 || T <= 0 || T % KT != 0 ||
      (long long)R * H * T > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_inputs ? bf16_smem_bytes(T) : f32_smem_bytes(T);
  const cudaError_t err =
      bf16_inputs
          ? cudaFuncSetAttribute(composed_attn_bf16_kernel<TRAIN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem)
          : cudaFuncSetAttribute(composed_attn_f32_kernel<TRAIN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset, so the error is not reported again later
    return (int)err;
  }
  const dim3 grid((unsigned)R * (unsigned)query_tiles(T));
  if (bf16_inputs) {
    CUtensorMap tmx, tmv;
    if (encode_rows(&tmx, x, (size_t)R * T) != CUDA_SUCCESS ||
        encode_rows(&tmv, vt, (size_t)R * H * T) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    composed_attn_bf16_kernel<TRAIN><<<grid, FWD_THREADS, smem, s>>>(
        tmx, tmv, (const bf16*)qh, bias, (bf16*)out, H, T, scale, seeds, thr,
        drop_scale, stats);
  } else
    composed_attn_f32_kernel<TRAIN><<<grid, FWD_THREADS, smem, s>>>(
        (const float*)qh, (const float*)x, (const float*)vt, bias,
        (float*)out, H, T, scale, seeds, thr, drop_scale, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for T keys.
long long composed_attn_smem_bytes(int T, int bf16_inputs) {
  return (long long)(bf16_inputs ? bf16_smem_bytes(T) : f32_smem_bytes(T));
}

// Launches the inference kernel on `stream`; returns cudaGetLastError() (0 =
// launched).  qh and vt (R, H, T, 128), x and out (R, T, 128), all bfloat16
// when bf16_inputs else float32; bias (R, T) float32; all contiguous and
// 16-byte aligned.  T must be a multiple of 64.
int composed_attn_forward(const void* qh, const void* x, const void* vt,
                          const float* bias, void* out, int R, int H, int T,
                          int bf16_inputs, float scale, void* stream) {
  return launch_forward<false>(qh, x, vt, bias, nullptr, out, nullptr, R, H,
                               T, bf16_inputs, scale, 0u, 1.f,
                               (cudaStream_t)stream);
}

// The train instance: as composed_attn_forward, plus dropout at threshold
// `thr` (0: none) with rescale `drop_scale`, per-row seeds (R,) uint32, and
// the softmax statistics written to `stats` (R, H, T) x {m, 1/l} float32.
int composed_attn_forward_train(const void* qh, const void* x, const void* vt,
                                const float* bias, const void* seeds,
                                void* out, void* stats, int R, int H, int T,
                                int bf16_inputs, float scale, unsigned thr,
                                float drop_scale, void* stream) {
  return launch_forward<true>(qh, x, vt, bias, (const uint32_t*)seeds, out,
                              (float2*)stats, R, H, T, bf16_inputs, scale,
                              (uint32_t)thr, drop_scale,
                              (cudaStream_t)stream);
}

const char* composed_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

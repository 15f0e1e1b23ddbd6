// Head-composed QANet self-attention, backward, for Hopper (sm_90a), with a
// plain C interface bound through ctypes (vidsgg_big_tpu_torch/ops/
// composed_attn.py).
//
// Replaces the TPU kernel `_bwd_kernel` of vidsgg_big_tpu/ops/
// pallas_attention.py (:89-131, launched by `_bwd_call` :168-209 under the
// custom VJP `_fused` :294-311).  For row r, head h, with A_h the
// pre-dropout softmax of the forward (composed_attn.cu), keep_h its dropout
// mask and inv = 1 / (1 - p):
//
//   u    = do vt_h^T                  (T x T)
//   a_d  = A_h * keep * inv           da = u * keep * inv
//   rr   = sum_k da * A_h             per query (= do . o_h, o_h the head's
//                                      dropped output)
//   ds   = A_h (da - rr) * scale      cast to the input dtype before its
//                                      products, as the TPU kernel (:124)
//   dvt_h = cast(a_d)^T do    dqh_h = ds x    dx = sum_h ds^T qh_h
//
// all products accumulated in float32.
//
// Bound on the card.  The function is the TPU kernel's 10 T^2 d FLOP per
// row and head (fused_attention_flops): at the train geometry (R = 8
// videos x 2 x 64 predicate slots = 1024 rows, T = 512, 8 heads) 2.75e12
// FLOP, 2.78 ms in bf16 at 989 TFLOP/s; in f32 16.7 ms as 3xTF32 on the
// tensor cores (three TF32 products at 495 TFLOP/s), below the 41 ms of
// CUDA-core FMA at 67 TFLOP/s.  Its bytes (qh, vt, x, do, bias read; dqh,
// dvt, dx written) are 4.7 GB in bf16, 1.4 ms at 3.35 TB/s: it is bound by
// operations in both types.
//
// Design.  The TPU kernel carries dvt (8, T, 128) and dx (T, 128) in f32
// scratch across its sequential grid of query blocks.  On the card blocks
// run in parallel and a row's dvt accumulator (2 MB at T = 512) does not fit
// a block's shared memory, so the work is split FlashAttention-2 style into
// two kernels, neither with floating-point atomics (the backward is
// deterministic):
//   dq  (query-parallel; one block per (row, 64 queries)): per head, a first
//       sweep over the key tiles recomputes S and u and sums rr (written to
//       a (R, H, T) f32 buffer), a second sweep recomputes them and
//       accumulates dqh_h = ds x in registers.
//   dkv (key-parallel; one block per (row, 64 keys)): per head, a sweep
//       over the query tiles recomputes S^T and u^T from the forward's
//       statistics (m, 1/l per query) and rr, and accumulates dvt_h (this
//       head) and dx (all heads) for its keys in registers.
// So S and u are computed three times: 18 T^2 d per row and head, 1.8x the
// function's operations, the price of running without atomics or a
// sequential grid.  A_h is recomputed as exp(S - m) / l from the statistics
// the forward's train instance wrote (max and 1/l kept apart, so a fully
// masked row, every logit -1e30, stays uniform; a log-sum-exp would lose
// log T against 1e30).  The keep-mask is regenerated from the same Philox
// counter (composed_attn_common.cuh), so it is the forward's bit for bit;
// the two lanes that share a Philox counter split its call, and dq's first
// sweep leaves each thread's keep bits in shared memory for the second.
// Both dtypes reach the tensor cores:
//   bfloat16: wgmma on one warpgroup (128 threads) per block.  S and u are
//     m64n64k16 products of 128-byte swizzled tiles in shared memory; a_d
//     and ds are rounded to bf16 in registers into the A operand of the
//     m64n128k16 products (register A, B read MN-major from the tile).  The
//     keep bits of a tile are drawn while its S and u products run.  Key
//     tiles (dq) and query tiles with their statistics and rr (dk/dv) come
//     through a ring of two cp.async stages, so the next tile's load runs
//     under this tile's products; the next head's Q (dq) or V (dk/dv) tile
//     is loaded as soon as the head's last S or u product is done with it.
//   float32: mma.sync m16n8k8 on TF32 operands as 3xTF32
//     (composed_attn_common.cuh): every operand is split into hi + lo, a_d
//     and ds in registers before they become A fragments, so each product
//     keeps float32's precision.  4 warps of 16 rows; tiles of 32 keys
//     (dq) or queries (dk/dv), single-stage, with the tile's keep bits drawn
//     while it loads; 2 blocks an SM.

#include "composed_attn_common.cuh"

namespace {

// ---- bfloat16: wgmma --------------------------------------------------------
// DO, Q_h, two stages of (X, V_h) key tiles, the bias [T], and one word of
// keep bits per thread and key tile; 1 KB of slack aligns the tiles
size_t bf16_dq_smem(int T) {
  return 1024 + 6 * (size_t)SW_TILE + sizeof(float) * (size_t)T +
         sizeof(uint32_t) * (size_t)(T / 64) * WG_THREADS;
}

// X and V_h of the block's keys, two stages of (Q_h, DO) query tiles and of
// the tile's statistics {m, 1/l} and rr (64 queries each)
size_t bf16_dkv_smem() {
  return 1024 + 6 * (size_t)SW_TILE +
         2 * 64 * (sizeof(float2) + sizeof(float));
}

__global__ void __launch_bounds__(WG_THREADS, 2)
composed_attn_bwd_dq_bf16_kernel(
    const bf16* __restrict__ qh, const bf16* __restrict__ x,
    const bf16* __restrict__ vt, const float* __restrict__ bias,
    const uint32_t* __restrict__ seeds, const float2* __restrict__ stats,
    const bf16* __restrict__ dout, bf16* __restrict__ dqh,
    float* __restrict__ rbuf, int H, int T, float scale, uint32_t thr,
    float drop_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* sDO = sm;                 // do of the block's queries
  unsigned char* sQ = sm + SW_TILE;        // this head's queries
  unsigned char* sX = sm + 2 * SW_TILE;    // [2] key tiles of x, by stage
  unsigned char* sV = sm + 4 * SW_TILE;    // [2] the same keys of vt_h
  float* sBias = reinterpret_cast<float*>(sm + 6 * SW_TILE);   // * log2 e
  // this thread's keep bits of key tile kt: sKeep[kt * WG_THREADS + tid],
  // bit 4 j + e for element 4 j + e of the accumulator (the first sweep
  // writes, the second reads them)
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sBias + T);

  const int nq = T / 64, nk = T / 64, steps = H * 2 * nk;
  const int r = blockIdx.x / nq, q0 = (blockIdx.x % nq) * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int qa = q0 + warp * 16 + g;   // rows qa and qa + 8
  const bf16* xr = x + (size_t)r * T * D;
  for (int i = tid; i < T; i += WG_THREADS)
    sBias[i] = bias[(size_t)r * T + i] * LOG2E;
  const float scale2 = scale * LOG2E;
  const uint32_t seed = seeds[r];
  const uint32_t aDO = smem_addr(sDO), aQ = smem_addr(sQ),
                 aX = smem_addr(sX), aV = smem_addr(sV);

  // step it = (head it / 2 nk, sweep, key tile it % nk) into stage it % 2
  auto load_step = [&](int it) {
    const int kt = it % nk, st = it & 1;
    const size_t rh = (size_t)r * H + it / (2 * nk);
    load_tile_sw(sX + st * SW_TILE, xr + (size_t)kt * 64 * D, tid);
    load_tile_sw(sV + st * SW_TILE, vt + (rh * T + (size_t)kt * 64) * D, tid);
  };
  load_tile_sw(sDO, dout + ((size_t)r * T + q0) * D, tid);
  load_tile_sw(sQ, qh + ((size_t)r * H * T + q0) * D, tid);
  load_step(0);
  cp_async_commit();

  float dq[64];   // dqh_h of the warpgroup's 64 queries
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  float2 sta = make_float2(0.f, 0.f), stb = sta;
  float rra = 0.f, rrb = 0.f;   // rr of rows qa and qa + 8 (this lane's
                                // share, then the quad's sum)
  for (int it = 0; it < steps; ++it) {
    const int h = it / (2 * nk), pass = (it / nk) & 1, kt = it % nk,
              st = it & 1;
    const size_t rh = (size_t)r * H + h;
    if (it + 1 < steps) {
      load_step(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();   // step it's tiles (and this head's Q) are in
    if (pass == 0 && kt == 0) {
      sta = stats[rh * T + qa];
      stb = stats[rh * T + qa + 8];
    }

    // S = Q X^T and u = DO V^T (64 x 64 each)
    float s[32], u[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = u[i] = 0.f;
    wg_hold(s);
    wg_hold(u);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_n64_ss(s, desc_k(aQ, kk), desc_k(aX + st * SW_TILE, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_n64_ss(u, desc_k(aDO, kk), desc_k(aV + st * SW_TILE, kk));
    wg_commit();
    // the tile's keep bits, while the products run
    uint32_t bits = FULL;
    if (thr != 0u) {
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          bool kp[4];
          keep_frag_q(seed, h, qa, kt * 64 + 8 * j + 2 * tg, thr, kp);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!kp[e]) bits &= ~(1u << (4 * j + e));
        }
        sKeep[kt * WG_THREADS + tid] = bits;
      } else {
        bits = sKeep[kt * WG_THREADS + tid];
      }
    }
    wg_wait();
    wg_hold(s);
    wg_hold(u);
    if (pass == 1 && kt == nk - 1 && h + 1 < H) {
      __syncthreads();   // every warp's S product is done with sQ
      load_tile_sw(sQ, qh + ((rh + 1) * T + q0) * D, tid);
      cp_async_commit();
    }

    // element 4 j + e: query qa + 8 (e / 2), key c = 8 j + 2 tg + (e & 1)
    const float* bt = sBias + kt * 64;
    if (pass == 0) {   // rr += sum over the tile's keys of A u keep
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tg + (e & 1);
          const float2 sq = e < 2 ? sta : stb;
          const float p =
              exp2f(fmaf(s[4 * j + e], scale2, bt[c]) - sq.x) * sq.y;
          const float du = (bits >> (4 * j + e)) & 1u ? u[4 * j + e] : 0.f;
          if (e < 2)
            rra += p * du;
          else
            rrb += p * du;
        }
      if (kt == nk - 1) {   // the sweep is done: the quad's sum, scaled once
        rra = quad_sum(rra) * drop_scale;
        rrb = quad_sum(rrb) * drop_scale;
        if (tg == 0) {
          rbuf[rh * T + qa] = rra;
          rbuf[rh * T + qa + 8] = rrb;
        }
      }
    } else {
      // ds, rounded to bf16 into the A fragments of the next product
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tg + (e & 1);
          const float2 sq = e < 2 ? sta : stb;
          const float p =
              exp2f(fmaf(s[4 * j + e], scale2, bt[c]) - sq.x) * sq.y;
          const float du = (bits >> (4 * j + e)) & 1u ? u[4 * j + e] : 0.f;
          v[e] = p * (du * drop_scale - (e < 2 ? rra : rrb)) * scale;
        }
        a[j / 2][2 * (j % 2)] = pack_bf16(v[0], v[1]);
        a[j / 2][2 * (j % 2) + 1] = pack_bf16(v[2], v[3]);
      }

      // dq (64 x 128) += ds (64 x 64) X (64 x 128)
      wg_hold(a);
      wg_hold(dq);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_n128_rs(dq, a[ks], desc_mn(aX + st * SW_TILE, ks));
      wg_commit();
      wg_wait();
      wg_hold(dq);
      wg_hold(a);

      if (kt == nk - 1) {   // the head is done
        bf16* orow = dqh + (rh * T + qa) * D + 2 * tg;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(dq[4 * n], dq[4 * n + 1]);
          *reinterpret_cast<uint32_t*>(orow + 8 * D + n * 8) =
              pack_bf16(dq[4 * n + 2], dq[4 * n + 3]);
          dq[4 * n] = dq[4 * n + 1] = dq[4 * n + 2] = dq[4 * n + 3] = 0.f;
        }
        rra = rrb = 0.f;
      }
    }
    __syncthreads();   // every warp is done with stage st before it refills
  }
}

__global__ void __launch_bounds__(WG_THREADS, 2)
composed_attn_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ qh, const bf16* __restrict__ x,
    const bf16* __restrict__ vt, const float* __restrict__ bias,
    const uint32_t* __restrict__ seeds, const float2* __restrict__ stats,
    const bf16* __restrict__ dout, const float* __restrict__ rbuf,
    bf16* __restrict__ dx, bf16* __restrict__ dvt, int H, int T, float scale,
    uint32_t thr, float drop_scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* sX = sm;                  // the block's keys of x
  unsigned char* sV = sm + SW_TILE;        // the same keys of vt_h
  unsigned char* sQ = sm + 2 * SW_TILE;    // [2] query tiles of qh_h
  unsigned char* sDO = sm + 4 * SW_TILE;   // [2] do of those queries
  float2* sStat = reinterpret_cast<float2*>(sm + 6 * SW_TILE);   // [2][64]
  float* sR = reinterpret_cast<float*>(sStat + 2 * 64);          // [2][64]

  const int nq = T / 64, nk = T / 64, steps = H * nq;
  const int r = blockIdx.x / nk, k0 = (blockIdx.x % nk) * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int ka = k0 + warp * 16 + g;   // keys ka and ka + 8
  const float ba = bias[(size_t)r * T + ka] * LOG2E,
              bb = bias[(size_t)r * T + ka + 8] * LOG2E;
  const float scale2 = scale * LOG2E;
  const uint32_t seed = seeds[r];
  const uint32_t aX = smem_addr(sX), aV = smem_addr(sV),
                 aQ = smem_addr(sQ), aDO = smem_addr(sDO);

  // step it = (head it / nq, query tile it % nq) into stage it % 2
  auto load_step = [&](int it) {
    const int st = it & 1;
    const size_t rh = (size_t)r * H + it / nq, q0 = (size_t)(it % nq) * 64;
    load_tile_sw(sQ + st * SW_TILE, qh + (rh * T + q0) * D, tid);
    load_tile_sw(sDO + st * SW_TILE, dout + ((size_t)r * T + q0) * D, tid);
    if (tid < 32)
      cp_async16(sStat + st * 64 + 2 * tid, stats + rh * T + q0 + 2 * tid);
    else if (tid < 48)
      cp_async16(sR + st * 64 + 4 * (tid - 32),
                 rbuf + rh * T + q0 + 4 * (tid - 32));
  };
  load_tile_sw(sX, x + ((size_t)r * T + k0) * D, tid);
  load_tile_sw(sV, vt + ((size_t)r * H * T + k0) * D, tid);
  load_step(0);
  cp_async_commit();

  float dv[64], dxa[64];   // dvt_h of the 64 keys; dx, summed over heads
#pragma unroll
  for (int i = 0; i < 64; ++i) dv[i] = dxa[i] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int h = it / nq, qt = it % nq, st = it & 1;
    const size_t rh = (size_t)r * H + h;
    if (it + 1 < steps) {
      load_step(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();   // step it's tiles (and this head's V) are in

    // S^T = X Q^T and u^T = V DO^T (64 keys x 64 queries)
    float s[32], u[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = u[i] = 0.f;
    wg_hold(s);
    wg_hold(u);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_n64_ss(s, desc_k(aX, kk), desc_k(aQ + st * SW_TILE, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_n64_ss(u, desc_k(aV, kk), desc_k(aDO + st * SW_TILE, kk));
    wg_commit();
    // the tile's keep bits, bit 4 j + e for element 4 j + e, while the
    // products run
    uint32_t bits = FULL;
    if (thr != 0u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bool kp[4];
        keep_frag_k(seed, h, qt * 64 + 8 * j + 2 * tg, ka, thr, kp);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!kp[e]) bits &= ~(1u << (4 * j + e));
      }
    }
    wg_wait();
    wg_hold(s);
    wg_hold(u);
    if (qt == nq - 1 && h + 1 < H) {
      __syncthreads();   // every warp's u product is done with sV
      load_tile_sw(sV, vt + ((rh + 1) * T + k0) * D, tid);
      cp_async_commit();
    }

    // element 4 j + e: key ka + 8 (e / 2), query c = 8 j + 2 tg + (e & 1)
    const float2* sq = sStat + st * 64;
    const float* rq = sR + st * 64;
    uint32_t ad[4][4], dsf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float va[4], vd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tg + (e & 1);
        const bool kp = (bits >> (4 * j + e)) & 1u;
        const float2 mq = sq[c];
        const float p =
            exp2f(fmaf(s[4 * j + e], scale2, e < 2 ? ba : bb) - mq.x) * mq.y;
        va[e] = kp ? p * drop_scale : 0.f;
        vd[e] = p * ((kp ? u[4 * j + e] * drop_scale : 0.f) - rq[c]) * scale;
      }
      ad[j / 2][2 * (j % 2)] = pack_bf16(va[0], va[1]);
      ad[j / 2][2 * (j % 2) + 1] = pack_bf16(va[2], va[3]);
      dsf[j / 2][2 * (j % 2)] = pack_bf16(vd[0], vd[1]);
      dsf[j / 2][2 * (j % 2) + 1] = pack_bf16(vd[2], vd[3]);
    }

    // dv += a_d^T DO, dx += ds^T Q (64 keys x 128 each)
    wg_hold(ad);
    wg_hold(dsf);
    wg_hold(dv);
    wg_hold(dxa);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_n128_rs(dv, ad[ks], desc_mn(aDO + st * SW_TILE, ks));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_n128_rs(dxa, dsf[ks], desc_mn(aQ + st * SW_TILE, ks));
    wg_commit();
    wg_wait();
    wg_hold(dv);
    wg_hold(dxa);
    wg_hold(ad);
    wg_hold(dsf);

    if (qt == nq - 1) {   // the head is done
      bf16* vrow = dvt + (rh * T + ka) * D + 2 * tg;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(vrow + n * 8) =
            pack_bf16(dv[4 * n], dv[4 * n + 1]);
        *reinterpret_cast<uint32_t*>(vrow + 8 * D + n * 8) =
            pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
        dv[4 * n] = dv[4 * n + 1] = dv[4 * n + 2] = dv[4 * n + 3] = 0.f;
      }
    }
    __syncthreads();   // every warp is done with stage st before it refills
  }
  bf16* xrow = dx + ((size_t)r * T + ka) * D + 2 * tg;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(xrow + n * 8) =
        pack_bf16(dxa[4 * n], dxa[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(xrow + 8 * D + n * 8) =
        pack_bf16(dxa[4 * n + 2], dxa[4 * n + 3]);
  }
}

// ---- float32: 3xTF32 on the tensor cores ------------------------------------
constexpr int FK = 32;   // keys per tile (dq), queries per tile (dk/dv)

// Q_h and DO of the block's 64 queries, one (X, V_h) tile of FK keys, the
// bias [T], and one word of keep bits per thread and key tile
size_t f32_dq_smem(int T) {
  return sizeof(float) * ((size_t)(2 * 64 + 2 * FK) * LDT + T) +
         sizeof(uint32_t) * (size_t)(T / FK) * WG_THREADS;
}

// X and V_h of the block's 64 keys, one (Q_h, DO) tile of FK queries and
// its statistics and rr
size_t f32_dkv_smem() {
  return sizeof(float) * (size_t)(2 * 64 + 2 * FK) * LDT +
         FK * (sizeof(float2) + sizeof(float));
}

__global__ void __launch_bounds__(WG_THREADS, 2)
composed_attn_bwd_dq_f32_kernel(
    const float* __restrict__ qh, const float* __restrict__ x,
    const float* __restrict__ vt, const float* __restrict__ bias,
    const uint32_t* __restrict__ seeds, const float2* __restrict__ stats,
    const float* __restrict__ dout, float* __restrict__ dqh,
    float* __restrict__ rbuf, int H, int T, float scale, uint32_t thr,
    float drop_scale) {
  extern __shared__ __align__(16) float fsm[];
  float* sQ = fsm;                 // [64][LDT] this head's queries
  float* sDO = sQ + 64 * LDT;      // [64][LDT] do of the queries
  float* sX = sDO + 64 * LDT;      // [FK][LDT] a key tile of x
  float* sV = sX + FK * LDT;       // [FK][LDT] the same keys of vt_h
  float* sBias = sV + FK * LDT;    // [T]
  // this thread's keep bits of key tile kt: sKeep[kt * WG_THREADS + tid],
  // bit 4 j + e for element e of s[j] (the first sweep writes, the second
  // reads them)
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sBias + T);

  const int nq = T / 64, nk = T / FK, steps = H * 2 * nk;
  const int r = blockIdx.x / nq, q0 = (blockIdx.x % nq) * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int qa = q0 + warp * 16 + g;   // rows qa and qa + 8
  for (int i = tid; i < T; i += WG_THREADS) sBias[i] = bias[(size_t)r * T + i];
  const uint32_t seed = seeds[r];
  load_rows_f32<64>(sDO, dout + ((size_t)r * T + q0) * D, tid);

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  float2 sta = make_float2(0.f, 0.f), stb = sta;
  float rra = 0.f, rrb = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int h = it / (2 * nk), pass = (it / nk) & 1, kt = it % nk;
    const size_t rh = (size_t)r * H + h;
    __syncthreads();   // every warp is done with the last tiles
    if (pass == 0 && kt == 0) {
      load_rows_f32<64>(sQ, qh + (rh * T + q0) * D, tid);
      sta = stats[rh * T + qa];
      stb = stats[rh * T + qa + 8];
    }
    load_rows_f32<FK>(sX, x + ((size_t)r * T + (size_t)kt * FK) * D, tid);
    load_rows_f32<FK>(sV, vt + (rh * T + (size_t)kt * FK) * D, tid);
    cp_async_commit();
    // the tile's keep bits, while it loads
    uint32_t bits = FULL;
    if (thr != 0u) {
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < FK / 8; ++j) {
          bool kp[4];
          keep_frag_q(seed, h, qa, kt * FK + 8 * j + 2 * tg, thr, kp);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!kp[e]) bits &= ~(1u << (4 * j + e));
        }
        sKeep[kt * WG_THREADS + tid] = bits;
      } else {
        bits = sKeep[kt * WG_THREADS + tid];
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    float s[FK / 8][4], u[FK / 8][4];
    warp_scores_tf32<FK / 8>(sQ + warp * 16 * LDT, sX, g, tg, s);
    warp_scores_tf32<FK / 8>(sDO + warp * 16 * LDT, sV, g, tg, u);
    const float* bt = sBias + kt * FK;
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tg + (e & 1);   // key in the tile
        const float2 sq = e < 2 ? sta : stb;
        const float p = expf(fmaf(s[j][e], scale, bt[c]) - sq.x) * sq.y;
        const float du = (bits >> (4 * j + e)) & 1u ? u[j][e] : 0.f;
        if (pass == 0) {   // rr += A u keep
          if (e < 2)
            rra += p * du;
          else
            rrb += p * du;
        } else {
          s[j][e] = p * (du * drop_scale - (e < 2 ? rra : rrb)) * scale;
        }
      }
    if (pass == 0) {
      if (kt == nk - 1) {   // the sweep is done: the quad's sum, scaled once
        rra = quad_sum(rra) * drop_scale;
        rrb = quad_sum(rrb) * drop_scale;
        if (tg == 0) {
          rbuf[rh * T + qa] = rra;
          rbuf[rh * T + qa + 8] = rrb;
        }
      }
      continue;
    }
    warp_accumulate_tf32<FK / 8>(dq, s, sX, g, tg);   // dq += ds x

    if (kt == nk - 1) {   // the head is done
      float* orow = dqh + (rh * T + qa) * D + 2 * tg;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(orow + n * 8) =
            make_float2(dq[n][0], dq[n][1]);
        *reinterpret_cast<float2*>(orow + 8 * D + n * 8) =
            make_float2(dq[n][2], dq[n][3]);
        dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
      }
      rra = rrb = 0.f;
    }
  }
}

__global__ void __launch_bounds__(WG_THREADS, 2)
composed_attn_bwd_dkv_f32_kernel(
    const float* __restrict__ qh, const float* __restrict__ x,
    const float* __restrict__ vt, const float* __restrict__ bias,
    const uint32_t* __restrict__ seeds, const float2* __restrict__ stats,
    const float* __restrict__ dout, const float* __restrict__ rbuf,
    float* __restrict__ dx, float* __restrict__ dvt, int H, int T,
    float scale, uint32_t thr, float drop_scale) {
  extern __shared__ __align__(16) float fsm[];
  float* sX = fsm;                 // [64][LDT] the block's keys of x
  float* sV = sX + 64 * LDT;       // [64][LDT] the same keys of vt_h
  float* sQ = sV + 64 * LDT;       // [FK][LDT] a query tile of qh_h
  float* sDO = sQ + FK * LDT;      // [FK][LDT] do of those queries
  float2* sStat = reinterpret_cast<float2*>(sDO + FK * LDT);   // [FK]
  float* sR = reinterpret_cast<float*>(sStat + FK);             // [FK]

  const int nq = T / FK, nk = T / 64, steps = H * nq;
  const int r = blockIdx.x / nk, k0 = (blockIdx.x % nk) * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int ka = k0 + warp * 16 + g;   // keys ka and ka + 8
  const float ba = bias[(size_t)r * T + ka], bb = bias[(size_t)r * T + ka + 8];
  const uint32_t seed = seeds[r];
  load_rows_f32<64>(sX, x + ((size_t)r * T + k0) * D, tid);

  float dv[D / 8][4], dxa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dxa[n][e] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int h = it / nq, qt = it % nq;
    const size_t rh = (size_t)r * H + h, q0 = (size_t)qt * FK;
    __syncthreads();   // every warp is done with the last tiles
    if (qt == 0) load_rows_f32<64>(sV, vt + (rh * T + k0) * D, tid);
    load_rows_f32<FK>(sQ, qh + (rh * T + q0) * D, tid);
    load_rows_f32<FK>(sDO, dout + ((size_t)r * T + q0) * D, tid);
    cp_async_commit();
    if (tid < FK) {
      sStat[tid] = stats[rh * T + q0 + tid];
      sR[tid] = rbuf[rh * T + q0 + tid];
    }
    // the tile's keep bits, bit 4 j + e for element e of s[j], while it
    // loads
    uint32_t bits = FULL;
    if (thr != 0u) {
#pragma unroll
      for (int j = 0; j < FK / 8; ++j) {
        bool kp[4];
        keep_frag_k(seed, h, (int)q0 + 8 * j + 2 * tg, ka, thr, kp);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!kp[e]) bits &= ~(1u << (4 * j + e));
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // S^T and u^T (16 keys x FK queries per warp); element e of s[j]: key
    // ka + 8 (e / 2), query c = 8 j + 2 tg + (e & 1) of the tile
    float s[FK / 8][4], u[FK / 8][4], ad[FK / 8][4];
    warp_scores_tf32<FK / 8>(sX + warp * 16 * LDT, sQ, g, tg, s);
    warp_scores_tf32<FK / 8>(sV + warp * 16 * LDT, sDO, g, tg, u);
#pragma unroll
    for (int j = 0; j < FK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tg + (e & 1);
        const bool kp = (bits >> (4 * j + e)) & 1u;
        const float2 mq = sStat[c];
        const float p =
            expf(fmaf(s[j][e], scale, e < 2 ? ba : bb) - mq.x) * mq.y;
        ad[j][e] = kp ? p * drop_scale : 0.f;
        s[j][e] = p * ((kp ? u[j][e] * drop_scale : 0.f) - sR[c]) * scale;
      }
    warp_accumulate_tf32<FK / 8>(dv, ad, sDO, g, tg);    // dv += a_d^T do
    warp_accumulate_tf32<FK / 8>(dxa, s, sQ, g, tg);     // dx += ds^T qh

    if (qt == nq - 1) {   // the head is done
      float* vrow = dvt + (rh * T + ka) * D + 2 * tg;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(vrow + n * 8) =
            make_float2(dv[n][0], dv[n][1]);
        *reinterpret_cast<float2*>(vrow + 8 * D + n * 8) =
            make_float2(dv[n][2], dv[n][3]);
        dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
      }
    }
  }
  float* xrow = dx + ((size_t)r * T + ka) * D + 2 * tg;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(xrow + n * 8) =
        make_float2(dxa[n][0], dxa[n][1]);
    *reinterpret_cast<float2*>(xrow + 8 * D + n * 8) =
        make_float2(dxa[n][2], dxa[n][3]);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();   // reset it
  return err;
}

// the dq kernel, then the dk/dv kernel, one warpgroup per 64 queries or keys
template <typename In, typename DQ, typename DKV>
int launch_backward(DQ dq_kernel, DKV dkv_kernel, size_t dq_smem,
                    size_t dkv_smem, const void* qh, const void* x,
                    const void* vt, const float* bias, const void* seeds,
                    const void* stats, const void* dout, void* dqh, void* dx,
                    void* dvt, float* rbuf, int R, int H, int T, float scale,
                    uint32_t thr, float drop_scale, cudaStream_t s) {
  cudaError_t err;
  if ((err = allow_smem(dq_kernel, dq_smem)) != cudaSuccess ||
      (err = allow_smem(dkv_kernel, dkv_smem)) != cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)R * (unsigned)(T / 64));
  const uint32_t* sd = (const uint32_t*)seeds;
  const float2* st = (const float2*)stats;
  dq_kernel<<<grid, WG_THREADS, dq_smem, s>>>(
      (const In*)qh, (const In*)x, (const In*)vt, bias, sd, st,
      (const In*)dout, (In*)dqh, rbuf, H, T, scale, thr, drop_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkv_kernel<<<grid, WG_THREADS, dkv_smem, s>>>(
      (const In*)qh, (const In*)x, (const In*)vt, bias, sd, st,
      (const In*)dout, rbuf, (In*)dx, (In*)dvt, H, T, scale, thr,
      drop_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of the dq (pass 0) and dkv (pass 1)
// kernels for T keys.
long long composed_attn_bwd_smem_bytes(int T, int bf16_inputs, int pass) {
  if (bf16_inputs) return (long long)(pass ? bf16_dkv_smem() : bf16_dq_smem(T));
  return (long long)(pass ? f32_dkv_smem() : f32_dq_smem(T));
}

// Launches the dq kernel, then the dkv kernel, on `stream`; returns the
// first non-zero cudaError_t (0 = both launched).  qh, vt, dqh, dvt (R, H,
// T, 128), x, dout, dx (R, T, 128), all bfloat16 when bf16_inputs else
// float32; bias (R, T) f32; seeds (R,) uint32; stats (R, H, T) x {m, 1/l}
// f32 from composed_attn_forward_train; rbuf (R, H, T) f32 scratch.  All
// contiguous, 16-byte aligned; T a multiple of 64.
int composed_attn_backward(const void* qh, const void* x, const void* vt,
                           const float* bias, const void* seeds,
                           const void* stats, const void* dout, void* dqh,
                           void* dx, void* dvt, float* rbuf, int R, int H,
                           int T, int bf16_inputs, float scale, unsigned thr,
                           float drop_scale, void* stream) {
  if (R <= 0 || H <= 0 || T <= 0 || T % 64 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_inputs)
    return launch_backward<bf16>(
        composed_attn_bwd_dq_bf16_kernel, composed_attn_bwd_dkv_bf16_kernel,
        bf16_dq_smem(T), bf16_dkv_smem(), qh, x, vt, bias, seeds, stats,
        dout, dqh, dx, dvt, rbuf, R, H, T, scale, (uint32_t)thr, drop_scale,
        s);
  return launch_backward<float>(
      composed_attn_bwd_dq_f32_kernel, composed_attn_bwd_dkv_f32_kernel,
      f32_dq_smem(T), f32_dkv_smem(), qh, x, vt, bias, seeds, stats, dout,
      dqh, dx, dvt, rbuf, R, H, T, scale, (uint32_t)thr, drop_scale, s);
}

const char* composed_attn_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

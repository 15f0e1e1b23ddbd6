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
// A_h is recomputed as exp(S - m) / l from the statistics the forward's
// train instance wrote; the keep-mask is regenerated from the same Philox
// counter (composed_attn_common.cuh), so it is the forward's bit for bit.
// dq's first sweep leaves each thread's keep bits in shared memory for the
// second, and in the bf16 kernels the two lanes that share a Philox counter
// split its call.
//   bfloat16: mma.sync m16n8k16 with ldmatrix, 4 warps of 16 rows (queries
//     in dq, keys in dkv); S / u tiles and the accumulators stay in
//     registers, and a_d / ds turn into A operands in place (bf16).
//   float32: CUDA-core FMA, 256 threads as 16 x 16, as the forward.
// Tiles are loaded synchronously (cp.async then wait); double buffering,
// wgmma and a 128-row tile are later work.
//
// Bound on the card.  The TPU kernel's count is 10 T^2 d FLOP per row and
// head (fused_attention_flops): at the train geometry (R = 8 videos x 2 x
// 64 predicate slots = 1024 rows, T = 512) 2.75e12 FLOP, 2.78 ms in bf16 at
// 989 TFLOP/s and 41 ms in f32 at 67 TFLOP/s; bytes (qh, vt, do, x read,
// dqh, dvt, dx written) 4.4 GB in bf16, 1.3 ms.  This split recomputes S
// three times and u three times: 18 T^2 d per row and head, 1.8x the TPU
// kernel's operations, the price of running without atomics or a
// sequential grid.

#include "composed_attn_common.cuh"

namespace {

// ---- bfloat16: tensor cores -------------------------------------------------
// 4 tiles, the bias, and one word of keep bits per thread and key tile
size_t bf16_dq_smem(int T) {
  return sizeof(bf16) * 4 * (size_t)TILE + sizeof(float) * (size_t)T +
         sizeof(uint32_t) * (size_t)(T / BK) * TC_THREADS;
}

size_t bf16_dkv_smem() {
  return sizeof(bf16) * 4 * (size_t)TILE + sizeof(float) * 3 * BQ;
}

__global__ void __launch_bounds__(TC_THREADS, 2)
composed_attn_bwd_dq_bf16_kernel(
    const bf16* __restrict__ qh, const bf16* __restrict__ x,
    const bf16* __restrict__ vt, const float* __restrict__ bias,
    const uint32_t* __restrict__ seeds, const float2* __restrict__ stats,
    const bf16* __restrict__ dout, bf16* __restrict__ dqh,
    float* __restrict__ rbuf, int H, int T, float scale, uint32_t thr,
    float drop_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // this head's queries
  bf16* sDO = sQ + TILE;                      // do of the queries
  bf16* sX = sDO + TILE;                      // a key tile of x
  bf16* sV = sX + TILE;                       // the same keys of vt_h
  float* sBias = reinterpret_cast<float*>(sV + TILE);   // [T], * log2 e
  // this thread's keep bits of key tile kt: sKeep[kt * TC_THREADS + tid],
  // bit 4 j + e for element e of s[j] (the first sweep writes, the second
  // reads them)
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sBias + T);

  const int nq = T / BQ, nk = T / BK;
  const int r = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int qa = q0 + warp * 16 + g, qb = qa + 8;
  const bf16* xr = x + (size_t)r * T * D;
  for (int i = tid; i < T; i += TC_THREADS)
    sBias[i] = bias[(size_t)r * T + i] * LOG2E;
  const float scale2 = scale * LOG2E;
  const uint32_t seed = seeds[r];
  load_tile_async(sDO, dout + ((size_t)r * T + q0) * D, tid);

  for (int h = 0; h < H; ++h) {
    const size_t rh = (size_t)r * H + h;
    __syncthreads();   // every warp is done with the previous head's sQ
    load_tile_async(sQ, qh + (rh * T + q0) * D, tid);
    const float2 sta = stats[rh * T + qa], stb = stats[rh * T + qb];
    float dq[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
    float rra = 0.f, rrb = 0.f;   // rr of rows qa and qb (this lane's share,
                                  // then the quad's sum)
    for (int pass = 0; pass < 2; ++pass) {
      for (int kt = 0; kt < nk; ++kt) {
        __syncthreads();   // every warp is done with the last key tile
        load_tile_async(sX, xr + (size_t)kt * BK * D, tid);
        load_tile_async(sV, vt + (rh * T + (size_t)kt * BK) * D, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        float s[BK / 8][4], u[BK / 8][4];
        warp_scores(sQ + warp * 16 * LDH, sX, lane, s);
        warp_scores(sDO + warp * 16 * LDH, sV, lane, u);
        const float* bt = sBias + kt * BK;
        uint32_t bits = 0xffffffffu;   // keep bits of this tile
        if (thr != 0u) {
          if (pass == 0) {
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
              bool kp[4];
              keep_frag_q(seed, h, qa, kt * BK + j * 8 + 2 * tg, thr, kp);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (!kp[e]) bits &= ~(1u << (4 * j + e));
            }
            sKeep[kt * TC_THREADS + tid] = bits;
          } else {
            bits = sKeep[kt * TC_THREADS + tid];
          }
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          bool kp[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) kp[e] = (bits >> (4 * j + e)) & 1u;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 st = e < 2 ? sta : stb;
            const float p =
                exp2f(fmaf(s[j][e], scale2, bt[j * 8 + 2 * tg + (e & 1)]) -
                      st.x) * st.y;
            const float du = kp[e] ? u[j][e] : 0.f;
            if (pass == 0) {
              if (e < 2) rra += p * du;
              else rrb += p * du;
            } else {
              s[j][e] = p * (du * drop_scale - (e < 2 ? rra : rrb)) * scale;
            }
          }
        }
        if (pass == 1) {   // dq (16 x 128) += ds (16 x 64) x (64 x 128)
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            uint32_t a[4];
            a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
            a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
            a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
            a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
            warp_accumulate(dq, a, sX + ks * 16 * LDH, lane);
          }
        }
      }
      if (pass == 0) {
        rra = quad_sum(rra) * drop_scale;
        rrb = quad_sum(rrb) * drop_scale;
        if (tg == 0) {
          rbuf[rh * T + qa] = rra;
          rbuf[rh * T + qb] = rrb;
        }
      }
    }
    bf16* orow = dqh + (rh * T + qa) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(dq[n][0],
                                                             dq[n][1]);
      *reinterpret_cast<uint32_t*>(orow + 8 * D + n * 8) =
          pack_bf16(dq[n][2], dq[n][3]);
    }
  }
}

__global__ void __launch_bounds__(TC_THREADS, 2)
composed_attn_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ qh, const bf16* __restrict__ x,
    const bf16* __restrict__ vt, const float* __restrict__ bias,
    const uint32_t* __restrict__ seeds, const float2* __restrict__ stats,
    const bf16* __restrict__ dout, const float* __restrict__ rbuf,
    bf16* __restrict__ dx, bf16* __restrict__ dvt, int H, int T, float scale,
    uint32_t thr, float drop_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);   // this block's keys of x
  bf16* sV = sX + TILE;                       // the same keys of vt_h
  bf16* sQ = sV + TILE;                       // a query tile of qh_h
  bf16* sDO = sQ + TILE;                      // do of those queries
  float* sM = reinterpret_cast<float*>(sDO + TILE);   // [BQ] m (base 2)
  float* sL = sM + BQ;                                // [BQ] 1 / l
  float* sR = sL + BQ;                                // [BQ] rr

  const int nq = T / BQ, nk = T / BK;
  const int r = blockIdx.x / nk, k0 = (blockIdx.x % nk) * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int ka = k0 + warp * 16 + g, kb = ka + 8;
  const float ba = bias[(size_t)r * T + ka] * LOG2E,
              bb = bias[(size_t)r * T + kb] * LOG2E;
  const float scale2 = scale * LOG2E;
  const uint32_t seed = seeds[r];
  load_tile_async(sX, x + ((size_t)r * T + k0) * D, tid);

  float dxa[D / 8][4];   // dx of the warp's 16 keys, summed over heads
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[n][e] = 0.f;

  for (int h = 0; h < H; ++h) {
    const size_t rh = (size_t)r * H + h;
    __syncthreads();   // every warp is done with the previous head's sV
    load_tile_async(sV, vt + (rh * T + k0) * D, tid);
    float dv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] = 0.f;
    for (int qt = 0; qt < nq; ++qt) {
      __syncthreads();   // every warp is done with the last query tile
      load_tile_async(sQ, qh + (rh * T + (size_t)qt * BQ) * D, tid);
      load_tile_async(sDO, dout + ((size_t)r * T + (size_t)qt * BQ) * D,
                      tid);
      cp_async_commit();
      for (int i = tid; i < BQ; i += TC_THREADS) {
        const float2 st = stats[rh * T + qt * BQ + i];
        sM[i] = st.x;
        sL[i] = st.y;
        sR[i] = rbuf[rh * T + qt * BQ + i];
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int qc = 0; qc < BQ / 16; ++qc) {
        // S^T and u^T (16 keys x 16 queries): s[j] covers queries 8 j ..
        float s[2][4], u[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = u[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t af[4], bf[4];
          const int boff = (qc * 16 + lane % 8 + 8 * (lane / 16)) * LDH +
                           kk * 16 + 8 * ((lane / 8) % 2);
          const int aoff = (warp * 16 + lane % 16) * LDH + kk * 16 +
                           (lane / 16) * 8;
          ldsm_x4(af, sX + aoff);
          ldsm_x4(bf, sQ + boff);
          mma_bf16(s[0], af, bf[0], bf[1]);
          mma_bf16(s[1], af, bf[2], bf[3]);
          ldsm_x4(af, sV + aoff);
          ldsm_x4(bf, sDO + boff);
          mma_bf16(u[0], af, bf[0], bf[1]);
          mma_bf16(u[1], af, bf[2], bf[3]);
        }
        // element e of s[j]: key (e < 2 ? ka : kb), query ql + (e & 1)
        float ad[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ql = qc * 16 + j * 8 + 2 * tg, q = qt * BQ + ql;
          bool kp[4] = {true, true, true, true};
          if (thr != 0u) keep_frag_k(seed, h, q, ka, thr, kp);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = ql + (e & 1);
            const float p =
                exp2f(fmaf(s[j][e], scale2, e < 2 ? ba : bb) - sM[qi]) *
                sL[qi];
            ad[j][e] = kp[e] ? p * drop_scale : 0.f;
            const float du = kp[e] ? u[j][e] * drop_scale : 0.f;
            s[j][e] = p * (du - sR[qi]) * scale;
          }
        }
        uint32_t a[4];
        a[0] = pack_bf16(ad[0][0], ad[0][1]);
        a[1] = pack_bf16(ad[0][2], ad[0][3]);
        a[2] = pack_bf16(ad[1][0], ad[1][1]);
        a[3] = pack_bf16(ad[1][2], ad[1][3]);
        warp_accumulate(dv, a, sDO + qc * 16 * LDH, lane);
        a[0] = pack_bf16(s[0][0], s[0][1]);
        a[1] = pack_bf16(s[0][2], s[0][3]);
        a[2] = pack_bf16(s[1][0], s[1][1]);
        a[3] = pack_bf16(s[1][2], s[1][3]);
        warp_accumulate(dxa, a, sQ + qc * 16 * LDH, lane);
      }
    }
    bf16* vrow = dvt + (rh * T + ka) * D + 2 * tg;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(vrow + n * 8) = pack_bf16(dv[n][0],
                                                             dv[n][1]);
      *reinterpret_cast<uint32_t*>(vrow + 8 * D + n * 8) =
          pack_bf16(dv[n][2], dv[n][3]);
    }
  }
  bf16* xrow = dx + ((size_t)r * T + ka) * D + 2 * tg;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(xrow + n * 8) = pack_bf16(dxa[n][0],
                                                           dxa[n][1]);
    *reinterpret_cast<uint32_t*>(xrow + 8 * D + n * 8) =
        pack_bf16(dxa[n][2], dxa[n][3]);
  }
}

// ---- float32: CUDA cores ----------------------------------------------------
// 4 tiles, ds, the bias, and one word of keep bits per thread and key tile
size_t f32_dq_smem(int T) {
  return sizeof(float) * (4 * (size_t)BQ * LDF + BQ * LDA + T) +
         sizeof(uint32_t) * (size_t)(T / BK) * F_THREADS;
}

size_t f32_dkv_smem() {
  return sizeof(float) * (4 * (size_t)BQ * LDF + 2 * BQ * LDA + 3 * BQ);
}

__global__ void __launch_bounds__(F_THREADS)
composed_attn_bwd_dq_f32_kernel(
    const float* __restrict__ qh, const float* __restrict__ x,
    const float* __restrict__ vt, const float* __restrict__ bias,
    const uint32_t* __restrict__ seeds, const float2* __restrict__ stats,
    const float* __restrict__ dout, float* __restrict__ dqh,
    float* __restrict__ rbuf, int H, int T, float scale, uint32_t thr,
    float drop_scale) {
  extern __shared__ float fsmem[];
  float* sQ = fsmem;              // [BQ][LDF] this head's queries
  float* sDO = sQ + BQ * LDF;     // [BQ][LDF] do of the queries
  float* sX = sDO + BQ * LDF;     // [BK][LDF] a key tile of x
  float* sV = sX + BK * LDF;      // [BK][LDF] the same keys of vt_h
  float* sP = sV + BK * LDF;      // [BQ][LDA] ds
  float* sBias = sP + BQ * LDA;   // [T]
  // this thread's keep bits of key tile k0 / BK, bit 4 i + j (the first
  // sweep writes, the second reads them)
  uint32_t* sKeep = reinterpret_cast<uint32_t*>(sBias + T);

  const int nq = T / BQ;
  const int r = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* xr = x + (size_t)r * T * D;
  for (int i = tid; i < T; i += F_THREADS) sBias[i] = bias[(size_t)r * T + i];
  const uint32_t seed = seeds[r];
  load_tile_f32(sDO, dout + ((size_t)r * T + q0) * D, tid);

  for (int h = 0; h < H; ++h) {
    const size_t rh = (size_t)r * H + h;
    __syncthreads();   // every thread is done with the previous head's sQ
    load_tile_f32(sQ, qh + (rh * T + q0) * D, tid);
    float m[4], li[4], rr[4], dq[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 st = stats[rh * T + q0 + ty + 16 * i];
      m[i] = st.x;
      li[i] = st.y;
      rr[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) dq[i][j] = 0.f;
    }
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < T; k0 += BK) {
        __syncthreads();   // every thread is done with sX, sV and sP
        load_tile_f32(sX, xr + (size_t)k0 * D, tid);
        load_tile_f32(sV, vt + (rh * T + k0) * D, tid);
        __syncthreads();
        float s[4][4], u[4][4];
        thread_scores(sQ, sX, ty, tx, s);
        thread_scores(sDO, sV, ty, tx, u);
        uint32_t bits = 0xffffffffu;
        if (thr != 0u) {
          if (pass == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (!keep_one(seed, h, q0 + ty + 16 * i, k0 + tx + 16 * j,
                              thr))
                  bits &= ~(1u << (4 * i + j));
            sKeep[(k0 / BK) * F_THREADS + tid] = bits;
          } else {
            bits = sKeep[(k0 / BK) * F_THREADS + tid];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            const float p =
                expf(s[i][j] * scale + sBias[k] - m[i]) * li[i];
            const bool keep = (bits >> (4 * i + j)) & 1u;
            const float du = keep ? u[i][j] : 0.f;
            if (pass == 0)
              rr[i] += p * du;
            else
              sP[(ty + 16 * i) * LDA + tx + 16 * j] =
                  p * (du * drop_scale - rr[i]) * scale;
          }
        if (pass == 1) {
          __syncthreads();   // ds complete
          thread_accumulate(dq, sP, sX, ty, tx);
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rr[i] = row_sum16(rr[i]) * drop_scale;
          if (tx == 0) rbuf[rh * T + q0 + ty + 16 * i] = rr[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dqh[(rh * T + q0 + ty + 16 * i) * D + tx + 16 * j] = dq[i][j];
  }
}

__global__ void __launch_bounds__(F_THREADS)
composed_attn_bwd_dkv_f32_kernel(
    const float* __restrict__ qh, const float* __restrict__ x,
    const float* __restrict__ vt, const float* __restrict__ bias,
    const uint32_t* __restrict__ seeds, const float2* __restrict__ stats,
    const float* __restrict__ dout, const float* __restrict__ rbuf,
    float* __restrict__ dx, float* __restrict__ dvt, int H, int T,
    float scale, uint32_t thr, float drop_scale) {
  extern __shared__ float fsmem[];
  float* sX = fsmem;              // [BK][LDF] this block's keys of x
  float* sV = sX + BK * LDF;      // [BK][LDF] the same keys of vt_h
  float* sQ = sV + BK * LDF;      // [BQ][LDF] a query tile of qh_h
  float* sDO = sQ + BQ * LDF;     // [BQ][LDF] do of those queries
  float* sAd = sDO + BQ * LDF;    // [BK][LDA] a_d^T (keys x queries)
  float* sDs = sAd + BK * LDA;    // [BK][LDA] ds^T
  float* sM = sDs + BK * LDA;     // [BQ]
  float* sL = sM + BQ;            // [BQ]
  float* sR = sL + BQ;            // [BQ]

  const int nq = T / BQ, nk = T / BK;
  const int r = blockIdx.x / nk, k0 = (blockIdx.x % nk) * BK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const uint32_t seed = seeds[r];
  float bk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bk[i] = bias[(size_t)r * T + k0 + ty + 16 * i];
  load_tile_f32(sX, x + ((size_t)r * T + k0) * D, tid);

  float dxa[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dxa[i][j] = 0.f;

  for (int h = 0; h < H; ++h) {
    const size_t rh = (size_t)r * H + h;
    __syncthreads();   // every thread is done with the previous head's sV
    load_tile_f32(sV, vt + (rh * T + k0) * D, tid);
    float dv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dv[i][j] = 0.f;
    for (int qt = 0; qt < nq; ++qt) {
      __syncthreads();   // every thread is done with the last query tile
      load_tile_f32(sQ, qh + (rh * T + (size_t)qt * BQ) * D, tid);
      load_tile_f32(sDO, dout + ((size_t)r * T + (size_t)qt * BQ) * D, tid);
      for (int i = tid; i < BQ; i += F_THREADS) {
        const float2 st = stats[rh * T + qt * BQ + i];
        sM[i] = st.x;
        sL[i] = st.y;
        sR[i] = rbuf[rh * T + qt * BQ + i];
      }
      __syncthreads();
      float s[4][4], u[4][4];   // key ty + 16 i, query tx + 16 j
      thread_scores(sX, sQ, ty, tx, s);
      thread_scores(sV, sDO, ty, tx, u);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = tx + 16 * j, q = qt * BQ + ql, k = k0 + ty + 16 * i;
          const float p = expf(s[i][j] * scale + bk[i] - sM[ql]) * sL[ql];
          const bool keep = thr == 0u || keep_one(seed, h, q, k, thr);
          const int at = (ty + 16 * i) * LDA + ql;
          sAd[at] = keep ? p * drop_scale : 0.f;
          sDs[at] = p * ((keep ? u[i][j] * drop_scale : 0.f) - sR[ql]) *
                    scale;
        }
      __syncthreads();   // a_d^T and ds^T complete
      thread_accumulate(dv, sAd, sDO, ty, tx);
      thread_accumulate(dxa, sDs, sQ, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dvt[(rh * T + k0 + ty + 16 * i) * D + tx + 16 * j] = dv[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dx[((size_t)r * T + k0 + ty + 16 * i) * D + tx + 16 * j] = dxa[i][j];
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();   // reset it
  return err;
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
  if (R <= 0 || H <= 0 || T <= 0 || T % BQ != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)R * (unsigned)(T / BQ));
  const uint32_t* sd = (const uint32_t*)seeds;
  const float2* st = (const float2*)stats;
  cudaError_t err;
  if (bf16_inputs) {
    if ((err = allow_smem(composed_attn_bwd_dq_bf16_kernel,
                          bf16_dq_smem(T))) != cudaSuccess ||
        (err = allow_smem(composed_attn_bwd_dkv_bf16_kernel,
                          bf16_dkv_smem())) != cudaSuccess)
      return (int)err;
    composed_attn_bwd_dq_bf16_kernel<<<grid, TC_THREADS, bf16_dq_smem(T), s>>>(
        (const bf16*)qh, (const bf16*)x, (const bf16*)vt, bias, sd, st,
        (const bf16*)dout, (bf16*)dqh, rbuf, H, T, scale, (uint32_t)thr,
        drop_scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    composed_attn_bwd_dkv_bf16_kernel<<<grid, TC_THREADS, bf16_dkv_smem(),
                                        s>>>(
        (const bf16*)qh, (const bf16*)x, (const bf16*)vt, bias, sd, st,
        (const bf16*)dout, rbuf, (bf16*)dx, (bf16*)dvt, H, T, scale,
        (uint32_t)thr, drop_scale);
  } else {
    if ((err = allow_smem(composed_attn_bwd_dq_f32_kernel, f32_dq_smem(T))) !=
            cudaSuccess ||
        (err = allow_smem(composed_attn_bwd_dkv_f32_kernel,
                          f32_dkv_smem())) != cudaSuccess)
      return (int)err;
    composed_attn_bwd_dq_f32_kernel<<<grid, F_THREADS, f32_dq_smem(T), s>>>(
        (const float*)qh, (const float*)x, (const float*)vt, bias, sd, st,
        (const float*)dout, (float*)dqh, rbuf, H, T, scale, (uint32_t)thr,
        drop_scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    composed_attn_bwd_dkv_f32_kernel<<<grid, F_THREADS, f32_dkv_smem(), s>>>(
        (const float*)qh, (const float*)x, (const float*)vt, bias, sd, st,
        (const float*)dout, rbuf, (float*)dx, (float*)dvt, H, T, scale,
        (uint32_t)thr, drop_scale);
  }
  return (int)cudaGetLastError();
}

const char* composed_attn_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

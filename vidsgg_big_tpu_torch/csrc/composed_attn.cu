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
// Two instances of each kernel.  The inference instance (TRAIN = false) is
// PR 2's kernel unchanged.  The train instance adds the attention-dropout
// keep-mask (composed_attn_common.cuh: Philox keyed by the row's seed, the
// head, the query and the key; thr = round(p * 2^32), keep iff bits >= thr,
// rescale 1/(1 - thr/2^32), as `_drop_consts` :56-59) and writes each (row,
// head, query)'s softmax statistics (the row max m and 1/l, in the kernel's
// own units: base 2 for bf16, base e for float32) for the backward kernel
// (composed_attn_bwd.cu).  With the online softmax the mask goes on the
// unnormalised weights: l sums exp(S - m) over every key, the dropped
// weights are zeroed before the second product, and the head's output is
// multiplied by (1/l) / (1 - p) at the head's end.  In the bf16 kernel the
// two lanes of a mma quad pair that share a Philox counter split its call.
//
// Design.  One block owns BQ = 64 query rows of one row r; the grid is
// R * T/64 blocks, the query tiles of a row next to each other so that the
// row's x and vt stay in L2.  The block walks the heads and, per head, the
// keys in tiles of BK = 64 once, with an online softmax (running row max m
// and sum l; the partial output is rescaled by exp(m_old - m_new) when the
// max grows and divided by l at the head's end, then added to the output
// sum over heads).  Against the TPU kernel's order (normalise A, round it,
// multiply) the bf16 path rounds the unnormalised exp(S - m) to bf16 and
// divides after the product: either way each weight carries one bf16
// rounding (relative 2^-9), so the two agree to the bf16 tolerance
// (chip_smoke.py: 1e-2), not bit for bit.  A fully masked row stays uniform:
// every logit is exactly -1e30, so every exp is 1.
//   bfloat16: tensor cores through mma.sync m16n8k16 (bf16 in, f32
//     accumulate) with ldmatrix from shared memory.  4 warps, each owns 16
//     query rows: its S tile (16 x 64) stays in registers and turns into
//     the A operand of the second product in place (the accumulator layout
//     of m16n8 matches the A layout of m16n8k16); the head's output (16 x
//     128) and the sum over heads stay in registers.  Q, K and V tiles go
//     to shared memory with cp.async, double-buffered, so the next tile
//     loads while this one is multiplied.
//   float32: CUDA-core FMA (TF32 stays off, for parity with the reference).
//     256 threads as 16 x 16; a thread owns 4 query rows x 4 keys of S and
//     4 query rows x 8 channels of the output, strided by 16 so that shared
//     memory reads are conflict-free (row stride d + 1).
// Both need the composite width d = 128 (every grounding config of the
// repo); the wrapper checks it and T % 64 == 0 (the layer's gate lets only
// T % 128 == 0 through).
//
// Bound on the card.  At the bench geometry (R = 1024, T = 512, d = 128,
// H = 8) the function is 4 T^2 d H R = 1.10e12 FLOP
// (fused_attention_flops, pallas_attention.py:314-330) and moves qh and vt
// (1.07 GB each in bf16), x and out (0.13 GB each): about 2.42 GB in bf16,
// 4.83 GB in f32.  On an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s f32
// on CUDA cores, 3.35 TB/s): bf16 1.11 ms by operations (bytes 0.72 ms),
// f32 16.4 ms by operations (bytes 1.44 ms).  This version is far from that:
// mma.sync and not wgmma, 8 warps an SM, and the key tiles of x reloaded
// (from L2) for every head and query tile.  The train instance adds one
// Philox call (10 rounds of two 32-bit multiplies) per 2 x 2 block of
// weights, shared by the two lanes that hold it (bf16), on the integer
// pipes beside the tensor cores.

#include "composed_attn_common.cuh"

namespace {

// two stages of (K, V) tiles and two Q tiles (this head's and the next's)
size_t tc_smem_bytes(int T) {
  return sizeof(bf16) * 6 * (size_t)TILE + sizeof(float) * (size_t)T;
}

template <bool TRAIN>
__global__ void __launch_bounds__(TC_THREADS, 2)
composed_attn_bf16_kernel(const bf16* __restrict__ qh,
                          const bf16* __restrict__ x,
                          const bf16* __restrict__ vt,
                          const float* __restrict__ bias,
                          bf16* __restrict__ out, int H, int T, float scale,
                          const uint32_t* __restrict__ seeds, uint32_t thr,
                          float drop_scale, float2* __restrict__ stats) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [2][BQ][LDH], by head parity
  bf16* sK = sQ + 2 * TILE;                   // [2][BK][LDH], by stage
  bf16* sV = sK + 2 * TILE;                   // [2][BK][LDH], by stage
  float* sBias = reinterpret_cast<float*>(sV + 2 * TILE);   // [T], * log2 e

  const int nq = T / BQ, nk = T / BK, steps = H * nk;
  const int r = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;   // mma fragment row / column pair
  const bf16* xr = x + (size_t)r * T * D;
  for (int i = tid; i < T; i += TC_THREADS)
    sBias[i] = bias[(size_t)r * T + i] * LOG2E;
  const float scale2 = scale * LOG2E;     // softmax in base 2
  uint32_t seed = 0;
  if constexpr (TRAIN) seed = seeds[r];

  // loads of step `it` (head it / nk, key tile it % nk) into stage it % 2
  auto load_step = [&](int it) {
    const int h = it / nk, k0 = (it % nk) * BK, st = it % 2;
    const size_t rh = (size_t)r * H + h;
    if (k0 == 0) load_tile_async(sQ + (h % 2) * TILE, qh + (rh * T + q0) * D,
                                 tid);
    load_tile_async(sK + st * TILE, xr + (size_t)k0 * D, tid);
    load_tile_async(sV + st * TILE, vt + (rh * T + k0) * D, tid);
    cp_async_commit();
  };

  float acc[D / 8][4];   // sum over heads, rows g and g + 8 of the warp
  float o[D / 8][4];     // this head's unnormalised output
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = o[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  load_step(0);
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      load_step(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // step it's tiles (and the bias) are in

    const int h = it / nk, kt = it % nk, st = it % 2;
    const bf16* q = sQ + (h % 2) * TILE + warp * 16 * LDH;
    const bf16* k = sK + st * TILE;
    const bf16* v = sV + st * TILE;

    // S (16 x 64) = q k^T: 8 key groups of 8, 8 steps of 16 channels
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q + (lane % 16) * LDH + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, k + (jp * 16 + lane % 8 + 8 * (lane / 16)) * LDH +
                       kk * 16 + 8 * ((lane / 8) % 2));
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }

    // online softmax, base 2: rows g (e = 0, 1) and g + 8 (e = 2, 3); the
    // four lanes of a quad share a row
    const float* bt = sBias + kt * BK;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float b0 = bt[j * 8 + 2 * tg], b1 = bt[j * 8 + 2 * tg + 1];
      s[j][0] = fmaf(s[j][0], scale2, b0);
      s[j][1] = fmaf(s[j][1], scale2, b1);
      s[j][2] = fmaf(s[j][2], scale2, b0);
      s[j][3] = fmaf(s[j][3], scale2, b1);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);  // 0 at start
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + sum0;   // this lane's share; the quad sums at the end
    l1 = l1 * al1 + sum1;
    if constexpr (TRAIN) {
      if (thr != 0u) {   // dropout: l keeps every key, the product does not
        const int qa = q0 + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          bool kp[4];
          keep_frag_q(seed, h, qa, kt * BK + j * 8 + 2 * tg, thr, kp);
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

    // o (16 x 128) += P v: 4 steps of 16 keys, 16 channel groups of 8
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, v + (ks * 16 + lane % 8 + 8 * ((lane / 8) % 2)) *
                                 LDH + np * 16 + 8 * (lane / 16));
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }

    if (kt == nk - 1) {   // the head is done: acc += o / l
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(FULL, l0, off);
        l1 += __shfl_xor_sync(FULL, l1, off);
      }
      float inv0 = 1.f / l0, inv1 = 1.f / l1;
      if constexpr (TRAIN) {
        if (tg == 0) {
          const size_t row = ((size_t)r * H + h) * T + q0 + warp * 16 + g;
          stats[row] = make_float2(m0, inv0);
          stats[row + 8] = make_float2(m1, inv1);
        }
        inv0 *= drop_scale;
        inv1 *= drop_scale;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] += o[n][0] * inv0;
        acc[n][1] += o[n][1] * inv0;
        acc[n][2] += o[n][2] * inv1;
        acc[n][3] += o[n][3] * inv1;
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      }
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;
    }
    __syncthreads();   // every warp is done with stage st before it refills
  }

  bf16* orow = out + ((size_t)r * T + q0 + warp * 16 + g) * D + 2 * tg;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(acc[n][0],
                                                           acc[n][1]);
    *reinterpret_cast<uint32_t*>(orow + 8 * D + n * 8) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
}

// ---- float32 kernel: CUDA cores -----------------------------------------
size_t f32_smem_bytes(int T) {
  return sizeof(float) * ((size_t)BQ * LDF + BK * LDF + BQ * LDA + T);
}

template <bool TRAIN>
__global__ void __launch_bounds__(F_THREADS)
composed_attn_f32_kernel(const float* __restrict__ qh,
                         const float* __restrict__ x,
                         const float* __restrict__ vt,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int H, int T, float scale,
                         const uint32_t* __restrict__ seeds, uint32_t thr,
                         float drop_scale, float2* __restrict__ stats) {
  extern __shared__ float fsmem[];
  float* sQ = fsmem;                 // [BQ][LDF]
  float* sKV = sQ + BQ * LDF;        // [BK][LDF]: a key tile, then a value tile
  float* sA = sKV + BK * LDF;        // [BQ][LDA]
  float* sBias = sA + BQ * LDA;      // [T]

  const int nq = T / BQ;
  const int r = blockIdx.x / nq, q0 = (blockIdx.x % nq) * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* xr = x + (size_t)r * T * D;
  for (int i = tid; i < T; i += F_THREADS) sBias[i] = bias[(size_t)r * T + i];
  uint32_t seed = 0;
  if constexpr (TRAIN) seed = seeds[r];

  float acc[4][8], o[4][8];   // sum over heads; this head's unnormalised
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int h = 0; h < H; ++h) {
    const size_t rh = (size_t)r * H + h;
    __syncthreads();  // the previous head is done with sQ and sKV
    load_tile_f32(sQ, qh + (rh * T + q0) * D, tid);
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < T; k0 += BK) {
      load_tile_f32(sKV, xr + (size_t)k0 * D, tid);
      __syncthreads();
      float s[4][4];
      thread_scores(sQ, sKV, ty, tx, s);
      // online softmax: rescale this head's output when the row max grows
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = s[i][j] * scale + sBias[k0 + tx + 16 * j];
          tmax = fmaxf(tmax, s[i][j]);
        }
        const float mn = fmaxf(m[i], row_max16(tmax));
        const float alpha = expf(m[i] - mn);   // 0 on the first tile
        m[i] = mn;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - mn);
          sum += s[i][j];
          float w = s[i][j];
          if constexpr (TRAIN) {
            if (thr != 0u &&
                !keep_one(seed, h, q0 + ty + 16 * i, k0 + tx + 16 * j, thr))
              w = 0.f;
          }
          sA[(ty + 16 * i) * LDA + tx + 16 * j] = w;
        }
        l[i] = l[i] * alpha + sum;   // this lane's share; summed at the end
#pragma unroll
        for (int j = 0; j < 8; ++j) o[i][j] *= alpha;
      }
      __syncthreads();  // A complete; every thread is done with the key tile
      load_tile_f32(sKV, vt + (rh * T + k0) * D, tid);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = sKV[kk * LDF + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = sA[(ty + 16 * i) * LDA + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) o[i][j] = fmaf(a, v[j], o[i][j]);
        }
      }
      __syncthreads();  // every thread is done with A and the value tile
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float inv = 1.f / row_sum16(l[i]);
      if constexpr (TRAIN) {
        if (tx == 0) stats[rh * T + q0 + ty + 16 * i] = make_float2(m[i], inv);
        inv *= drop_scale;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(o[i][j], inv, acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[((size_t)r * T + q0 + ty + 16 * i) * D + tx + 16 * j] = acc[i][j];
}

template <bool TRAIN>
int launch_forward(const void* qh, const void* x, const void* vt,
                   const float* bias, const uint32_t* seeds, void* out,
                   float2* stats, int R, int H, int T, int bf16_inputs,
                   float scale, uint32_t thr, float drop_scale,
                   cudaStream_t s) {
  if (R <= 0 || H <= 0 || T <= 0 || T % BQ != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_inputs ? tc_smem_bytes(T) : f32_smem_bytes(T);
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
  const dim3 grid((unsigned)R * (unsigned)(T / BQ));
  if (bf16_inputs)
    composed_attn_bf16_kernel<TRAIN><<<grid, TC_THREADS, smem, s>>>(
        (const bf16*)qh, (const bf16*)x, (const bf16*)vt, bias, (bf16*)out, H,
        T, scale, seeds, thr, drop_scale, stats);
  else
    composed_attn_f32_kernel<TRAIN><<<grid, F_THREADS, smem, s>>>(
        (const float*)qh, (const float*)x, (const float*)vt, bias,
        (float*)out, H, T, scale, seeds, thr, drop_scale, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for T keys.
long long composed_attn_smem_bytes(int T, int bf16_inputs) {
  return (long long)(bf16_inputs ? tc_smem_bytes(T) : f32_smem_bytes(T));
}

// Launches the inference kernel on `stream`; returns cudaGetLastError() (0 =
// launched).  qh and vt (R, H, T, 128), x and out (R, T, 128), all bfloat16
// when bf16_inputs else float32; bias (R, T) float32; all contiguous, the
// bf16 ones 16-byte aligned.  T must be a multiple of 64.
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

// Fused role-factored bipartite attention of the BIG-C decoder, for Hopper
// (sm_90a), with a plain C interface bound through ctypes
// (vidsgg_big_tpu_torch/ops/role_attn.py).
//
// Replaces the TPU kernel `_kernel` of vidsgg_big_tpu/ops/pallas_role_attn.py
// (:27-52, launched by `role_attention` :63-109).  For each video b and role
// r in {0, 1}:
//
//   logits[r, q, n] = <p[r, q], e[r, n]> * (1 / sqrt(dim_enti))
//   att_enti        = softmax_n(logits, invalid n -> -FLT_MAX), then invalid
//                     n zeroed (an all-invalid row gives att = 0, no NaN)
//   att_role        = softmax_r(logits)          (the *unmasked* logits)
//   att             = att_enti * att_role                  -> (B, 2, Q, N)
//   values[r, q, :] = att[r, q, :] @ enco                  -> (B, 2, Q, De)
//
// Forward only, float32 throughout.
//
// Bound on the card.  At the exp2 decoder shape (B=8, Q=192, N=50, Dh=256,
// De=512) the function moves about 11.7 MB (p 3.15, e 0.82, enco 0.82, att
// 0.61, values 6.29, the mask 400 bytes): about 3.5 us at the H100's 3.35
// TB/s.  Its 236 MFLOP of products take about 1.4 us as 3xTF32 on the
// tensor cores.  So bytes bound it; but one query tile's work is a short
// chain of dependent steps (load, products, softmax, products), so what a
// block waits for is latency: L2 round trips, barriers and mma.sync chains.
//
// Design.  Grid = (ceil(Q / 16), B, S); one block of 16 warps owns 16 query
// rows of one video for both roles (the role softmax couples them) and 1 / S
// of the De columns of values.  The caller picks S from the shape: the most
// splits that keep the grid within one block an SM (exp2's 96 tiles take
// S = 1, VidOR stage A's 48 take S = 2); each of the S blocks of a tile
// recomputes the logits (a third of the products), only the first writes
// att.
//   * p's 16 rows of both roles arrive in shared memory with the e stages of
//     the first tracklet tile; e and then enco stream through one ring of
//     three cp.async stages (one barrier a step), so shared memory grows
//     with N only by the logits (128 bytes a tracklet): N up to 704 at Dh =
//     256.
//   * logits: a stage holds (2 roles, 64 tracklets, 64 of Dh); warp w
//     accumulates role w / 8, tracklets 8 (w % 8) .. + 7 of the tile in
//     registers over Dh with mma.sync m16n8k8 in 3xTF32 (float32's
//     precision; split_tf32 of composed_attn_common.cuh), then stores them
//     scaled.
//   * softmaxes: warp w takes query row w, both roles, with warp reductions
//     and exp on the special-function unit (exp2f of x log2 e, a few ulps
//     from expf); att goes to device memory and stays in shared memory.
//   * values: a stage holds KN tracklets x CW columns of enco; warp w owns
//     CW / 16 columns for both roles, so each enco fragment is split once
//     for two products.
// Operands are read through their strides (unit stride along the last
// dimension, 16-byte aligned rows): the layer passes the halves of its
// projections as views.  The mask is read as bytes (bool or uint8).

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "composed_attn_common.cuh"   // split_tf32, mma_tf32, cp.async

namespace {

constexpr int QT = 16;                  // query rows per block: one m16 tile
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int NT = 64;                  // tracklets of a logits stage
constexpr int KC = 64;                  // Dh columns of a logits stage
constexpr int LDE = KC + 4;             // = 4 mod 32: conflict-free B reads
constexpr int STAGE = 2 * NT * LDE;     // floats of one ring stage
constexpr int RING = 3;
constexpr int SMEM_LIMIT = 232448;      // opt-in shared memory of a block

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// row strides (floats) of the p tile and of the logits, = 4 mod 32
__host__ __device__ inline int ld_p(int dh) { return round_up(dh, KC) + 4; }
__host__ __device__ inline int ld_l(int n) { return round_up(n, NT) + 4; }

__host__ __device__ inline size_t smem_bytes(int n, int dh) {
  return sizeof(float) * ((size_t)RING * STAGE + 2 * QT * (size_t)ld_p(dh) +
                          2 * QT * (size_t)ld_l(n)) +
         round_up(n, 16);
}

// tracklets of a values stage whose rows are cw + 8 floats: the most that
// fit a stage, in whole k-steps of 8
__host__ __device__ constexpr int values_rows(int cw) {
  return STAGE / (cw + 8) / 8 * 8;
}

struct Params {
  const float* p;
  const float* e;
  const float* enco;
  const unsigned char* mask;
  float* att;
  float* values;
  long long sp_b, se_b, sc_b, sm_b;     // strides between videos
  int sp_r, sp_q, se_r, se_n, sc_n, sm_n;  // strides within a video
  int Q, N, Dh, De;
  int W;                                // De columns of one block
  float scale;
};

// 16 bytes global -> shared, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// c += a b in 3xTF32, b split already (shared by the two roles' products)
__device__ __forceinline__ void mma_3xtf32_b(float c[4], const uint32_t ahi[4],
                                             const uint32_t alo[4],
                                             const uint32_t bhi[2],
                                             const uint32_t blo[2]) {
  mma_tf32(c, alo, bhi[0], bhi[1]);
  mma_tf32(c, ahi, blo[0], blo[1]);
  mma_tf32(c, ahi, bhi[0], bhi[1]);
}

// A fragment (rows g, g + 8; columns tg, tg + 4) of a row-major float32
// tile at a (row stride ld), split into hi and lo
__device__ __forceinline__ void load_a(const float* a, int ld, uint32_t hi[4],
                                       uint32_t lo[4]) {
  split_tf32(a[0], hi[0], lo[0]);
  split_tf32(a[8 * ld], hi[1], lo[1]);
  split_tf32(a[4], hi[2], lo[2]);
  split_tf32(a[8 * ld + 4], hi[3], lo[3]);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// exp(x) for x <= 0 on the special-function unit: ex2.approx of x log2 e,
// within a few float32 ulps for the |x| the softmaxes meet
__device__ __forceinline__ float exp_neg(float x) {
  return exp2f(x * LOG2E);
}

// The entity softmax of both roles times their role softmax, for query row
// q of the tile (one warp, the two rows of logits interleaved): att in place
// in s_l and, when `out`, in device memory at att0 (role 0) and att0 + QN
// (role 1).
__device__ __forceinline__ void softmax_row(float* s_l, int lda, int q,
                                            const unsigned char* s_mask,
                                            int N, int lane, float* att0,
                                            bool out, size_t QN) {
  float* l0 = s_l + q * lda;
  float* l1 = s_l + (QT + q) * lda;
  float m0 = -FLT_MAX, m1 = -FLT_MAX;
  for (int n = lane; n < N; n += 32)
    if (s_mask[n]) {
      m0 = fmaxf(m0, l0[n]);
      m1 = fmaxf(m1, l1[n]);
    }
  m0 = warp_max(m0);
  m1 = warp_max(m1);
  float s0 = 0.f, s1 = 0.f;
  for (int n = lane; n < N; n += 32)
    if (s_mask[n]) {
      s0 += exp_neg(l0[n] - m0);
      s1 += exp_neg(l1[n] - m1);
    }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  // an all-masked row has s = 0 and att = 0
  const float inv0 = s0 > 0.f ? 1.f / s0 : 0.f;
  const float inv1 = s1 > 0.f ? 1.f / s1 : 0.f;
  for (int n = lane; n < N; n += 32) {
    const float x0 = l0[n], x1 = l1[n];
    // softmax over the two roles: the larger logit gets 1 / (1 + t)
    const float t = exp_neg(-fabsf(x0 - x1));
    const float big = 1.f / (1.f + t), small = t * big;
    const bool ok = s_mask[n];
    const float v0 = ok ? exp_neg(x0 - m0) * inv0 * (x0 >= x1 ? big : small)
                        : 0.f;
    const float v1 = ok ? exp_neg(x1 - m1) * inv1 * (x0 >= x1 ? small : big)
                        : 0.f;
    l0[n] = v0;
    l1[n] = v1;
    if (out) {
      att0[n] = v0;
      att0[QN + n] = v1;
    }
  }
  // padded tracklets take part in the values product: weight 0
  for (int n = N + lane; n < round_up(N, NT); n += 32) l0[n] = l1[n] = 0.f;
}

// CW: values columns of a pass, NJ groups of 8 of them a warp
template <int CW>
__global__ void __launch_bounds__(THREADS, 1)
role_attn_kernel(const Params prm) {
  constexpr int NJ = CW / 8 / WARPS;
  constexpr int KN = values_rows(CW);    // tracklets of a values stage
  constexpr int LDC = CW + 8;            // = 8 mod 32: conflict-free B reads
  constexpr int E_CHUNKS = 2 * NT * KC / 4;   // 16-byte copies a stage
  constexpr int C_CHUNKS = KN * CW / 4;
  constexpr int P_CHUNKS = 2 * QT * KC / 4;
  static_assert(KN >= 8 && E_CHUNKS % THREADS == 0 &&
                C_CHUNKS % THREADS == 0 && P_CHUNKS % THREADS == 0,
                "whole copies a thread");

  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* s_p = ring + RING * STAGE;               // [2][QT][ld_p]
  const int LDP = ld_p(prm.Dh), LDA = ld_l(prm.N);
  float* s_l = s_p + 2 * QT * LDP;                // [2][QT][ld_l]
  unsigned char* s_mask = reinterpret_cast<unsigned char*>(s_l + 2 * QT * LDA);

  const int Q = prm.Q, N = prm.N, Dh = prm.Dh, De = prm.De;
  const int q0 = blockIdx.x * QT, b = blockIdx.y;
  const int c_begin = blockIdx.z * prm.W;
  const int c_end = min(De, c_begin + prm.W);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;

  const float* pb = prm.p + b * prm.sp_b;
  const float* eb = prm.e + b * prm.se_b;
  const float* cb = prm.enco + b * prm.sc_b;

  const int k_chunks = (Dh + KC - 1) / KC;
  const int steps1 = (N + NT - 1) / NT * k_chunks;
  const int n_chunks = (N + KN - 1) / KN;
  const int passes = c_end > c_begin ? (c_end - c_begin + CW - 1) / CW : 0;
  const int steps = steps1 + passes * n_chunks;

  // stage t of the sequence (e tiles, then enco tiles) into its ring slot;
  // the e tiles of the first tracklet tile bring the p tile's columns too
  auto load_stage = [&](int t) {
    float* dst = ring + (t % RING) * STAGE;
    if (t < steps1) {
      const int n0 = t / k_chunks * NT, k0 = t % k_chunks * KC;
#pragma unroll
      for (int s = 0; s < E_CHUNKS / THREADS; ++s) {
        const int i = tid + s * THREADS;
        const int r = i / (NT * KC / 4), n = i / (KC / 4) % NT;
        const int c = i % (KC / 4) * 4;
        const bool ok = n0 + n < N && k0 + c < Dh;
        cp_async16_zfill(dst + (r * NT + n) * LDE + c,
                         eb + (ok ? r * prm.se_r + (n0 + n) * prm.se_n +
                                        k0 + c
                                  : 0),
                         ok);
      }
      if (t < k_chunks)
#pragma unroll
        for (int s = 0; s < P_CHUNKS / THREADS; ++s) {
          const int i = tid + s * THREADS;
          const int r = i / (QT * KC / 4), q = i / (KC / 4) % QT;
          const int c = i % (KC / 4) * 4;
          const bool ok = q0 + q < Q && k0 + c < Dh;
          cp_async16_zfill(s_p + (r * QT + q) * LDP + k0 + c,
                           pb + (ok ? r * prm.sp_r + (q0 + q) * prm.sp_q +
                                          k0 + c
                                    : 0),
                           ok);
        }
    } else {
      const int t3 = t - steps1;
      const int n0 = t3 % n_chunks * KN, c0 = c_begin + t3 / n_chunks * CW;
#pragma unroll
      for (int s = 0; s < C_CHUNKS / THREADS; ++s) {
        const int i = tid + s * THREADS;
        const int n = i / (CW / 4), c = i % (CW / 4) * 4;
        const bool ok = n0 + n < N && c0 + c < De;
        cp_async16_zfill(dst + n * LDC + c,
                         cb + (ok ? (n0 + n) * prm.sc_n + c0 + c : 0), ok);
      }
    }
  };

  for (int n = tid; n < N; n += THREADS)
    s_mask[n] = prm.mask[b * prm.sm_b + n * prm.sm_n];
#pragma unroll
  for (int t = 0; t < RING - 1; ++t) {
    if (t < steps) load_stage(t);
    cp_async_commit();
  }

  // wait for stage t, then start loading stage t + RING - 1 into the slot
  // that stage t - 1 freed
  auto next_stage = [&](int t) {
    cp_async_wait<RING - 2>();
    __syncthreads();  // stage t landed for all; stage t - 1 consumed
    if (t + RING - 1 < steps) load_stage(t + RING - 1);
    cp_async_commit();
    return ring + (t % RING) * STAGE;
  };

  // ---- logits: warp w takes role w / 8 and tracklets 8 (w % 8) .. + 7 of
  // each tile, in registers over Dh ------------------------------------------
  static_assert(NT == 4 * WARPS, "one n8 tile of a role for every warp");
  const int role1 = warp / (WARPS / 2), n1 = 8 * (warp % (WARPS / 2));
  int t = 0;
  for (int nt0 = 0; nt0 < N; nt0 += NT) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kc = 0; kc < k_chunks; ++kc, ++t) {
      const float* st = next_stage(t);
      if (nt0 + n1 >= N) continue;
      const float* pa = s_p + (role1 * QT + g) * LDP + kc * KC + tg;
      const float* pe = st + (role1 * NT + n1 + g) * LDE + tg;
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        uint32_t hi[4], lo[4], bh[2], bl[2];
        load_a(pa + 8 * kk, LDP, hi, lo);
        split_tf32(pe[8 * kk], bh[0], bl[0]);
        split_tf32(pe[8 * kk + 4], bh[1], bl[1]);
        mma_3xtf32_b(acc, hi, lo, bh, bl);
      }
    }
    if (nt0 + n1 < N) {
      float* l = s_l + (role1 * QT + g) * LDA + nt0 + n1 + 2 * tg;
      l[0] = acc[0] * prm.scale;
      l[1] = acc[1] * prm.scale;
      l[8 * LDA] = acc[2] * prm.scale;
      l[8 * LDA + 1] = acc[3] * prm.scale;
    }
  }
  __syncthreads();  // every logit stored

  // ---- entity softmax x role softmax, query row `warp` of the tile -------
  static_assert(WARPS == QT, "one query row a warp");
  softmax_row(s_l, LDA, warp, s_mask, N, lane,
              prm.att + ((size_t)(b * 2) * Q + q0 + warp) * N,
              blockIdx.z == 0 && q0 + warp < Q, (size_t)Q * N);

  // ---- values: both roles, columns c0 .. c0 + 8 NJ - 1 of each pass -------
  for (int c0 = c_begin + 8 * NJ * warp; c0 - 8 * NJ * warp < c_end;
       c0 += CW) {
    float acc[2][NJ][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][j][i] = 0.f;
    for (int nc = 0; nc < n_chunks; ++nc, ++t) {
      const float* st = next_stage(t);  // the first also sees att complete
#pragma unroll
      for (int kk = 0; kk < KN / 8; ++kk) {
        const int n0 = nc * KN + 8 * kk;
        if (n0 >= N) break;
        uint32_t hi[2][4], lo[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          load_a(s_l + (r * QT + g) * LDA + n0 + tg, LDA, hi[r], lo[r]);
        const float* pc = st + (8 * kk + tg) * LDC + 8 * NJ * warp + g;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (c0 + 8 * j >= c_end) break;
          uint32_t bh[2], bl[2];
          split_tf32(pc[8 * j], bh[0], bl[0]);
          split_tf32(pc[4 * LDC + 8 * j], bh[1], bl[1]);
          mma_3xtf32_b(acc[0][j], hi[0], lo[0], bh, bl);
          mma_3xtf32_b(acc[1][j], hi[1], lo[1], bh, bl);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + 8 * j + 2 * tg;
        if (c >= c_end) continue;
        float* v = prm.values + ((size_t)(b * 2 + r) * Q + q0 + g) * De + c;
        if (q0 + g < Q)
          *reinterpret_cast<float2*>(v) =
              make_float2(acc[r][j][0], acc[r][j][1]);
        if (q0 + g + 8 < Q)
          *reinterpret_cast<float2*>(v + 8 * (size_t)De) =
              make_float2(acc[r][j][2], acc[r][j][3]);
      }
  }
  cp_async_wait<0>();
}

// launches the instance whose passes are CW columns wide
template <int CW>
int launch(const Params& prm, dim3 grid, size_t smem, cudaStream_t stream) {
  // opt in to the shared memory once per (device, size), not every launch
  static int opted[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if ((int)smem > opted[dev]) {
    err = cudaFuncSetAttribute(role_attn_kernel<CW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the error is not reported again later
      return (int)err;
    }
    opted[dev] = (int)smem;
  }
  role_attn_kernel<CW><<<grid, THREADS, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for N tracklets and width
// Dh, and the most the card lets a block opt in to.
long long role_attn_smem_bytes(int n, int dh) {
  return (long long)smem_bytes(n, dh);
}

long long role_attn_smem_limit() { return SMEM_LIMIT; }

// Launches the kernel on `stream`; returns 0 when launched, else a CUDA
// error code (cudaErrorInvalidValue for a shape the kernel does not take:
// an empty B, Q, N or Dh, Dh or De not a multiple of 4, or shared memory
// past the limit).
// p (B,2,Q,Dh), e (B,2,N,Dh), enco (B,N,De) float32 with unit stride along
// the last dimension, other strides (in elements) multiples of 4, one
// video's elements within 2^31 of its first, and 16-byte aligned pointers;
// mask (B,N) one byte an entry (bool or uint8), any strides; att (B,2,Q,N)
// and values (B,2,Q,De) contiguous float32 outputs.  `splits` blocks share
// the De columns of a query tile.
int role_attn_launch(const float* p, const float* e, const float* enco,
                     const unsigned char* mask, float* att, float* values,
                     int B, int Q, int N, int Dh, int De, long long sp_b,
                     long long sp_r, long long sp_q, long long se_b,
                     long long se_r, long long se_n, long long sc_b,
                     long long sc_n, long long sm_b, long long sm_n,
                     float scale, int splits, void* stream) {
  const size_t smem = smem_bytes(N, Dh);
  if (B <= 0 || Q <= 0 || N <= 0 || Dh <= 0 || Dh % 4 || De % 4 ||
      splits <= 0 || smem > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  Params prm{p,          e,          enco,       mask,       att,
             values,     sp_b,       se_b,       sc_b,       sm_b,
             (int)sp_r,  (int)sp_q,  (int)se_r,  (int)se_n,  (int)sc_n,
             (int)sm_n,  Q,          N,          Dh,         De,
             0,          scale};
  prm.W = round_up((De + splits - 1) / splits, 8);
  const dim3 grid((Q + QT - 1) / QT, B, splits);
  const cudaStream_t s = (cudaStream_t)stream;
  if (prm.W > 256) return launch<512>(prm, grid, smem, s);
  if (prm.W > 128) return launch<256>(prm, grid, smem, s);
  return launch<128>(prm, grid, smem, s);
}

const char* role_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

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
// Forward only, float32 throughout, expf (not __expf).
//
// Design.  Grid = (B, ceil(Q / QT)); one block of 256 threads owns QT = 32
// query rows of one video for both roles, so no intermediate leaves the SM:
//   1. loop over Dh in chunks of DC: stage the p chunk (2, QT, DC) and the e
//      chunk (2, N, DC) in shared memory (rows padded to DC + 1 floats, so
//      the per-thread dot products read without bank conflicts) and
//      accumulate the (2, QT, N) logits in shared memory;
//   2. one warp per query row: masked entity softmax for both roles with
//      warp reductions, the role softmax, the product; att goes to device
//      memory and stays in shared memory;
//   3. loop over De in chunks of EC: stage enco (N, EC) in shared memory and
//      write values, neighbouring threads on neighbouring columns.
// N is arbitrary (exp2 has 50, no multiple of 8 or 32).  Shared memory grows
// with N (about 0.5 KB per tracklet); above 48 KB it is opted in with
// cudaFuncSetAttribute, which covers N up to about 420 on Hopper's 227 KB.
//
// Bound on the card.  At the exp2 decoder shape (B=8, Q=192, N=50, Dh=256,
// De=512) the kernel must move about 11.7 MB (p 3.15, e 0.82, enco 0.82,
// att 0.61, values 6.29) and do about 236 MFLOP of products
// (role_attention_flops in pallas_role_attn.py:55-60): about 3.5 us at the
// H100's 3.35 TB/s and about 3.5 us at its 67 TFLOP/s float32 CUDA-core
// rate.  This first version runs on CUDA cores from shared memory and is
// far from that bound: 48 blocks do not fill 132 SMs, and tensor cores
// (TF32 or bf16 wgmma) are not used.  Both are later work.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 32;        // query rows per block
constexpr int DC = 32;        // Dh chunk staged per pass
constexpr int EC = 64;        // De chunk staged per pass
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// floats of dynamic shared memory for N tracklets
__host__ __device__ inline size_t smem_floats(int n) {
  const size_t logits = 2 * QT * (size_t)n;
  const size_t mask = (size_t)n;
  const size_t stage_pe = 2 * QT * (size_t)(DC + 1) + 2 * (size_t)n * (DC + 1);
  const size_t stage_enco = (size_t)n * EC;
  return logits + mask + (stage_pe > stage_enco ? stage_pe : stage_enco);
}

__global__ void __launch_bounds__(THREADS)
role_attn_kernel(const float* __restrict__ p, const float* __restrict__ e,
                 const float* __restrict__ enco, const int* __restrict__ mask,
                 float* __restrict__ att, float* __restrict__ values,
                 int Q, int N, int Dh, int De, float scale) {
  extern __shared__ float smem[];
  float* s_l = smem;                                   // [2][QT][N]
  int* s_mask = reinterpret_cast<int*>(s_l + 2 * QT * N);  // [N]
  float* s_stage = reinterpret_cast<float*>(s_mask + N);
  float* s_p = s_stage;                                // [2][QT][DC+1]
  float* s_e = s_stage + 2 * QT * (DC + 1);            // [2][N][DC+1]
  float* s_c = s_stage;                                // [N][EC] (phase 3)

  const int b = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int qn = min(QT, Q - q0);
  const int tid = threadIdx.x;
  const int n_logits = 2 * QT * N;

  for (int i = tid; i < n_logits; i += THREADS) s_l[i] = 0.f;
  for (int i = tid; i < N; i += THREADS) s_mask[i] = mask[(size_t)b * N + i];

  // ---- 1. logits ----------------------------------------------------------
  const float* pb = p + (size_t)b * 2 * Q * Dh;
  const float* eb = e + (size_t)b * 2 * N * Dh;
  for (int k0 = 0; k0 < Dh; k0 += DC) {
    const int kc = min(DC, Dh - k0);
    __syncthreads();  // previous chunk consumed; s_l zeroed on the first pass
    for (int i = tid; i < 2 * QT * DC; i += THREADS) {
      const int r = i / (QT * DC), q = (i / DC) % QT, k = i % DC;
      float v = 0.f;
      if (q < qn && k < kc) v = pb[((size_t)r * Q + q0 + q) * Dh + k0 + k];
      s_p[(r * QT + q) * (DC + 1) + k] = v;
    }
    for (int i = tid; i < 2 * N * DC; i += THREADS) {
      const int r = i / (N * DC), n = (i / DC) % N, k = i % DC;
      float v = 0.f;
      if (k < kc) v = eb[((size_t)r * N + n) * Dh + k0 + k];
      s_e[(r * N + n) * (DC + 1) + k] = v;
    }
    __syncthreads();
    for (int i = tid; i < n_logits; i += THREADS) {
      const int r = i / (QT * N), q = (i / N) % QT, n = i % N;
      const float* pr = s_p + (r * QT + q) * (DC + 1);
      const float* er = s_e + (r * N + n) * (DC + 1);
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < DC; ++k) acc = fmaf(pr[k], er[k], acc);
      s_l[i] += acc;
    }
  }
  __syncthreads();

  // ---- 2. entity softmax x role softmax, one warp per query row -----------
  const int warp = tid / 32, lane = tid % 32;
  float* ab = att + (size_t)b * 2 * Q * N;
  for (int q = warp; q < qn; q += WARPS) {
    float* l0 = s_l + q * N;
    float* l1 = s_l + (QT + q) * N;
    float m0 = -FLT_MAX, m1 = -FLT_MAX;
    for (int n = lane; n < N; n += 32) {
      const bool ok = s_mask[n] != 0;
      m0 = fmaxf(m0, ok ? l0[n] * scale : -FLT_MAX);
      m1 = fmaxf(m1, ok ? l1[n] * scale : -FLT_MAX);
    }
    m0 = warp_max(m0);
    m1 = warp_max(m1);
    float s0 = 0.f, s1 = 0.f;
    for (int n = lane; n < N; n += 32) {
      const bool ok = s_mask[n] != 0;
      s0 += expf((ok ? l0[n] * scale : -FLT_MAX) - m0);
      s1 += expf((ok ? l1[n] * scale : -FLT_MAX) - m1);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    for (int n = lane; n < N; n += 32) {
      const bool ok = s_mask[n] != 0;
      const float x0 = l0[n] * scale, x1 = l1[n] * scale;
      const float en0 = ok ? expf(x0 - m0) / s0 : 0.f;
      const float en1 = ok ? expf(x1 - m1) / s1 : 0.f;
      const float rm = fmaxf(x0, x1);
      const float r0 = expf(x0 - rm), r1 = expf(x1 - rm);
      const float rs = r0 + r1;
      const float a0 = en0 * (r0 / rs), a1 = en1 * (r1 / rs);
      l0[n] = a0;
      l1[n] = a1;
      ab[((size_t)q0 + q) * N + n] = a0;
      ab[((size_t)Q + q0 + q) * N + n] = a1;
    }
  }

  // ---- 3. values = att @ enco ----------------------------------------------
  const float* cb = enco + (size_t)b * N * De;
  float* vb = values + (size_t)b * 2 * Q * De;
  for (int d0 = 0; d0 < De; d0 += EC) {
    const int dc = min(EC, De - d0);
    __syncthreads();  // att complete in s_l; previous enco chunk consumed
    for (int i = tid; i < N * EC; i += THREADS) {
      const int n = i / EC, d = i % EC;
      s_c[i] = d < dc ? cb[(size_t)n * De + d0 + d] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < 2 * QT * EC; i += THREADS) {
      const int r = i / (QT * EC), q = (i / EC) % QT, d = i % EC;
      if (q >= qn || d >= dc) continue;
      const float* ar = s_l + (r * QT + q) * N;
      float acc = 0.f;
      for (int n = 0; n < N; ++n) acc = fmaf(ar[n], s_c[n * EC + d], acc);
      vb[((size_t)r * Q + q0 + q) * De + d0 + d] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for N tracklets.
long long role_attn_smem_bytes(int n) {
  return (long long)(smem_floats(n) * sizeof(float));
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// p (B,2,Q,Dh), e (B,2,N,Dh), enco (B,N,De) float32 and mask (B,N) int32,
// all contiguous; att (B,2,Q,N) and values (B,2,Q,De) float32 outputs.
int role_attn_forward(const float* p, const float* e, const float* enco,
                      const int* mask, float* att, float* values, int B,
                      int Q, int N, int Dh, int De, float scale,
                      void* stream) {
  const size_t smem = smem_floats(N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      role_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // reset, so the error is not reported again later
    return (int)err;
  }
  const dim3 grid(B, (Q + QT - 1) / QT);
  role_attn_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      p, e, enco, mask, att, values, Q, N, Dh, De, scale);
  return (int)cudaGetLastError();
}

const char* role_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

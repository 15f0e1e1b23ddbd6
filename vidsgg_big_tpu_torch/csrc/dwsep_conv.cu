// Depthwise-separable 1-D conv over time, channels last, float32 inference,
// for Hopper (sm_90a), with a plain C interface bound through ctypes
// (vidsgg_big_tpu_torch/ops/dwsep_conv.py).
//
// For x (R, T, C = 128) float32 contiguous, a depthwise kernel dw (C, k) of
// odd k <= 7 with bias db (C), and a pointwise kernel pw (Co, C), Co <= 128,
// with bias pb (Co):
//
//   d[r, t, c] = sum_j dw[c, j] x[r, t + j - k / 2, c] + db[c]
//                (a tap outside [0, T) reads zero, as padding = k / 2)
//   y[r, t, o] = epi(sum_c pw[o, c] d[r, t, c] + pb[o])
//
// where epi is, in order and each optional: ReLU, + residual[r, t, o], then
// zero where mask[r, t] is false.
//
// It replaces no TPU kernel: the JAX package leaves these convs to XLA.  It
// was added because the grounding model (models/grounding.py) runs 27 such
// convs a forward on (R, T, C) = (1024, 512, 128) in stage-B serving, and
// ATen ran each as a transpose to (R, C, T), a depthwise and a pointwise
// conv, a transpose back, and the callers' ReLU, residual and mask as
// separate passes over strided views: about 45 ms of a 101 ms request.
//
// Bound on the card: bytes.  At (R, T) = (1024, 512) a call reads x (256
// MiB) and writes y (256 MiB): 0.160 ms at 3.35 TB/s, 0.240 ms with a
// residual.  Its 17.6 GFLOP take 0.107 ms as 3xTF32 at 165 TFLOP/s.
//
// Design.  Positions (r, t) are flattened; a tile is 64 consecutive
// positions, and a tap respects the row boundaries it crosses.  One
// persistent block an SM holds two groups of 8 warps; each group walks its
// own tiles through its own stage of shared memory, with its own barriers,
// so that one group's loads, depthwise taps and epilogue run while the
// other's products keep the tensor cores busy:
//   * the pointwise weights are split into TF32 hi and lo once per block and
//     stay in shared memory in the order of mma.sync's B fragments (one
//     16-byte read a fragment: hi and lo of both values; 128 KB at Co = 128),
//     shared by the two groups;
//   * a group loads a tile's 64 + k - 1 rows of x with cp.async as soon as
//     its products have read the last tile, so the load overlaps its
//     epilogue and the other group's work;
//   * depthwise, f32 FMA: thread tid owns channel tid % 128 and a run of 32
//     positions, slides its k taps along the run (each x value read once
//     from shared memory) and keeps the 32 sums in registers; they then
//     overwrite the tile's x rows in shared memory, so the depthwise result
//     never reaches device memory;
//   * pointwise: warp w owns 32 positions (two m16 tiles) and NJ n8 tiles
//     of the output; mma.sync m16n8k8 in 3xTF32 (split_tf32 of
//     composed_attn_common.cuh) with the depthwise sums as A.  The tensor
//     cores round each product's float32 sum toward zero, so a running
//     sum carried through all 48 products of an output drifts (mean error
//     -6.8e-7 at the grounding cell's values, against cuDNN's -1.3e-9);
//     each pair of k steps therefore sums into a fresh accumulator that a
//     float32 add, rounded to nearest, carries into the running sum: mean
//     |error| 1.4e-7, largest 4.5e-6, against cuDNN's float32 conv's
//     1.7e-7 and 1.1e-5;
//   * epilogue in registers: bias, ReLU, the residual, the mask (every
//     residual value and mask byte read before the first store, so that
//     the reads wait for device memory once); y is written from the
//     accumulators, each 32-byte sector whole, with no transpose.
// Measured on an H100 (PERF.md): 0.48 ms at k = 7 with a residual, 0.39 ms
// at k = 3 without, against the ATen route's 3.4 and 2.8 ms.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "composed_attn_common.cuh"   // split_tf32, mma_tf32, cp.async

namespace {

constexpr int CIN = 128;                  // input channels
constexpr int TILE = 64;                  // positions of a tile
constexpr int WARPS = 8;                  // of a group
constexpr int THREADS = 32 * WARPS;       // of a group
constexpr int GROUPS = 2;                 // of a block
constexpr int LDX = CIN + 4;              // = 4 mod 32: conflict-free A reads
constexpr int KSTEPS = CIN / 8;           // k8 steps of the pointwise product
constexpr int RUN = TILE * CIN / THREADS; // positions of a depthwise run: 32
constexpr int COL_GROUPS = 4;             // warps side by side over Co

static_assert(RUN == 32 && TILE == 32 * (WARPS / COL_GROUPS),
              "a warp owns two m16 tiles; a thread's run is 32 positions");

__host__ __device__ constexpr int stage_floats(int halo) {
  return (TILE + 2 * halo) * LDX;
}

// n8 tiles of the output a warp owns: the four column groups cover 32 NJ
// output channels
__host__ __device__ inline int nj_for(int co) {
  return co <= 32 ? 1 : co <= 64 ? 2 : 4;
}

__host__ __device__ inline size_t smem_bytes(int nj, int halo) {
  return sizeof(float) * (GROUPS * (size_t)stage_floats(halo) +
                          (size_t)COL_GROUPS * nj * KSTEPS * 32 * 4);
}

struct Params {
  const float* x;
  const float* dw;
  const float* db;
  const float* pw;
  const float* pb;
  const float* res;                  // null: no residual
  const unsigned char* mask;         // null: every position valid
  float* y;
  long long P;                       // positions, R T
  int T, Co, relu, tiles;
};

// 16 bytes global -> shared, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// a barrier of the THREADS threads of group `grp`
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(THREADS)
               : "memory");
}

// rows p0 - HALO .. p0 + TILE + HALO - 1 of x into a stage, zeros outside
// [0, P)
template <int HALO>
__device__ __forceinline__ void load_tile(float* st, const float* x,
                                          long long p0, long long P,
                                          int tid) {
  constexpr int VEC = CIN / 4;
  for (int i = tid; i < (TILE + 2 * HALO) * VEC; i += THREADS) {
    const int row = i / VEC, v = i % VEC;
    const long long p = p0 - HALO + row;
    const bool ok = p >= 0 && p < P;
    cp_async16_zfill(st + row * LDX + 4 * v, x + (ok ? p : 0) * CIN + 4 * v,
                     ok);
  }
}

// The depthwise sums d[i] of positions p_first + i (i < RUN) in channel c,
// from stage rows r0 .. r0 + RUN + 2 HALO - 1 (stage row s holds position
// p_first - HALO + s - r0).  Taps are added in order, after the bias; one
// that leaves its position's row (t + j - HALO outside [0, T)) is skipped.
template <int HALO>
__device__ __forceinline__ void depthwise(const float* st, int r0, int c,
                                          const float (&w)[2 * HALO + 1],
                                          float bias, long long p_first,
                                          int T, float (&d)[RUN]) {
  constexpr int K = 2 * HALO + 1;
#pragma unroll
  for (int i = 0; i < RUN; ++i) d[i] = bias;
  const int t0 = (int)(p_first % T);
  if (t0 >= HALO && t0 + RUN - 1 + HALO < T) {   // no boundary within reach
#pragma unroll
    for (int s = 0; s < RUN + 2 * HALO; ++s) {
      const float v = st[(r0 + s) * LDX + c];
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (s - j >= 0 && s - j < RUN) d[s - j] = fmaf(w[j], v, d[s - j]);
    }
    return;
  }
  int t[RUN];
#pragma unroll
  for (int i = 0, tc = t0; i < RUN; ++i, tc = tc + 1 == T ? 0 : tc + 1)
    t[i] = tc;
#pragma unroll
  for (int s = 0; s < RUN + 2 * HALO; ++s) {
    const float v = st[(r0 + s) * LDX + c];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (s - j >= 0 && s - j < RUN &&
          (unsigned)(t[s - j] + j - HALO) < (unsigned)T)
        d[s - j] = fmaf(w[j], v, d[s - j]);
  }
}

template <int NJ, int HALO>
__global__ void __launch_bounds__(GROUPS * THREADS, 1)
    dwsep_conv_kernel(const Params prm) {
  constexpr int K = 2 * HALO + 1;
  constexpr int STAGE = stage_floats(HALO);
  extern __shared__ __align__(16) float smem[];
  float4* bfrag = reinterpret_cast<float4*>(smem + GROUPS * STAGE);
  const int grp = threadIdx.x / THREADS, tid = threadIdx.x % THREADS;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  float* st = smem + grp * STAGE;
  const int stride = GROUPS * gridDim.x;
  int tile = GROUPS * blockIdx.x + grp;

  if (tile < prm.tiles)
    load_tile<HALO>(st, prm.x, (long long)tile * TILE, prm.P, tid);
  cp_async_commit();

  // the pointwise weights as B fragments [n8 tile][k step][lane]: {hi of
  // (k = tg, n = g), hi of (k = tg + 4, n = g), lo of both}; columns past
  // Co are zero
  for (int i = threadIdx.x; i < COL_GROUPS * NJ * KSTEPS * 32;
       i += GROUPS * THREADS) {
    const int l = i & 31, kk = (i >> 5) % KSTEPS, nt = i / (32 * KSTEPS);
    const int o = 8 * nt + (l >> 2), c0 = 8 * kk + (l & 3);
    const float v0 = o < prm.Co ? prm.pw[o * CIN + c0] : 0.f;
    const float v1 = o < prm.Co ? prm.pw[o * CIN + c0 + 4] : 0.f;
    uint32_t h0, l0, h1, l1;
    split_tf32(v0, h0, l0);
    split_tf32(v1, h1, l1);
    bfrag[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                           __uint_as_float(l0), __uint_as_float(l1));
  }
  __syncthreads();

  // the depthwise run of this thread: channel c, tile rows r0 .. r0 + 31
  const int c = tid % CIN, r0 = tid / CIN * RUN;
  float w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = prm.dw[c * K + j];
  const float dbias = prm.db[c];

  // this warp's outputs: tile rows 32 wr .. + 31, n8 tiles NJ wc .. + NJ - 1
  const int wr = warp / COL_GROUPS, wc = warp % COL_GROUPS;
  bool on[NJ];
  float pbias[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * (wc * NJ + j) + 2 * tg;
    on[j] = 8 * (wc * NJ + j) < prm.Co;      // the same in the whole warp
    pbias[j][0] = col < prm.Co ? prm.pb[col] : 0.f;
    pbias[j][1] = col + 1 < prm.Co ? prm.pb[col + 1] : 0.f;
  }
  const bool pairs = prm.Co % 2 == 0;        // float2 access to y, res

  for (; tile < prm.tiles; tile += stride) {
    const long long p0 = (long long)tile * TILE;
    cp_async_wait<0>();
    group_sync(grp);   // the tile landed

    float d[RUN];
    depthwise<HALO>(st, r0, c, w, dbias, p0 + r0, prm.T, d);
    group_sync(grp);   // every tap read
#pragma unroll
    for (int i = 0; i < RUN; ++i) st[(r0 + i) * LDX + c] = d[i];
    group_sync(grp);

    float acc[2][NJ][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < KSTEPS; k2 += 2) {
      uint32_t ahi[2][2][4], alo[2][2][4];   // [step of the pair][mi]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* a =
              st + (32 * wr + 16 * mi + g) * LDX + 8 * (k2 + h) + tg;
          split_tf32(a[0], ahi[h][mi][0], alo[h][mi][0]);
          split_tf32(a[8 * LDX], ahi[h][mi][1], alo[h][mi][1]);
          split_tf32(a[4], ahi[h][mi][2], alo[h][mi][2]);
          split_tf32(a[8 * LDX + 4], ahi[h][mi][3], alo[h][mi][3]);
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (!on[j]) continue;
        float4 b[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[h] = bfrag[((wc * NJ + j) * KSTEPS + k2 + h) * 32 + lane];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {   // small terms first
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t bh0 = __float_as_uint(b[h].x);
            const uint32_t bh1 = __float_as_uint(b[h].y);
            const uint32_t bl0 = __float_as_uint(b[h].z);
            const uint32_t bl1 = __float_as_uint(b[h].w);
            mma_tf32(t, alo[h][mi], bh0, bh1);
            mma_tf32(t, ahi[h][mi], bl0, bl1);
            mma_tf32(t, ahi[h][mi], bh0, bh1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] += t[e];
        }
      }
    }
    group_sync(grp);   // every product read its operands
    const int next = tile + stride;
    if (next < prm.tiles)
      load_tile<HALO>(st, prm.x, (long long)next * TILE, prm.P, tid);
    cp_async_commit();

    // epilogue; e = 2 h + b: row g + 8 h, column 2 tg + b
    bool keep[2][2];
    float res[2][NJ][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + 32 * wr + 16 * mi + 8 * h + g;
        keep[mi][h] = p < prm.P && (prm.mask == nullptr || prm.mask[p]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = 8 * (wc * NJ + j) + 2 * tg;
          float* r = &res[mi][j][2 * h];
          r[0] = r[1] = 0.f;
          if (prm.res == nullptr || !on[j] || p >= prm.P) continue;
          const float* src = prm.res + p * prm.Co + col;
          if (pairs && col < prm.Co) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(src));
            r[0] = v.x;
            r[1] = v.y;
          } else {
            if (col < prm.Co) r[0] = __ldg(src);
            if (col + 1 < prm.Co) r[1] = __ldg(src + 1);
          }
        }
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + 32 * wr + 16 * mi + 8 * h + g;
        if (p >= prm.P) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (!on[j]) continue;
          const int col = 8 * (wc * NJ + j) + 2 * tg;
          float v[2];
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            float u = acc[mi][j][2 * h + b] + pbias[j][b];
            if (prm.relu) u = u < 0.f ? 0.f : u;   // NaN stays NaN
            u += res[mi][j][2 * h + b];
            v[b] = keep[mi][h] ? u : 0.f;
          }
          float* dst = prm.y + p * prm.Co + col;
          if (pairs && col < prm.Co) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            if (col < prm.Co) dst[0] = v[0];
            if (col + 1 < prm.Co) dst[1] = v[1];
          }
        }
      }
  }
  cp_async_wait<0>();
}

// launches the instance on enough persistent blocks to fill the card
template <int NJ, int HALO>
int launch(const Params& prm, cudaStream_t stream) {
  // the grid that fills the card, once per device
  static int blocks[64] = {0};
  const size_t smem = smem_bytes(NJ, HALO);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (blocks[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(dwsep_conv_kernel<NJ, HALO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dwsep_conv_kernel<NJ, HALO>, GROUPS * THREADS, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reset, so the error is not reported again later
      return (int)err;
    }
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
    blocks[dev] = per_sm * sms;
  }
  const int pairs = (prm.tiles + GROUPS - 1) / GROUPS;
  const int grid = pairs < blocks[dev] ? pairs : blocks[dev];
  dwsep_conv_kernel<NJ, HALO><<<grid, GROUPS * THREADS, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <int NJ>
int launch_k(const Params& prm, int k, cudaStream_t stream) {
  switch (k / 2) {
    case 0: return launch<NJ, 0>(prm, stream);
    case 1: return launch<NJ, 1>(prm, stream);
    case 2: return launch<NJ, 2>(prm, stream);
    default: return launch<NJ, 3>(prm, stream);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes for Co output channels
// and kernel size k.
long long dwsep_conv_smem_bytes(int co, int k) {
  return (long long)smem_bytes(nj_for(co), k / 2);
}

// Launches the kernel on `stream`; returns 0 when launched, else a CUDA
// error code (cudaErrorInvalidValue for a shape the kernel does not take:
// C other than 128, Co outside [1, 128], k even or outside [1, 7], an
// empty R or T).
// x (R, T, C) float32 contiguous and 16-byte aligned; dw (C, k), db (C),
// pw (Co, C), pb (Co) float32 contiguous; res (R, T, Co) float32
// contiguous and 8-byte aligned, or null; mask (R, T) one byte a position
// (bool or uint8) contiguous, or null; y (R, T, Co) float32 contiguous,
// 8-byte aligned.  relu != 0 applies ReLU before the residual.
int dwsep_conv_launch(const float* x, const float* dw, const float* db,
                      const float* pw, const float* pb, const float* res,
                      const unsigned char* mask, float* y, long long R,
                      int T, int C, int Co, int k, int relu, void* stream) {
  if (R <= 0 || T <= 0 || C != CIN || Co < 1 || Co > CIN || k < 1 ||
      k > 7 || k % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const long long P = R * T, tiles = (P + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Params prm{x, dw, db, pw, pb, res, mask, y, P, T, Co, relu,
                   (int)tiles};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nj_for(Co)) {
    case 1: return launch_k<1>(prm, k, s);
    case 2: return launch_k<2>(prm, k, s);
    default: return launch_k<4>(prm, k, s);
  }
}

const char* dwsep_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

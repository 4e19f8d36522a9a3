// flash_attention: blocked online-softmax attention (causal, sliding
// window, GQA, end-aligned Sq != Sk), for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas in
// src/repro/kernels/flash_attention.py; holds against the JAX oracle
// ref.attention and the plain PyTorch version flash_attention_plain
// (src/repro_torch/kernels/flash_attention.py).  q [B, Hq, Sq, D], k and v
// [B, Hkv, Sk, D], one dtype (float32 or bfloat16); out in that dtype.
// Query head h reads kv head h / (Hq / Hkv).  Row i sits at position
// i + sk_valid - sq_valid; key j is visible when j < sk_valid, j <= pos
// (causal) and j > pos - window (window).  Scores q.k * scale, softmax
// and the weighted sum of v all in float32; a row that sees no key gives
// 0, as the Pallas kernel.
//
// Bound on this card: operations.  At recurrentgemma-9b's prefill (B 4,
// Hq 16, Hkv 1, S 3,072, D 256, window 2,048, bfloat16) the 269 M visible
// (q, k) pairs need 4 D flops each, 275 GFLOP, 0.28 ms at the tensor
// cores' 989 TFLOP/s; the bytes (q, k, v read once, out written once,
// 213 MB) take 0.064 ms.
//
// lse (optional, NULL when serving): the float32 log-sum-exp of each
// row's scaled scores, [B, Hq, Sq], from the running max and sum that
// both kernels keep (-inf for a row that sees no key); the backward
// (flash_attention_bwd.cu) recomputes P = exp(s - lse) from it.
//
// Two kernels, chosen by dtype:
//
// bfloat16 (the served dtype): the tensor cores through wgmma (sm_90a).
// One block of two warpgroups per (b, h) and 128 query rows, each
// warpgroup owning 64 rows.  Q is loaded into shared memory once; K and V
// tiles of 64 keys go through a two-stage ring filled by cp.async (the
// next tile's loads run under this tile's products), every tile stored
// as 128-byte column chunks with the 128-byte swizzle that wgmma's shared
// memory descriptors read: 192 KB at D = 256 (Q 64 KB, 2 x (K + V) 128
// KB).  S = Q.K^T is D / 16 wgmma m64n64k16 with both operands in shared
// memory, its 64 x 64 accumulator in registers; the online softmax runs
// there in float32, row max and sum reduced over the 4 lanes that hold a
// row.  P.V is wgmma m64nDk16 with P from registers (the accumulator's
// layout is the A fragments' for 16-bit A) and V transposed from shared
// memory; the 64 x D output accumulator (128 registers a thread at D =
// 256) stays in registers across the key loop.  Key tiles outside the
// causal band or the window are skipped whole, per block, and per
// warpgroup where none of its 64 rows sees the tile; the per-element
// mask runs only on tiles that straddle an edge.  P in bf16: q.k
// products of bf16 values are exact in float32, but P is not a bf16
// value, and rounding it costs up to 2^-9 of each term, which breaks the
// 2-ulp gate against the float32 plain version on outputs near 0.  So P
// is split into hi = bf16(P) and lo = bf16(P - hi) and both go through
// the tensor cores (1.5x the products of Q.K^T + P.V; about 2^-17 of
// each term).  Blocks are issued longest first (the
// causal band grows with the row), and consecutive blocks are heads of
// one batch row, which share a kv head under GQA, so K and V come from
// L2.  Head widths 16 and 32 are padded to 64 in shared memory.  What it
// leaves: the two warpgroups run in step (two barriers a tile), so the
// tensor cores idle through the softmax.  Ping-pong scheduling of the two
// warpgroups needs registers this kernel has not got at D = 256 (o, s and
// P live across phases; ptxas then serializes the wgmma); a producer warp
// with TMA and setmaxnreg, as FlashAttention-3, frees them.
//
// float32 (the smoke models, and the gate at rtol 1e-5, which TF32 would
// not hold): scalar float32 FMAs.  One block of 256 threads per (b, h)
// and 64 query rows, the rows in shared memory; the block walks 64-key
// tiles from the first that the window reaches to the last that the
// causal band reaches, each tile in shared memory (K transposed), so
// D = 256 takes 210 KB of dynamic shared memory and one block an SM.
// Thread (ty, tx) computes the scores of rows ty + 16i and keys tx + 16j
// (i, j < 4), the row's max and sum reduced over the 16 lanes of the row
// with shuffles, and keeps running max, sum and the output rows ty + 16i,
// columns tx + 16c, in registers.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "lm_dtype.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + D * (kBK + 1) + kBK * D
                          + kBQ * (kBK + 1));
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename X, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const X* __restrict__ q, const X* __restrict__ k,
             const X* __restrict__ v, X* __restrict__ out,
             float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
             int causal, int has_window, int window, float scale, int delta,
             int sk_valid) {
  constexpr int QS = D + 1;     // padded row strides: conflict-free reads
  constexpr int KS = kBK + 1;
  constexpr int NC = D / 16;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Kt = Qs + kBQ * QS;    // [D][kBK + 1], K transposed
  float* Vs = Kt + D * KS;      // [kBK][D]
  float* Ps = Vs + kBK * D;     // [kBQ][kBK + 1]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = blockIdx.x;
  const long long b = bh / Hq, h = bh % Hq;
  const long long kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const X* qb = q + bh * Sq * D;
  const X* kb = k + kvh * Sk * D;
  const X* vb = v + kvh * Sk * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    Qs[r * QS + c] =
        q0 + r < Sq ? lm::load(qb + (long long)(q0 + r) * D + c) : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // Keys any row of this block can see.
  const int rows = min(kBQ, Sq - q0);
  int k_end = sk_valid;
  if (causal) k_end = min(k_end, q0 + rows - 1 + delta + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q0 + delta - window + 1);

  for (int k0 = k_begin / kBK * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int gk = k0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (gk < Sk) {
        kv = lm::load(kb + (long long)gk * D + d);
        vv = lm::load(vb + (long long)gk * D + d);
      }
      Kt[d * KS + c] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + delta;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < sk_valid && (!causal || kp <= qpos)
                && (!has_window || kp > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(ty + 16 * i) * KS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * KS + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float vv = Vs[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
      X* o = out + (bh * Sq + row) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        lm::store(o + tx + 16 * c, acc[i][c] / denom);
      }
      if (lse != nullptr && tx == 0) {
        lse[bh * Sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : -CUDART_INF_F;
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
               int has_window, int window, float scale, int delta,
               int sk_valid, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_kernel<float, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Hq, Hkv,
      Sq, Sk, causal, has_window, window, scale, delta, sk_valid);
  return (int)cudaGetLastError();
}

// ------------------------------------------ bfloat16: warpgroup products
namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kGroups = 2;                // consumer warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr int kBQ = 64 * kGroups;         // 64 query rows a warpgroup
constexpr int kBK = 64;                   // keys a tile

// Q, 2 x (K + V), and 1 KB to align the tiles to the swizzle's period.
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)(kBQ + 4 * kBK) * kPadded<D> * sizeof(bf16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator layout of m64nNk16 (PTX ISA): warp w of the warpgroup holds
// rows 16 w + g and 16 w + g + 8 (lane = 4 g + t), d[4 j + e] at column
// 8 j + 2 t + (e & 1), row + 8 for e >= 2: for 16-bit A the same layout
// as A's register fragments, so P goes from S's registers to P.V's A.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                   int causal,
                   int has_window, int window, float scale_log2, int delta,
                   int sk_valid) {
  constexpr int DP = kPadded<D>;
  constexpr int NC = DP / 64;                 // 64-column chunks
  constexpr unsigned QB = kBQ * DP * 2;       // bytes of the Q tile
  constexpr unsigned KB = kBK * DP * 2;       // bytes of a K or V tile
  extern __shared__ float4 smem4[];
  const unsigned Qs = (smem_addr(smem4) + 1023u) & ~1023u;
  const unsigned Ks = Qs + QB;                // [2] K tiles
  const unsigned Vs = Ks + 2 * KB;            // [2] V tiles

  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long bh = blockIdx.x;
  const long long b = bh / Hq, h = bh % Hq;
  const long long kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;  // longest first
  const bf16* qb = q + bh * Sq * D;
  const bf16* kb = k + kvh * Sk * D;
  const bf16* vb = v + kvh * Sk * D;

  // Key tiles any row of the block sees.
  const int rows = min(kBQ, Sq - q0);
  int k_end = sk_valid;
  if (causal) k_end = min(k_end, q0 + rows - 1 + delta + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q0 + delta - window + 1);
  const int t_begin = k_begin / kBK;
  const int n_tiles = k_end > k_begin ? (k_end - 1) / kBK - t_begin + 1 : 0;

  if (n_tiles > 0) {
    load_tile<D, kBQ, kThreads>(Qs, qb, q0, Sq, tid);
    load_tile<D, kBK, kThreads>(Ks, kb, t_begin * kBK, Sk, tid);
    load_tile<D, kBK, kThreads>(Vs, vb, t_begin * kBK, Sk, tid);
  }
  cp_async_commit();

  // The warpgroup's 64 rows and their positions; this thread's two rows.
  const int wq0 = q0 + 64 * wgi;
  const int wlo = wq0 + delta, whi = wlo + 63;
  const int pos[2] = {wlo + 16 * warp + g, wlo + 16 * warp + g + 8};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      const int k1 = (t_begin + t + 1) * kBK;
      load_tile<D, kBK, kThreads>(Ks + (stage ^ 1) * KB, kb, k1, Sk, tid);
      load_tile<D, kBK, kThreads>(Vs + (stage ^ 1) * KB, vb, k1, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();  // cp.async's writes, seen by wgmma's reads
    __syncthreads();
    const int k0 = (t_begin + t) * kBK;
    const bool any = wq0 < Sq && k0 < sk_valid
                     && (!causal || k0 <= whi)
                     && (!has_window || k0 + kBK - 1 > wlo - window);
    if (any) {  // uniform over the warpgroup
      const bool full = k0 + kBK <= sk_valid
                        && (!causal || k0 + kBK - 1 <= wlo)
                        && (!has_window || k0 > whi - window);
      const unsigned kt = Ks + stage * KB, vt = Vs + stage * KB;

      // S = Q.K^T, 64 rows x 64 keys, D / 16 steps of 16 columns.
      float s[32];
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const unsigned col = (kk % 4) * 32u;
        wgmma_ss<0, 0>(s,
                 desc(Qs + (kk / 4) * (kBQ * kRow) + wgi * 64 * kRow + col,
                      16, 1024),
                 desc(kt + (kk / 4) * (kBK * kRow) + col, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Scores in log2 units; the per-element mask on edge tiles only.
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e] * scale_log2;
          if (!full) {
            const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qp = pos[e / 2];
            const bool ok = kp < sk_valid && (!causal || kp <= qp)
                            && (!has_window || kp > qp - window);
            x = ok ? x : kNegInf;
          }
          s[4 * j + e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // P = exp2(S - m) in float32, split into bf16 hi + lo, as the A
      // fragments of P.V's four 16-key steps.
      unsigned ph[4][4], pl[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e];
          p[e] = x == kNegInf ? 0.f : exp2f(x - m[e / 2]);
          l[e / 2] += p[e];
        }
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(p[0], p[1]);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(p[2], p[3]);
        const float2 f01 = __bfloat1622float2(h01);
        const float2 f23 = __bfloat1622float2(h23);
        ph[j / 2][2 * (j % 2)] = pack(h01);
        ph[j / 2][2 * (j % 2) + 1] = pack(h23);
        pl[j / 2][2 * (j % 2)] =
            pack(__floats2bfloat162_rn(p[0] - f01.x, p[1] - f01.y));
        pl[j / 2][2 * (j % 2) + 1] =
            pack(__floats2bfloat162_rn(p[2] - f23.x, p[3] - f23.y));
      }

      // O += P.V: per 16-key step, V's 16 x DP block (MN-major).
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // V is B transposed: the stride of 8-key groups is the stride
        // byte offset (1,024), that of 64-column chunks the leading one.
        const unsigned long long dv =
            desc(vt + ks * 16 * kRow, kBK * kRow, 1024);
        wgmma_rs_t<DP>(o, ph[ks], dv);
        wgmma_rs_t<DP>(o, pl[ks], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    __syncthreads();
  }

  float inv[2];
  const int row = wq0 + 16 * warp + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(sum, 1e-30f);
    // m is in log2 units: lse = (m + log2(sum)) ln 2.
    if (lse != nullptr && t4 == 0 && row + 8 * r < Sq) {
      lse[bh * Sq + row + 8 * r] =
          sum > 0.f ? (m[r] + log2f(sum)) * 0.6931471805599453f : -CUDART_INF_F;
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * c + 8 * j + 2 * t4;
      if (col >= D) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row + 8 * r < Sq) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + (bh * Sq + row + 8 * r) * D + col) =
              __floats2bfloat162_rn(o[32 * c + 4 * j + 2 * r] * inv[r],
                                    o[32 * c + 4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int causal,
           int has_window,
           int window, float scale, int delta, int sk_valid,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Hq, Hkv, Sq,
      Sk, causal, has_window, window, scale * 1.4426950408889634f, delta,
      sk_valid);
  return (int)cudaGetLastError();
}

}  // namespace wg

#define REPRO_FLASH_DISPATCH(FN)                                         \
  switch (D) {                                                           \
    case 16: return FN<16>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal, \
                           has_window, window, scale, delta, sk_valid,   \
                           s);                                           \
    case 32: return FN<32>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal, \
                           has_window, window, scale, delta, sk_valid,   \
                           s);                                           \
    case 64: return FN<64>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk, causal, \
                           has_window, window, scale, delta, sk_valid,   \
                           s);                                           \
    case 128: return FN<128>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk,       \
                             causal, has_window, window, scale, delta,   \
                             sk_valid, s);                               \
    case 256: return FN<256>(q, k, v, out, lse, B, Hq, Hkv, Sq, Sk,       \
                             causal, has_window, window, scale, delta,   \
                             sk_valid, s);                               \
  }

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     int B, int Hq, int Hkv, int Sq, int Sk,
                                     int D,
                                     int causal, int has_window, int window,
                                     float scale, int sq_valid, int sk_valid,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hq == 0 || Sq == 0) return (int)cudaGetLastError();
  const int delta = sk_valid - sq_valid;
  if (dtype == lm::kBF16) {
    REPRO_FLASH_DISPATCH(wg::launch)
  } else {
    REPRO_FLASH_DISPATCH(launch_f32)
  }
  return (int)cudaErrorInvalidValue;
}

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
// Design.  One block of 256 threads per (b, h) and 64 query rows, the
// rows loaded into shared memory once; the block walks 64-key tiles from
// the first that the window reaches to the last that the causal band
// reaches (the Pallas kernel's whole-block skip), each tile loaded into
// shared memory as float32 (K transposed), so D = 256 takes 210 KB of
// dynamic shared memory and one block an SM.  Thread (ty, tx) computes
// the scores of rows ty + 16i and keys tx + 16j (i, j < 4) with scalar
// FMAs, the row's max and sum reduced over the 16 lanes of the row with
// shuffles; it keeps running max, sum and the output rows ty + 16i,
// columns tx + 16c, in registers (online softmax, float32).  Scalar
// float32 FMAs run at most at 67 TFLOP/s, 1/15 of the tensor cores' bf16
// rate: this kernel is right first; wgmma and TMA are later work.
#include <cuda_runtime.h>

#include "lm_dtype.cuh"

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
             const X* __restrict__ v, X* __restrict__ out, int Hq, int Hkv,
             int Sq, int Sk, int causal, int has_window, int window,
             float scale, int delta, int sk_valid) {
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
    }
  }
}

template <typename X, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, int has_window,
           int window, float scale, int delta, int sk_valid,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_kernel<X, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const X*>(q), static_cast<const X*>(k),
      static_cast<const X*>(v), static_cast<X*>(out), Hq, Hkv, Sq, Sk,
      causal, has_window, window, scale, delta, sk_valid);
  return (int)cudaGetLastError();
}

template <typename X>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int Sq, int Sk, int D, int causal,
             int has_window, int window, float scale, int delta,
             int sk_valid, cudaStream_t s) {
#define REPRO_FLASH_CASE(DD)                                                 \
  case DD:                                                                   \
    return launch<X, DD>(q, k, v, out, B, Hq, Hkv, Sq, Sk, causal,           \
                         has_window, window, scale, delta, sk_valid, s);
  switch (D) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
  }
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Hq,
                                     int Hkv, int Sq, int Sk, int D,
                                     int causal, int has_window, int window,
                                     float scale, int sq_valid, int sk_valid,
                                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hq == 0 || Sq == 0) return (int)cudaGetLastError();
  const int delta = sk_valid - sq_valid;
  if (dtype == lm::kBF16) {
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D,
                                   causal, has_window, window, scale, delta,
                                   sk_valid, s);
  }
  return dispatch<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal,
                         has_window, window, scale, delta, sk_valid, s);
}

// flash_attention_bwd: the gradient of flash_attention (causal, sliding
// window, GQA, end-aligned Sq != Sk) with respect to q, k and v, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains through the jnp
// blocked softmax (src/repro/models/attention.py::_flash) with
// jax.value_and_grad and has no backward kernel.  The port's forward
// attention is a kernel (flash_attention.cu), so its gradient is one too,
// held against the plain PyTorch version flash_attention_backward_plain
// (src/repro_torch/kernels/flash_attention.py) and, on the CPU, against
// jax.vjp of ref.attention.
//
// Inputs: q, o, do [B, Hq, Sq, D], k, v [B, Hkv, Sk, D] in one dtype
// (float32 or bfloat16), lse float32 [B, Hq, Sq] from the forward.
// Outputs dq, dk, dv in that dtype.  With s the scale, S = s q.k and the
// forward's mask (key j visible to row i at position p = i + sk_valid -
// sq_valid when j < sk_valid, j <= p if causal, j > p - window if
// windowed):
//   P = exp(S - lse) on visible pairs, 0 elsewhere;
//   Di = rowsum(dO * O);  dP = dO.V^T;  dS = P * (dP - Di);
//   dV = sum over the query heads of a kv head of P^T.dO;
//   dK = s * (the same sum of dS^T.Q);  dQ = s * dS.K.
// Every product and sum in float32.  A row that sees no key, and a key
// that no row sees, get a zero gradient.
//
// Bound on this card: operations.  At the training shape (B 1, Hq 32,
// Hkv 4, S 4,096, D 128, causal) the 268 M visible pairs need 10 D flops
// each (S and dP recomputed, dV, dK, dQ), 2.5x the forward's 4 D.
//
// Three launches, no float atomics (a gradient is summed by one thread
// in a fixed order, so repeated runs give the same bits):
//  1. delta: Di = rowsum(dO * O), one warp a row.
//  2. dkdv: one block of 256 threads per (b, kv head, key tile of BK =
//     64 keys; 32 at D = 256), K and V of the tile in shared memory
//     (transposed).  It walks the rep query heads of the kv head and,
//     for each, the 64-row query tiles that see the tile, from the first
//     that the causal band reaches to the last that the window reaches.
//     Per query tile: Q and dO in shared memory; thread (ty, tx) computes
//     S and dP of rows ty + 16 i and keys tx + 16 j, writes P and dS to
//     shared memory; then accumulates dV and dK of keys ty + 16 j',
//     columns tx + 16 c, in float32 registers over the tile's rows.
//  3. dq: one block per (b, q head, 64-row query tile) walks the key
//     tiles the rows see, recomputes S, dP and dS as 2., and accumulates
//     dQ of rows ty + 16 i, columns tx + 16 c in registers.
// Shared memory (float32): Q and dO 64 x (D + 1), K^T and V^T D x (BK +
// 1), P and dS 64 x (BK + 1): 166 KB at D = 128, 217 KB at D = 256.
// Scalar FMAs: a simple kernel that is right.  Tensor cores (wgmma, TMA)
// are the next step (ROADMAP B.14c).
#include <cuda_runtime.h>

#include "lm_dtype.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;

template <int D>
constexpr int kKeyTile = D > 128 ? 32 : 64;

template <int D>
constexpr size_t smem_bytes() {
  constexpr int BK = kKeyTile<D>;
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * D * (BK + 1)
                          + 2 * kBQ * (BK + 1) + 2 * kBQ);
}

struct Mask {
  int Sq, sk_valid, causal, has_window, window, delta;

  __device__ __forceinline__ bool visible(int row, int key) const {
    const int pos = row + delta;
    return row < Sq && key < sk_valid && (!causal || key <= pos)
           && (!has_window || key > pos - window);
  }
};

// dst[r * stride + c] = src row (row0 + r), column c, or 0 past n_rows.
template <typename X, int D>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const X* src, int row0,
                                          int n_rows, int R) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * stride + c] =
        row0 + r < n_rows ? lm::load(src + (long long)(row0 + r) * D + c)
                          : 0.f;
  }
}

// dst[c * stride + r]: the rows transposed.
template <typename X, int D>
__device__ __forceinline__ void load_rows_t(float* dst, int stride,
                                            const X* src, int row0,
                                            int n_rows, int R) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[c * stride + r] =
        row0 + r < n_rows ? lm::load(src + (long long)(row0 + r) * D + c)
                          : 0.f;
  }
}

__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int n_rows) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    dst[r] = row0 + r < n_rows ? src[row0 + r] : 0.f;
  }
}

// P and dS of query rows i0 + ty + 16 i and keys k0 + tx + 16 j into
// Ps and dSs ([kBQ][BK + 1]); Qs, dOs [kBQ][D + 1], Kt, Vt [D][BK + 1].
template <int D>
__device__ __forceinline__ void probs(const float* Qs, const float* dOs,
                                      const float* Kt, const float* Vt,
                                      const float* Ls, const float* Ds,
                                      float* Ps, float* dSs, int i0, int k0,
                                      float scale, const Mask& mask) {
  constexpr int BK = kKeyTile<D>;
  constexpr int NJ = BK / 16;
  constexpr int QS = D + 1, KS = BK + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][NJ], dp[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[NJ], vv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * QS + d];
      ov[i] = dOs[(ty + 16 * i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kv[j] = Kt[d * KS + tx + 16 * j];
      vv[j] = Vt[d * KS + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      const float p = mask.visible(i0 + r, k0 + c)
                          ? expf(s[i][j] * scale - Ls[r]) : 0.f;
      Ps[r * KS + c] = p;
      dSs[r * KS + c] = p * (dp[i][j] - Ds[r]);
    }
  }
}

// 1. Di = rowsum(dO * O) in float32, one warp a row.
template <typename X>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const X* __restrict__ o, const X* __restrict__ dout,
             float* __restrict__ di, long long n_rows, int D) {
  const long long row = (long long)blockIdx.x * (kThreads / 32)
                        + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const X* a = o + row * D;
  const X* b = dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) {
    acc = fmaf(lm::load(a + c), lm::load(b + c), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) di[row] = acc;
}

// 2. dK and dV of one (b, kv head, key tile).
template <typename X, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const X* __restrict__ q, const X* __restrict__ k,
            const X* __restrict__ v, const X* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            X* __restrict__ dk, X* __restrict__ dv, int Hq, int Hkv, int Sk,
            float scale, Mask mask) {
  constexpr int BK = kKeyTile<D>;
  constexpr int NJ = BK / 16, NC = D / 16;
  constexpr int QS = D + 1, KS = BK + 1;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][QS]
  float* dOs = Qs + kBQ * QS;                    // [kBQ][QS]
  float* Kt = dOs + kBQ * QS;                    // [D][KS]
  float* Vt = Kt + D * KS;                       // [D][KS]
  float* Ps = Vt + D * KS;                       // [kBQ][KS]
  float* dSs = Ps + kBQ * KS;                    // [kBQ][KS]
  float* Ls = dSs + kBQ * KS;                    // [kBQ]
  float* Ds = Ls + kBQ;                          // [kBQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bg = blockIdx.x;               // b * Hkv + kv head
  const long long b = bg / Hkv, g = bg % Hkv;
  const int rep = Hq / Hkv;
  const int k0 = blockIdx.y * BK;
  const int Sq = mask.Sq;

  load_rows_t<X, D>(Kt, KS, k + bg * Sk * D, k0, Sk, BK);
  load_rows_t<X, D>(Vt, KS, v + bg * Sk * D, k0, Sk, BK);

  float adk[NJ][NC], adv[NJ][NC];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[j][c] = adv[j][c] = 0.f;

  // Query rows that can see a key of [k0, k_hi): pos >= k0 (causal),
  // pos < k_hi - 1 + window (window).
  const int k_hi = min(k0 + BK, mask.sk_valid);
  int i_begin = 0, i_end = 0;
  if (k0 < mask.sk_valid) {
    i_begin = mask.causal ? max(0, k0 - mask.delta) : 0;
    i_end = mask.has_window
                ? min(Sq, k_hi - 1 + mask.window - mask.delta) : Sq;
  }
  for (int h = 0; h < rep && i_begin < i_end; ++h) {
    const long long bh = b * Hq + g * rep + h;
    for (int i0 = i_begin / kBQ * kBQ; i0 < i_end; i0 += kBQ) {
      __syncthreads();
      load_rows<X, D>(Qs, QS, q + bh * Sq * D, i0, Sq, kBQ);
      load_rows<X, D>(dOs, QS, dout + bh * Sq * D, i0, Sq, kBQ);
      load_vec(Ls, lse + bh * Sq, i0, Sq);
      load_vec(Ds, di + bh * Sq, i0, Sq);
      __syncthreads();
      probs<D>(Qs, dOs, Kt, Vt, Ls, Ds, Ps, dSs, i0, k0, scale, mask);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float p[NJ], ds[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          p[j] = Ps[r * KS + ty + 16 * j];
          ds[j] = dSs[r * KS + ty + 16 * j];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = dOs[r * QS + tx + 16 * c];
          const float qv = Qs[r * QS + tx + 16 * c];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            adv[j][c] = fmaf(p[j], ov, adv[j][c]);
            adk[j][c] = fmaf(ds[j], qv, adk[j][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int key = k0 + ty + 16 * j;
    if (key < Sk) {
      X* pk = dk + (bg * Sk + key) * D;
      X* pv = dv + (bg * Sk + key) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        lm::store(pk + tx + 16 * c, adk[j][c] * scale);
        lm::store(pv + tx + 16 * c, adv[j][c]);
      }
    }
  }
}

// 3. dQ of one (b, q head, query tile).
template <typename X, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const X* __restrict__ q, const X* __restrict__ k,
          const X* __restrict__ v, const X* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ di,
          X* __restrict__ dq, int Hq, int Hkv, int Sk, float scale,
          Mask mask) {
  constexpr int BK = kKeyTile<D>;
  constexpr int NC = D / 16;
  constexpr int QS = D + 1, KS = BK + 1;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBQ * QS;
  float* Kt = dOs + kBQ * QS;
  float* Vt = Kt + D * KS;
  float* Ps = Vt + D * KS;
  float* dSs = Ps + kBQ * KS;
  float* Ls = dSs + kBQ * KS;
  float* Ds = Ls + kBQ;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long bh = blockIdx.x;
  const long long b = bh / Hq, h = bh % Hq;
  const long long kvh = b * Hkv + h / (Hq / Hkv);
  const int i0 = blockIdx.y * kBQ;
  const int Sq = mask.Sq;

  load_rows<X, D>(Qs, QS, q + bh * Sq * D, i0, Sq, kBQ);
  load_rows<X, D>(dOs, QS, dout + bh * Sq * D, i0, Sq, kBQ);
  load_vec(Ls, lse + bh * Sq, i0, Sq);
  load_vec(Ds, di + bh * Sq, i0, Sq);

  float adq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adq[i][c] = 0.f;

  // Keys any row of the tile sees.
  const int rows = min(kBQ, Sq - i0);
  int k_end = mask.sk_valid;
  if (mask.causal) k_end = min(k_end, i0 + rows - 1 + mask.delta + 1);
  const int k_begin =
      mask.has_window ? max(0, i0 + mask.delta - mask.window + 1) : 0;

  for (int k0 = k_begin / BK * BK; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows_t<X, D>(Kt, KS, k + kvh * Sk * D, k0, Sk, BK);
    load_rows_t<X, D>(Vt, KS, v + kvh * Sk * D, k0, Sk, BK);
    __syncthreads();
    probs<D>(Qs, dOs, Kt, Vt, Ls, Ds, Ps, dSs, i0, k0, scale, mask);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * KS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = Kt[(tx + 16 * c) * KS + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) adq[i][c] = fmaf(ds[i], kv, adq[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row < Sq) {
      X* p = dq + (bh * Sq + row) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        lm::store(p + tx + 16 * c, adq[i][c] * scale);
      }
    }
  }
}

template <typename X, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* di, int B, int Hq, int Hkv, int Sq, int Sk, float scale,
           const Mask& mask, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  constexpr int BK = kKeyTile<D>;
  const X* qx = static_cast<const X*>(q);
  const X* kx = static_cast<const X*>(k);
  const X* vx = static_cast<const X*>(v);
  const X* dox = static_cast<const X*>(dout);
  const long long n_rows = (long long)B * Hq * Sq;
  delta_kernel<X><<<(unsigned)((n_rows + 7) / 8), kThreads, 0, s>>>(
      static_cast<const X*>(o), dox, di, n_rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kdkdv = dkdv_kernel<X, D>;
  auto kdq = dq_kernel<X, D>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kdkdv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (Sk > 0) {
    const dim3 grid((unsigned)(B * Hkv), (unsigned)((Sk + BK - 1) / BK));
    kdkdv<<<grid, kThreads, smem, s>>>(qx, kx, vx, dox, lse, di,
                                       static_cast<X*>(dk),
                                       static_cast<X*>(dv), Hq, Hkv, Sk,
                                       scale, mask);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + kBQ - 1) / kBQ));
  kdq<<<grid, kThreads, smem, s>>>(qx, kx, vx, dox, lse, di,
                                   static_cast<X*>(dq), Hq, Hkv, Sk, scale,
                                   mask);
  return (int)cudaGetLastError();
}

template <typename X>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* o, const float* lse, const void* dout, void* dq,
             void* dk, void* dv, float* di, int B, int Hq, int Hkv, int Sq,
             int Sk, float scale, const Mask& mask, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<X, 16>(q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                           Hkv, Sq, Sk, scale, mask, s);
    case 32:
      return launch<X, 32>(q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                           Hkv, Sq, Sk, scale, mask, s);
    case 64:
      return launch<X, 64>(q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                           Hkv, Sq, Sk, scale, mask, s);
    case 128:
      return launch<X, 128>(q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                            Hkv, Sq, Sk, scale, mask, s);
    case 256:
      return launch<X, 256>(q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                            Hkv, Sq, Sk, scale, mask, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// di: float32 scratch of B * Hq * Sq (Di); the wrapper allocates it.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* di, int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
    int has_window, int window, float scale, int sq_valid, int sk_valid,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hq == 0 || Sq == 0) return (int)cudaGetLastError();
  const Mask mask{Sq, sk_valid, causal, has_window, window,
                  sk_valid - sq_valid};
  if (dtype == lm::kBF16) {
    return dispatch<__nv_bfloat16>(D, q, k, v, o, lse, dout, dq, dk, dv, di,
                                   B, Hq, Hkv, Sq, Sk, scale, mask, s);
  }
  return dispatch<float>(D, q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                         Hkv, Sq, Sk, scale, mask, s);
}

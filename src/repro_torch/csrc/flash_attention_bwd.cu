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
// that no row sees, get a zero gradient.  No float atomics: every output
// element is summed by one thread in a fixed order, so a call's bits
// repeat.  Scratch (the `di` argument, float32, allocated by the wrapper,
// kernels/flash_attention.bwd_scratch_numel): Di of every row, B Hq Sq;
// on the tensor-core route with Hq > Hkv it goes on, from the next
// multiple of 4 elements, with the float32 dK and dV partials of every
// query head, 2 x [B, Hq, Sk, D].
//
// Bound on this card: operations.  At the training shape (B 1, Hq 32,
// Hkv 4, S 4,096, D 128, causal, bf16) the 268 M visible pairs need 10 D
// flops each (S and dP recomputed, dV, dK, dQ): 343.7 GFLOP, 0.348 ms at
// the tensor cores' 989 TFLOP/s; the bytes (q, k, v, o, dO, lse read
// once, dq, dk, dv written once, 152 MB) take 0.045 ms.  At
// recurrentgemma-9b's (B 1, Hq 16, Hkv 1, S 4,096, D 256, causal, window
// 2,048) 100.7 M pairs: 257.7 GFLOP, 0.261 ms (the bytes 0.043 ms).
//
// bfloat16 (the trained dtype): the tensor cores through wgmma
// (wgmma.cuh), FlashAttention-2's two passes, four launches:
//  1. delta: Di = rowsum(dO * O) in float32, one warp a row.
//  2. dkdv: one block of two warpgroups per (b, query head, 128-key
//     tile), each warpgroup owning 64 keys; K and V of the tile loaded
//     once into 128-byte-swizzled shared memory.  The block walks the
//     64-row query tiles that see the key tile; Q, dO, lse and Di of
//     each go through a two-stage cp.async ring.  Per query tile: S^T =
//     K.Q^T and dP^T = V.dO^T by wgmma with both operands in shared
//     memory (K-major); P^T = exp2(S^T s log2(e) - lse log2(e)) and dS^T
//     = P^T (dP^T - Di) in float32 registers, the per-element mask only
//     on tiles that straddle an edge; dV += P^T.dO and dK += dS^T.Q by
//     wgmma with P^T and dS^T as bf16 A fragments straight from the
//     accumulators' registers and dO and Q read MN-major.  Blocks go out
//     longest first (under the causal band the first key tiles see the
//     most rows); consecutive blocks are query heads of one kv head, so
//     K and V come from L2.
//  3. rep sum (Hq > Hkv): each dkdv block wrote float32 partials of its
//     own query head; one thread per 4 elements sums the rep heads of a
//     kv head in head order, scales dK and casts (at the training shape
//     134 MB of partials, ~0.08 ms).  With Hq == Hkv the dkdv blocks
//     write dK and dV themselves.  Walking the rep heads inside one block
//     instead gives B Hkv Sk / 128 blocks: 128 at the training shape,
//     fewer than the 132 SMs, the first doing 64x the last one's work.
//  4. dq: one block per (b, query head, 128-row query tile), two
//     warpgroups of 64 rows; Q, dO, lse and Di loaded once.  The block
//     walks the 64-key tiles its rows see, K and V through the ring: S =
//     Q.K^T and dP = dO.V^T by wgmma from shared memory, dS in registers,
//     dQ += dS.K by wgmma with K MN-major.  S and dP are computed in both
//     passes (4 D flops a pair beyond the bound's 10 D), for no atomics
//     and no [Sq, Sk] buffer.
// P and dS are rounded to bf16 once for the A operand, as FlashAttention
// does (2^-9 of each term, against the bf16 gate of relative L2 1e-2).
// Shared memory at D = 128: dkdv 130 KB (K and V 64 KB, 2 x (Q + dO) 64
// KB, lse and Di), dq 129 KB (Q and dO 64 KB, 2 x (K + V) 64 KB); one
// block of 256 threads an SM, __launch_bounds__(256, 1): a dkdv thread
// holds dK and dV (64 + 64 float32), S^T and dP^T (32 + 32) and the
// fragments (ptxas: 251 registers for dkdv, 181 for dq, no spill).  Head
// widths 16 and 32 are padded to 64 in shared memory, as the forward's.
// What it leaves: no TMA or producer warp, no setmaxnreg; the two
// warpgroups run in step (two barriers a tile), so the tensor cores idle
// through the exponentials and the loads' waits.
//
// D = 256 (recurrentgemma-9b's width) splits the head's columns between
// the two warpgroups (kSplit).  At D 256 a warpgroup's 64 keys of float32
// dK and dV over every column would take 64 x 256 x 2 / 128 = 256
// registers a thread, past the 255 a thread can have.  Two layouts fit:
// (a) both warpgroups take the block's 64 keys and compute the full-depth
// S^T and dP^T, then each accumulates dK and dV of one half of D (128
// columns) with P^T and dS^T straight from its registers
// (wgmma_rs_t<128>); (b) one warpgroup computes S^T, the other dP^T, and
// they trade P^T and dS^T through shared memory (and P or dP^T - Di in
// float32, since dS^T needs both) with barriers between the two.  This is
// (a): a thread holds what it holds at D 128 (dK and dV 64 + 64, S^T and
// dP^T 32 + 32, the fragments), the dataflow and the block's two barriers
// a tile stay as at D 128, and no shared-memory round trip or wait on the
// other warpgroup sits between the exponentials and the products.  Its
// price: both warpgroups compute S^T and dP^T (and the exponentials), 4 D
// flops a pair more.  dq likewise: Q and dO of 128 rows (128 KB) beside
// two stages of K and V (128 KB) would pass 227 KB, so a block takes 64
// rows and each warpgroup accumulates dQ of one half of D.  So a pair
// costs 12 D flops in dkdv and 10 D in dq, 22 D against the bound's 10 D
// (14 D at D <= 128).  Shared memory: dkdv 194 KB (K and V of 64 keys 64
// KB, 2 x (Q + dO) 128 KB, lse and Di), dq 193 KB (Q and dO of 64 rows 64
// KB, 2 x (K + V) 128 KB), within the 227 KB a block can have.  At the
// training shape 1,024 blocks a pass (16 heads x 64 tiles) on 132 SMs,
// longest first as at D 128.  ptxas: 237 registers for dkdv, 174 for dq,
// no spill.  What it leaves: what D 128 leaves, and the products made
// twice.
//
// Scalar float32 FMAs for float32 (the smoke models; their gate,
// relative L2 1e-4, is one TF32 would not hold), three launches:
//  1. delta as above.
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
#include <cuda_runtime.h>

#include "lm_dtype.cuh"
#include "wgmma.cuh"

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

// ------------------------------------- bfloat16: warpgroup products
namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kGroups = 2;                // consumer warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr int kTile = 64;                 // rows (dkdv), keys (dq) a tile
constexpr float kLog2e = 1.4426950408889634f;

// D = 256 splits the head's columns between the warpgroups: both take the
// block's 64 keys (dkdv) or rows (dq), each accumulates one half of D.
template <int D>
constexpr bool kSplit = D > 128;
// Keys (dkdv) or rows (dq) a block: 64 a warpgroup, or 64 when split.
template <int D>
constexpr int kBlk = kSplit<D> ? 64 : 64 * kGroups;
// Columns of dK and dV (dkdv) or dQ (dq) that a warpgroup accumulates.
template <int D>
constexpr int kCols = kSplit<D> ? kPadded<D> / kGroups : kPadded<D>;

// dkdv: K and V of the block, 2 x (Q + dO) tiles, 2 x (lse + Di) rows,
// and 1 KB to align the tiles to the swizzle's period.
template <int D>
constexpr size_t dkdv_smem() {
  return 1024
         + (size_t)(2 * kBlk<D> + 4 * kTile) * kPadded<D> * sizeof(bf16)
         + 4 * kTile * sizeof(float);
}

// dq: Q and dO of the block, 2 x (K + V) tiles.
template <int D>
constexpr size_t dq_smem() {
  return 1024
         + (size_t)(2 * kBlk<D> + 4 * kTile) * kPadded<D> * sizeof(bf16);
}
static_assert(dkdv_smem<256>() <= 232448 && dq_smem<256>() <= 232448,
              "a block has at most 227 KB of shared memory");

// The accumulators' layout (m64nNk16, as the forward's): warp w of the
// warpgroup holds rows 16 w + g and 16 w + g + 8 (lane = 4 g + t), d[4 j
// + e] at column 8 j + 2 t + (e & 1), row + 8 for e >= 2; for 16-bit A
// the A fragments' layout, so a 64 x 64 accumulator becomes the A of a
// product of depth 64 in four 16-column steps.
__device__ __forceinline__ void to_frag(unsigned (&a)[4][4], int j,
                                        const float (&x)[4]) {
  a[j / 2][2 * (j % 2)] = pack(__floats2bfloat162_rn(x[0], x[1]));
  a[j / 2][2 * (j % 2) + 1] = pack(__floats2bfloat162_rn(x[2], x[3]));
}

// x = A0.B0^T and y = A1.B1^T, 64 x 64 each, over DP / 16 steps of 16
// columns, both operands K-major in shared memory: A0 and A1 the 64 rows
// from row a_row of RA-row tiles, B0 and B1 kTile-row tiles.
template <int DP, int RA>
__device__ __forceinline__ void two_products(float (&x)[32], float (&y)[32],
                                             unsigned a0, unsigned a1,
                                             unsigned b0, unsigned b1,
                                             int a_row) {
  fence_regs(x);
  fence_regs(y);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const unsigned col = (kk % 4) * 32u;
    const unsigned a = (kk / 4) * (RA * kRow) + a_row * kRow + col;
    const unsigned b = (kk / 4) * (kTile * kRow) + col;
    wgmma_ss<0, 0>(x, desc(a0 + a, 16, 1024), desc(b0 + b, 16, 1024),
                   kk > 0);
    wgmma_ss<0, 0>(y, desc(a1 + a, 16, 1024), desc(b1 + b, 16, 1024),
                   kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(x);
  fence_regs(y);
}

// 2. dK and dV of 64 keys a warpgroup (of the block's 64 keys and half
// of D when split), over the query tiles of one query head; float32
// partials where Hq > Hkv, else dk and dv.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            bf16* __restrict__ dk, bf16* __restrict__ dv,
            float* __restrict__ part_k, float* __restrict__ part_v, int Hq,
            int Hkv, int Sk, float scale, float scale_log2, Mask mask) {
  constexpr int DP = kPadded<D>;
  constexpr int BK = kBlk<D>;
  constexpr int NC = kCols<D> / 64;
  constexpr unsigned KB = BK * DP * 2;       // K or V of the block's keys
  constexpr unsigned TB = kTile * DP * 2;    // a Q or dO tile
  extern __shared__ float4 smem4[];
  const unsigned base = smem_addr(smem4);
  const unsigned Ks = (base + 1023u) & ~1023u;
  const unsigned Vs = Ks + KB;
  const unsigned Qs = Vs + KB;               // [2] Q tiles
  const unsigned Os = Qs + 2 * TB;           // [2] dO tiles
  const unsigned LDs = Os + 2 * TB;          // [2] x (lse, Di) x kTile
  const float* lds = reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(smem4) + (LDs - base));

  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long bh = blockIdx.x;
  const long long b = bh / Hq, h = bh % Hq;
  const int rep = Hq / Hkv;
  const long long kvh = b * Hkv + h / rep;
  const int k0 = blockIdx.y * BK;            // longest first under causal
  const int Sq = mask.Sq;
  const bf16* qb = q + bh * Sq * D;
  const bf16* ob = dout + bh * Sq * D;
  const float* lb = lse + bh * Sq;
  const float* db = di + bh * Sq;

  // Query rows that can see a key of [k0, k_hi): pos >= k0 (causal),
  // pos < k_hi - 1 + window (window).
  const int k_hi = min(k0 + BK, mask.sk_valid);
  int i_begin = 0, i_end = 0;
  if (k0 < mask.sk_valid) {
    i_begin = mask.causal ? max(0, k0 - mask.delta) : 0;
    i_end = mask.has_window
                ? min(Sq, k_hi - 1 + mask.window - mask.delta) : Sq;
  }
  const int t_begin = i_begin / kTile;
  const int n_tiles = i_end > i_begin ? (i_end - 1) / kTile - t_begin + 1
                                      : 0;

  // Q, dO, lse and Di of query tile t into ring stage st.
  auto load_stage = [&](int t, int st) {
    const int i0 = (t_begin + t) * kTile;
    load_tile<D, kTile, kThreads>(Qs + st * TB, qb, i0, Sq, tid);
    load_tile<D, kTile, kThreads>(Os + st * TB, ob, i0, Sq, tid);
    if (tid < 2 * kTile) {
      const int r = tid % kTile;
      const bool ok = i0 + r < Sq;
      cp_async4(LDs + (unsigned)(st * 2 * kTile + tid) * 4u,
                (tid < kTile ? lb : db) + (ok ? i0 + r : 0), ok);
    }
  };
  if (n_tiles > 0) {
    load_tile<D, BK, kThreads>(Ks, k + kvh * Sk * D, k0, Sk, tid);
    load_tile<D, BK, kThreads>(Vs, v + kvh * Sk * D, k0, Sk, tid);
    load_stage(0, 0);
  }
  cp_async_commit();

  // The warpgroup's 64 keys (from row wrow of K and V) and its first
  // column; this thread's two keys.
  const int wrow = kSplit<D> ? 0 : 64 * wgi;
  const int col0 = kSplit<D> ? kCols<D> * wgi : 0;
  const int wk0 = k0 + wrow;
  const int key[2] = {wk0 + 16 * warp + g, wk0 + 16 * warp + g + 8};
  float adk[kCols<D> / 2], adv[kCols<D> / 2];
#pragma unroll
  for (int i = 0; i < kCols<D> / 2; ++i) adk[i] = adv[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) load_stage(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();  // cp.async's writes, seen by wgmma's reads
    __syncthreads();
    const int i0 = (t_begin + t) * kTile;
    const int rows = min(kTile, Sq - i0);
    const int plo = i0 + mask.delta, phi = plo + rows - 1;
    const bool any = wk0 < mask.sk_valid && (!mask.causal || wk0 <= phi)
                     && (!mask.has_window || wk0 + 63 > plo - mask.window);
    if (any) {  // uniform over the warpgroup
      const bool full = rows == kTile && wk0 + 64 <= mask.sk_valid
                        && (!mask.causal || wk0 + 63 <= plo)
                        && (!mask.has_window || wk0 > phi - mask.window);
      const unsigned qt = Qs + st * TB, ot = Os + st * TB;

      // S^T = K.Q^T and dP^T = V.dO^T: 64 keys x 64 rows.
      float s[32], dp[32];
      two_products<DP, BK>(s, dp, Ks, Vs, qt, ot, wrow);

      // P^T and dS^T in float32, as bf16 A fragments (rows: keys; depth:
      // the tile's query rows); lse and Di by column.
      const float* lt = lds + st * 2 * kTile;
      unsigned pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = 8 * j + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + c0);
        const float2 d2 = *reinterpret_cast<const float2*>(lt + kTile + c0);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lc = (e & 1) ? l2.y : l2.x;
          const float dc = (e & 1) ? d2.y : d2.x;
          float x = exp2f(s[4 * j + e] * scale_log2 - lc * kLog2e);
          if (!full) x = mask.visible(i0 + c0 + (e & 1), key[e / 2]) ? x
                                                                    : 0.f;
          p[e] = x;
          ds[e] = x * (dp[4 * j + e] - dc);
        }
        to_frag(pa, j, p);
        to_frag(da, j, ds);
      }

      // dV += P^T.dO and dK += dS^T.Q over the warpgroup's columns: per
      // 16-row step, dO's and Q's 16 x kCols block from column col0 read
      // MN-major (8-row groups 1,024 bytes apart, the stride byte offset;
      // 64-column chunks the leading one).
      const unsigned cof = (unsigned)(col0 / 64) * (kTile * kRow);
      fence_regs(adv);
      fence_regs(adk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_rs_t<kCols<D>>(
            adv, pa[ks], desc(ot + cof + ks * 16 * kRow, kTile * kRow, 1024));
        wgmma_rs_t<kCols<D>>(
            adk, da[ks], desc(qt + cof + ks * 16 * kRow, kTile * kRow, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adv);
      fence_regs(adk);
    }
    __syncthreads();
  }

  // dk = s sum dS^T.Q, dv = sum P^T.dO: here where Hq == Hkv, else this
  // head's partial sums, added in head order by rep_sum_kernel.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + 64 * c + 8 * j + 2 * t4;
        if (col >= D) continue;
        const int i = 32 * c + 4 * j + 2 * r;
        if (rep == 1) {
          const long long o = (kvh * Sk + key[r]) * D + col;
          *reinterpret_cast<__nv_bfloat162*>(dk + o) =
              __floats2bfloat162_rn(adk[i] * scale, adk[i + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + o) =
              __floats2bfloat162_rn(adv[i], adv[i + 1]);
        } else {
          const long long o = (bh * Sk + key[r]) * D + col;
          *reinterpret_cast<float2*>(part_k + o) = make_float2(adk[i],
                                                               adk[i + 1]);
          *reinterpret_cast<float2*>(part_v + o) = make_float2(adv[i],
                                                               adv[i + 1]);
        }
      }
    }
  }
}

// 3. dk = s sum_h part_k[h], dv = sum_h part_v[h] over the rep query
// heads of each kv head, in head order; 4 elements a thread.
__global__ void __launch_bounds__(kThreads)
rep_sum_kernel(const float4* __restrict__ part_k,
               const float4* __restrict__ part_v, bf16* __restrict__ dk,
               bf16* __restrict__ dv, long long n4, long long per_head,
               int rep, float scale) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const long long src = (i / per_head) * rep * per_head + i % per_head;
    float4 sk = part_k[src], sv = part_v[src];
    for (int h = 1; h < rep; ++h) {
      const float4 a = part_k[src + h * per_head];
      const float4 c = part_v[src + h * per_head];
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(dk) + 2 * i;
    __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(dv) + 2 * i;
    pk[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
    pk[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
    pv[0] = __floats2bfloat162_rn(sv.x, sv.y);
    pv[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
}

// 4. dQ of 64 rows a warpgroup (of the block's 64 rows and half of D when
// split), over the key tiles the block's rows see.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ di,
          bf16* __restrict__ dq, int Hq, int Hkv, int Sk, float scale,
          float scale_log2, Mask mask) {
  constexpr int DP = kPadded<D>;
  constexpr int BQ = kBlk<D>;
  constexpr int NC = kCols<D> / 64;
  constexpr unsigned QB = BQ * DP * 2;       // Q or dO of the block's rows
  constexpr unsigned TB = kTile * DP * 2;    // a K or V tile
  extern __shared__ float4 smem4[];
  const unsigned Qs = (smem_addr(smem4) + 1023u) & ~1023u;
  const unsigned Os = Qs + QB;
  const unsigned Ks = Os + QB;               // [2] K tiles
  const unsigned Vs = Ks + 2 * TB;           // [2] V tiles

  const int tid = threadIdx.x, wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long bh = blockIdx.x;
  const long long b = bh / Hq, h = bh % Hq;
  const long long kvh = b * Hkv + h / (Hq / Hkv);
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * BQ;  // longest first
  const int Sq = mask.Sq;
  const bf16* kb = k + kvh * Sk * D;
  const bf16* vb = v + kvh * Sk * D;

  // Key tiles any row of the block sees.
  const int rows = min(BQ, Sq - q0);
  int k_end = mask.sk_valid;
  if (mask.causal) k_end = min(k_end, q0 + rows - 1 + mask.delta + 1);
  const int k_begin =
      mask.has_window ? max(0, q0 + mask.delta - mask.window + 1) : 0;
  const int t_begin = k_begin / kTile;
  const int n_tiles = k_end > k_begin ? (k_end - 1) / kTile - t_begin + 1
                                      : 0;

  if (n_tiles > 0) {
    load_tile<D, BQ, kThreads>(Qs, q + bh * Sq * D, q0, Sq, tid);
    load_tile<D, BQ, kThreads>(Os, dout + bh * Sq * D, q0, Sq, tid);
    load_tile<D, kTile, kThreads>(Ks, kb, t_begin * kTile, Sk, tid);
    load_tile<D, kTile, kThreads>(Vs, vb, t_begin * kTile, Sk, tid);
  }
  cp_async_commit();

  // The warpgroup's 64 rows (from row wrow of Q and dO), their positions
  // and its first column; this thread's two rows, their lse (log2 units)
  // and Di.
  const int wrow = kSplit<D> ? 0 : 64 * wgi;
  const int col0 = kSplit<D> ? kCols<D> * wgi : 0;
  const int wq0 = q0 + wrow;
  const int wlo = wq0 + mask.delta, whi = wlo + 63;
  const int row[2] = {wq0 + 16 * warp + g, wq0 + 16 * warp + g + 8};
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < Sq;
    l2[r] = ok ? lse[bh * Sq + row[r]] * kLog2e : 0.f;
    dd[r] = ok ? di[bh * Sq + row[r]] : 0.f;
  }
  float adq[kCols<D> / 2];
#pragma unroll
  for (int i = 0; i < kCols<D> / 2; ++i) adq[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      const int k1 = (t_begin + t + 1) * kTile;
      load_tile<D, kTile, kThreads>(Ks + (st ^ 1) * TB, kb, k1, Sk, tid);
      load_tile<D, kTile, kThreads>(Vs + (st ^ 1) * TB, vb, k1, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int k0 = (t_begin + t) * kTile;
    const bool any = wq0 < Sq && k0 < mask.sk_valid
                     && (!mask.causal || k0 <= whi)
                     && (!mask.has_window
                         || k0 + kTile - 1 > wlo - mask.window);
    if (any) {  // uniform over the warpgroup
      const bool full = k0 + kTile <= mask.sk_valid
                        && (!mask.causal || k0 + kTile - 1 <= wlo)
                        && (!mask.has_window || k0 > whi - mask.window);
      const unsigned kt = Ks + st * TB, vt = Vs + st * TB;

      // S = Q.K^T and dP = dO.V^T: 64 rows x 64 keys.
      float s[32], dp[32];
      two_products<DP, BQ>(s, dp, Qs, Os, kt, vt, wrow);

      // dS = P (dP - Di), P = exp2(S s log2(e) - lse log2(e)).
      unsigned da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = exp2f(s[4 * j + e] * scale_log2 - l2[e / 2]);
          if (!full) {
            const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
            x = mask.visible(row[e / 2], kp) ? x : 0.f;
          }
          ds[e] = x * (dp[4 * j + e] - dd[e / 2]);
        }
        to_frag(da, j, ds);
      }

      // dQ += dS.K: per 16-key step, K's 16 x kCols block from column col0
      // read MN-major.
      const unsigned cof = (unsigned)(col0 / 64) * (kTile * kRow);
      fence_regs(adq);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_rs_t<kCols<D>>(
            adq, da[ks], desc(kt + cof + ks * 16 * kRow, kTile * kRow, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(adq);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + 64 * c + 8 * j + 2 * t4;
        if (col >= D) continue;
        const int i = 32 * c + 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(
            dq + (bh * Sq + row[r]) * D + col) =
            __floats2bfloat162_rn(adq[i] * scale, adq[i + 1] * scale);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* scratch, int B, int Hq, int Hkv, int Sq, int Sk,
           float scale, const Mask& mask, cudaStream_t s) {
  const bf16* qx = static_cast<const bf16*>(q);
  const bf16* kx = static_cast<const bf16*>(k);
  const bf16* vx = static_cast<const bf16*>(v);
  const bf16* dox = static_cast<const bf16*>(dout);
  const long long n_rows = (long long)B * Hq * Sq;
  float* di = scratch;
  float* part_k = scratch + (n_rows + 3) / 4 * 4;
  float* part_v = part_k + (long long)B * Hq * Sk * D;
  const int rep = Hq / Hkv;
  const float scale_log2 = scale * kLog2e;
  delta_kernel<bf16><<<(unsigned)((n_rows + 7) / 8), kThreads, 0, s>>>(
      static_cast<const bf16*>(o), dox, di, n_rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kdkdv = dkdv_kernel<D>;
  auto kdq = dq_kernel<D>;
  constexpr size_t smem_kv = dkdv_smem<D>(), smem_q = dq_smem<D>();
  e = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  if (Sk > 0) {
    const dim3 grid((unsigned)(B * Hq),
                    (unsigned)((Sk + kBlk<D> - 1) / kBlk<D>));
    kdkdv<<<grid, kThreads, smem_kv, s>>>(
        qx, kx, vx, dox, lse, di, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), part_k, part_v, Hq, Hkv, Sk, scale,
        scale_log2, mask);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (rep > 1) {
      const long long per_head = (long long)Sk * D / 4;
      const long long n4 = (long long)B * Hkv * per_head;
      const long long want = (n4 + kThreads - 1) / kThreads;
      const long long blocks = want < 132 * 16 ? want : 132 * 16;
      rep_sum_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
          reinterpret_cast<const float4*>(part_k),
          reinterpret_cast<const float4*>(part_v), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), n4, per_head, rep, scale);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  const dim3 grid((unsigned)(B * Hq),
                  (unsigned)((Sq + kBlk<D> - 1) / kBlk<D>));
  kdq<<<grid, kThreads, smem_q, s>>>(qx, kx, vx, dox, lse, di,
                                     static_cast<bf16*>(dq), Hq, Hkv, Sk,
                                     scale, scale_log2, mask);
  return (int)cudaGetLastError();
}

}  // namespace wg

// float32: the scalar kernels.
int dispatch_f32(int D, const void* q, const void* k, const void* v,
                 const void* o, const float* lse, const void* dout, void* dq,
                 void* dk, void* dv, float* di, int B, int Hq, int Hkv,
                 int Sq, int Sk, float scale, const Mask& mask,
                 cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<float, 16>(q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                               Hkv, Sq, Sk, scale, mask, s);
    case 32:
      return launch<float, 32>(q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                               Hkv, Sq, Sk, scale, mask, s);
    case 64:
      return launch<float, 64>(q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                               Hkv, Sq, Sk, scale, mask, s);
    case 128:
      return launch<float, 128>(q, k, v, o, lse, dout, dq, dk, dv, di, B,
                                Hq, Hkv, Sq, Sk, scale, mask, s);
    case 256:
      return launch<float, 256>(q, k, v, o, lse, dout, dq, dk, dv, di, B,
                                Hq, Hkv, Sq, Sk, scale, mask, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bfloat16: the tensor cores at every D (D = 256 split between the
// warpgroups).
int dispatch_bf16(int D, const void* q, const void* k, const void* v,
                  const void* o, const float* lse, const void* dout,
                  void* dq, void* dk, void* dv, float* scratch, int B,
                  int Hq, int Hkv, int Sq, int Sk, float scale,
                  const Mask& mask, cudaStream_t s) {
  switch (D) {
    case 16:
      return wg::launch<16>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                            Hq, Hkv, Sq, Sk, scale, mask, s);
    case 32:
      return wg::launch<32>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                            Hq, Hkv, Sq, Sk, scale, mask, s);
    case 64:
      return wg::launch<64>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                            Hq, Hkv, Sq, Sk, scale, mask, s);
    case 128:
      return wg::launch<128>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                             Hq, Hkv, Sq, Sk, scale, mask, s);
    case 256:
      return wg::launch<256>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                             Hq, Hkv, Sq, Sk, scale, mask, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// di: the float32 scratch (see the header); the wrapper allocates it.
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
    return dispatch_bf16(D, q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq,
                         Hkv, Sq, Sk, scale, mask, s);
  }
  return dispatch_f32(D, q, k, v, o, lse, dout, dq, dk, dv, di, B, Hq, Hkv,
                      Sq, Sk, scale, mask, s);
}

// rwkv6: the RWKV-6 ("Finch") wkv recurrence, for Hopper (sm_90a).
//
//   out_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T           (S: [Dk, Dv] per head)
//
// Replaces the TPU kernel rwkv6_pallas in src/repro/kernels/rwkv6_scan.py;
// holds against the JAX oracle ref.rwkv6 and the plain PyTorch version
// rwkv6_plain (src/repro_torch/kernels/rwkv6.py).  r, k [B, H, S, Dk] and
// v [B, H, S, Dv] in float32 or bfloat16; w float32 [B, H, S, Dk]; u
// float32 [H, Dk]; s0 float32 [B, H, Dk, Dv].  out in r's dtype, s_last
// float32.  Any S in one launch.
//
// Bound on this card: operations, nearly tied with bytes.  At rwkv6-3b's
// prefill (B 4, H 48, S 3,072, Dk = Dv = 64, r/k/v bfloat16) the function
// reads 381 MB and writes 79 MB (459 MB in all, 0.137 ms at 3.35 TB/s)
// and does two fused multiply-adds per state element and step,
// 9.7 GFLOP, 0.144 ms at the card's 67 TFLOP/s of float32 outside the
// tensor cores.
//
// Design.  One block per (b, h) and up to 256 / (Dk/16) state columns
// walks t; the [Dk, Dv] state never leaves registers.  Thread (j, q)
// holds rows 16q..16q+15 of state column j, so Dk/16 adjacent lanes share
// a column and add their partial outputs with warp shuffles (Dk = Dv =
// 64: 256 threads a head, 192 blocks at that shape).  The block stages
// kChunk steps of r, k, w and v in shared memory at a time, coalesced,
// and syncs twice a chunk; each 16-row group of a staged step is padded
// to 20 floats so that the lanes of one column read their float4s from
// distinct banks.  The state update rounds its multiplies
// and add separately (__fmul_rn, __fadd_rn), as the plain version's
// tensor ops, so s_last does not drift from it; out's sum over k runs in
// another order than the plain version's einsum.
#include <cuda_runtime.h>

#include "lm_dtype.cuh"

namespace {

constexpr int kChunk = 16;
constexpr int kRows = 16;      // state rows per thread
constexpr int kGroup = 20;     // padded floats per 16-row group
constexpr int kMaxThreads = 256;

template <typename X, int DK>
__global__ void __launch_bounds__(kMaxThreads)
rwkv6_kernel(const X* __restrict__ r, const X* __restrict__ k,
             const X* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             X* __restrict__ out, float* __restrict__ s_last, int H, int S,
             int Dv) {
  constexpr int KS = DK / kRows;
  constexpr int RW = KS * kGroup;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* rs = sm;
  float* ks = rs + kChunk * RW;
  float* ws = ks + kChunk * RW;
  float* vs = ws + kChunk * RW;

  const long long bh = blockIdx.x;
  const int h = (int)(bh % H);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int j = blockIdx.y * (nth / KS) + tid / KS, q = tid % KS;
  const bool active = j < Dv;
  const long long rk_base = bh * S * DK;
  const long long v_base = bh * S * Dv;

  float st[kRows], ur[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q * kRows + i;
    ur[i] = u[h * DK + row];
    st[i] = active ? s0[(bh * DK + row) * Dv + j] : 0.0f;
  }

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    for (int idx = tid; idx < n * DK; idx += nth) {
      const int t = idx / DK, c = idx % DK;
      const long long src = rk_base + (long long)(t0 + t) * DK + c;
      const int dst = t * RW + (c / kRows) * kGroup + c % kRows;
      rs[dst] = lm::load(r + src);
      ks[dst] = lm::load(k + src);
      ws[dst] = w[src];
    }
    for (int idx = tid; idx < n * Dv; idx += nth) {
      vs[idx] = lm::load(v + v_base + (long long)t0 * Dv + idx);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = active ? vs[t * Dv + j] : 0.0f;
      const float4* r4 = reinterpret_cast<const float4*>(rs + t * RW
                                                         + q * kGroup);
      const float4* k4 = reinterpret_cast<const float4*>(ks + t * RW
                                                         + q * kGroup);
      const float4* w4 = reinterpret_cast<const float4*>(ws + t * RW
                                                         + q * kGroup);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < kRows / 4; ++m) {
        const float4 rr = r4[m], kk = k4[m], ww = w4[m];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv4[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * m + e;
          const float kv = __fmul_rn(kv4[e], vj);
          acc[e] = fmaf(__fadd_rn(st[i], __fmul_rn(ur[i], kv)), rv[e],
                        acc[e]);
          st[i] = __fadd_rn(__fmul_rn(wv[e], st[i]), kv);
        }
      }
      float o = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int off = KS / 2; off > 0; off /= 2) {
        o += __shfl_xor_sync(0xffffffffu, o, off);
      }
      if (active && q == 0) {
        lm::store(out + v_base + (long long)(t0 + t) * Dv + j, o);
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s_last[(bh * DK + q * kRows + i) * Dv + j] = st[i];
    }
  }
}

template <typename X, int DK>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_last, int B,
           int H, int S, int Dv, cudaStream_t s) {
  constexpr int KS = DK / kRows;
  const int threads = min(kMaxThreads, (Dv * KS + 31) / 32 * 32);
  const dim3 grid((unsigned)(B * H), (unsigned)((Dv * KS + threads - 1)
                                                / threads));
  const size_t smem = sizeof(float) * kChunk * (3 * KS * kGroup + Dv);
  auto kern = rwkv6_kernel<X, DK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, s>>>(
      static_cast<const X*>(r), static_cast<const X*>(k),
      static_cast<const X*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<X*>(out), static_cast<float*>(s_last), H, S, Dv);
  return (int)cudaGetLastError();
}

template <typename X>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* out, void* s_last, int B,
             int H, int S, int Dk, int Dv, cudaStream_t s) {
  switch (Dk) {
    case 16:
      return launch<X, 16>(r, k, v, w, u, s0, out, s_last, B, H, S, Dv, s);
    case 32:
      return launch<X, 32>(r, k, v, w, u, s0, out, s_last, B, H, S, Dv, s);
    case 64:
      return launch<X, 64>(r, k, v, w, u, s0, out, s_last, B, H, S, Dv, s);
    case 128:
      return launch<X, 128>(r, k, v, w, u, s0, out, s_last, B, H, S, Dv, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_rwkv6(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* out, void* s_last, int B, int H, int S,
                           int Dk, int Dv, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0) return (int)cudaGetLastError();
  if (dtype == lm::kBF16) {
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_last, B, H, S,
                                   Dk, Dv, s);
  }
  return dispatch<float>(r, k, v, w, u, s0, out, s_last, B, H, S, Dk, Dv,
                         s);
}

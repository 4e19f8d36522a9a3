// rglru: the RG-LRU recurrence of recurrentgemma's recurrent blocks, for
// Hopper (sm_90a).
//
//   h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * x_t,   a_t = exp(log_a_t)
//
// Replaces the TPU kernel rglru_pallas in src/repro/kernels/rglru_scan.py;
// holds against the JAX oracle ref.rglru and the plain PyTorch version
// rglru_plain (src/repro_torch/kernels/rglru.py).  log_a float32
// [B, S, D], x float32 or bfloat16 [B, S, D], h0 float32 [B, D]; h in x's
// dtype, h_last float32.  Any S in one launch.
//
// Bound on this card: bytes.  Each element is read twice (log_a, x) and
// written once (h): at recurrentgemma-9b's prefill (B 4, S 3,072, D 4,096,
// x and h bfloat16) 403 MB, 0.12 ms at 3.35 TB/s; the arithmetic (an exp,
// a sqrt and four flops an element) is far below its rate.
//
// Design.  The recurrence is elementwise over channels and sequential in
// t, so one thread owns one (b, d) channel and walks t, its loads and
// stores coalesced along d.  The loads of later steps do not depend on h:
// each thread loads kChunk steps of log_a and x ahead into registers while
// it computes the current kChunk, so the memory latency overlaps the
// walk.  The trouble: B * D = 16,384 threads at that shape, one block of
// 128 on most SMs, walking 3,072 steps in turn, so the kernel is bound by
// the latency of each chunk's loads, not by the card's bandwidth.  The
// multiply and the add of the state are rounded separately (__fmul_rn,
// __fadd_rn), as the plain version's two tensor ops, so the state does not
// drift from it by contraction into an FMA.
#include <cuda_runtime.h>

#include "lm_dtype.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;

template <typename X>
__global__ void rglru_kernel(const float* __restrict__ log_a,
                             const X* __restrict__ x,
                             const float* __restrict__ h0,
                             X* __restrict__ h, float* __restrict__ h_last,
                             int B, int S, int D) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= (long long)B * D) return;
  const long long b = c / D, d = c % D;
  const long long base = b * S * D + d;
  float hv = h0[c];
  float la[kChunk], xv[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (u < S) {
      la[u] = log_a[base + (long long)u * D];
      xv[u] = lm::load(x + base + (long long)u * D);
    }
  }
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    float nla[kChunk], nxv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + kChunk + u;
      if (t < S) {
        nla[u] = log_a[base + (long long)t * D];
        nxv[u] = lm::load(x + base + (long long)t * D);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      if (t < S) {
        const float a = expf(la[u]);
        const float g = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f));
        hv = __fadd_rn(__fmul_rn(a, hv), __fmul_rn(g, xv[u]));
        lm::store(h + base + (long long)t * D, hv);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      la[u] = nla[u];
      xv[u] = nxv[u];
    }
  }
  h_last[c] = hv;
}

template <typename X>
void launch(const void* log_a, const void* x, const void* h0, void* h,
            void* h_last, int B, int S, int D, cudaStream_t s) {
  const long long n = (long long)B * D;
  rglru_kernel<X><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(
      static_cast<const float*>(log_a), static_cast<const X*>(x),
      static_cast<const float*>(h0), static_cast<X*>(h),
      static_cast<float*>(h_last), B, S, D);
}

}  // namespace

extern "C" int repro_rglru(const void* log_a, const void* x, const void* h0,
                           void* h, void* h_last, int B, int S, int D,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)B * D == 0) return (int)cudaGetLastError();
  if (dtype == lm::kBF16) {
    launch<__nv_bfloat16>(log_a, x, h0, h, h_last, B, S, D, s);
  } else {
    launch<float>(log_a, x, h0, h, h_last, B, S, D, s);
  }
  return (int)cudaGetLastError();
}

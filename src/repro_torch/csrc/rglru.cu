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
// Design: a staged walk that keeps the plain version's bits.  Each channel
// stays one sequential chain with the plain version's separately rounded
// operations (a = expf(log_a), g = sqrtf(fmaxf(1 - a * a, 0)), gx = g * x,
// h = a * h + gx, each multiply and add rounded on its own), so h and
// h_last are bit-identical to rglru_plain; a time-parallel scan would
// round differently.  What changes is how the bytes reach the chain.  A
// block of 256 threads owns kC = 64 channels of one batch row (256 blocks
// at B 4, D 4,096, two an SM) and streams time tiles of kT = 64 steps of
// log_a and x through a kStages = 3 ring in shared memory filled by
// cp.async (16-byte copies, coalesced along d), so up to 144 KB an SM are
// in flight instead of a few registers' worth.  Per tile: all 256 threads
// compute a and g * x of the whole tile in place, 16 independent elements
// a thread, so that the long exp and sqrt chains overlap; 64 of them walk
// their channel's 64 steps, two dependent operations a step, writing h
// over g * x; then all 256 store the tile's h rows to device memory, 16
// bytes a thread.  Shapes whose rows are not 16-byte aligned (D not a
// multiple of 8 for bfloat16 x, of 4 for float32) take the same walk with
// element-wise loads and stores.
#include <cuda_runtime.h>

#include "lm_dtype.cuh"
#include "wgmma.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_addr;

constexpr int kC = 64;         // channels a block
constexpr int kT = 64;         // steps a tile
constexpr int kStages = 3;     // tiles in flight
constexpr int kThreads = 256;

// Shared memory: the ring of (log_a then a, x) tiles, and g * x then h.
template <typename X>
struct Layout {
  static constexpr unsigned kLa = kT * kC * 4;
  static constexpr unsigned kStage = kLa + kT * kC * sizeof(X);
  static constexpr unsigned oG = kStages * kStage;
  static constexpr size_t kBytes = oG + kT * kC * 4;
};

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 o;
  unsigned* w = reinterpret_cast<unsigned*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<unsigned*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = o;
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const float* __restrict__ log_a, const X* __restrict__ x,
             const float* __restrict__ h0, X* __restrict__ h,
             float* __restrict__ h_last, int S, int D, int vec) {
  using Lt = Layout<X>;
  constexpr int EX = 16 / (int)sizeof(X);   // x elements a 16-byte copy
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  float* G = reinterpret_cast<float*>(sm + Lt::oG);
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kC;
  const int nc = min(kC, D - d0);
  const long long row0 = (long long)blockIdx.y * S;   // (b, t = 0)
  const int n_tiles = (S + kT - 1) / kT;

  // Tile i of log_a and x into its stage; zeros past S and D.
  auto load = [&](int i) {
    unsigned char* st = sm + (i % kStages) * Lt::kStage;
    float* La = reinterpret_cast<float*>(st);
    X* Xs = reinterpret_cast<X*>(st + Lt::kLa);
    const int t0 = i * kT, nt = min(kT, S - t0);
    if (vec) {
      for (int u = tid; u < kT * kC / 4; u += kThreads) {
        const int t = u / (kC / 4), c = u % (kC / 4) * 4;
        const bool ok = t < nt && c < nc;
        const long long src = ok ? (row0 + t0 + t) * D + d0 + c : 0;
        cp_async16(smem_addr(La + t * kC + c), log_a + src, ok);
      }
      for (int u = tid; u < kT * kC / EX; u += kThreads) {
        const int t = u / (kC / EX), c = u % (kC / EX) * EX;
        const bool ok = t < nt && c < nc;
        const long long src = ok ? (row0 + t0 + t) * D + d0 + c : 0;
        cp_async16(smem_addr(Xs + t * kC + c), x + src, ok);
      }
    } else {
      for (int e = tid; e < nt * kC; e += kThreads) {
        const int t = e / kC, c = e % kC;
        if (c < nc) {
          const long long src = (row0 + t0 + t) * D + d0 + c;
          La[e] = log_a[src];
          Xs[e] = x[src];
        }
      }
    }
  };

  float hv = tid < nc ? h0[blockIdx.y * (long long)D + d0 + tid] : 0.f;
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    float* La = reinterpret_cast<float*>(sm + (i % kStages) * Lt::kStage);
    const X* Xs = reinterpret_cast<const X*>(reinterpret_cast<unsigned char*>(
                                                 La) + Lt::kLa);
    const int t0 = i * kT, nt = min(kT, S - t0);
    cp_async_wait<kStages - 1>();
    __syncthreads();

    // a and g * x of the whole tile, in parallel: four adjacent channels
    // a thread at a time, several groups in flight.
#pragma unroll 4
    for (int e = 4 * tid; e < nt * kC; e += 4 * kThreads) {
      const float4 la = *reinterpret_cast<const float4*>(La + e);
      const float l4[4] = {la.x, la.y, la.z, la.w};
      float a4[4], gx4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float a = expf(l4[q]);
        const float g = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f));
        a4[q] = a;
        gx4[q] = __fmul_rn(g, lm::load(Xs + e + q));
      }
      *reinterpret_cast<float4*>(La + e) = make_float4(a4[0], a4[1], a4[2],
                                                       a4[3]);
      *reinterpret_cast<float4*>(G + e) = make_float4(gx4[0], gx4[1], gx4[2],
                                                      gx4[3]);
    }
    __syncthreads();

    // The walk: a thread a channel, h over g * x.
    if (tid < nc) {
#pragma unroll 8
      for (int t = 0; t < nt; ++t) {
        hv = __fadd_rn(__fmul_rn(La[t * kC + tid], hv), G[t * kC + tid]);
        G[t * kC + tid] = hv;
      }
    }
    __syncthreads();
    if (i + kStages < n_tiles) load(i + kStages);
    cp_async_commit();

    // h out, coalesced rows.
    if (vec) {
      for (int u = tid; u < nt * kC / EX; u += kThreads) {
        const int t = u / (kC / EX), c = u % (kC / EX) * EX;
        if (c < nc) store16(h + (row0 + t0 + t) * D + d0 + c, G + t * kC + c);
      }
    } else {
      for (int e = tid; e < nt * kC; e += kThreads) {
        const int t = e / kC, c = e % kC;
        if (c < nc) lm::store(h + (row0 + t0 + t) * D + d0 + c, G[e]);
      }
    }
  }
  cp_async_wait<0>();
  if (tid < nc) h_last[blockIdx.y * (long long)D + d0 + tid] = hv;
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename X>
int launch(const void* log_a, const void* x, const void* h0, void* h,
           void* h_last, int B, int S, int D, cudaStream_t s) {
  constexpr size_t smem = Layout<X>::kBytes;
  auto kern = rglru_kernel<X>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = D % (16 / (int)sizeof(X)) == 0 && D % 4 == 0
                  && aligned16(log_a) && aligned16(x) && aligned16(h);
  const dim3 grid((unsigned)((D + kC - 1) / kC), (unsigned)B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(log_a), static_cast<const X*>(x),
      static_cast<const float*>(h0), static_cast<X*>(h),
      static_cast<float*>(h_last), S, D, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_rglru(const void* log_a, const void* x, const void* h0,
                           void* h, void* h_last, int B, int S, int D,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)B * D == 0) return (int)cudaGetLastError();
  if (dtype == lm::kBF16) {
    return launch<__nv_bfloat16>(log_a, x, h0, h, h_last, B, S, D, s);
  }
  return launch<float>(log_a, x, h0, h, h_last, B, S, D, s);
}

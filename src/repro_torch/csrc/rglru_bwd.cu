// rglru_bwd: the gradient of the RG-LRU recurrence, for Hopper (sm_90a).
//
//   forward:  h_t = a_t * h_{t-1} + b_t * x_t,
//             a_t = exp(log_a_t),  b_t = sqrt(max(1 - a_t^2, 0))
//   backward: g_t = dh_t + a_{t+1} * g_{t+1}      (g_T = dh_T + dh_last)
//             dx_t = g_t * b_t
//             dlog_a_t = a_t * (g_t * h_{t-1} + g_t * x_t * db/da)
//             dh0 = a_1 * g_1
//
// A kernel of the port's own: the JAX package has no backward kernel and
// differentiates ops.rglru (src/repro/models/recurrent.py:62), on the CPU
// the lax.scan of ref.rglru.  Its plain PyTorch version is
// rglru_backward_plain (src/repro_torch/kernels/rglru.py).  log_a float32
// [B, S, D], x and dh float32 or bfloat16 [B, S, D] (one dtype), h0 and
// dh_last float32 [B, D] or NULL (zeros); dlog_a float32, dx in x's dtype,
// dh0 float32 (NULL: not written).  db/da follows autograd's rule through
// clamp and sqrt, -2 a (0.5 / b) where 1 - a^2 >= 0 (so -inf at a = 1
// exactly, and the product with g * x is +-inf, or NaN where g * x = 0), 0
// below, its products in the order of JAX's vjp of ref.rglru.
//
// Bound on this card: bytes.  log_a, x and dh read once, dlog_a and dx
// written once: at recurrentgemma-9b's training shape (B 1, S 4,096,
// D 4,096, x and dh bfloat16) 235 MB, 0.070 ms at 3.35 TB/s; an exp, a
// sqrt, a division and about ten flops an element are far below the rate.
//
// Design: the forward kernel's layout (csrc/rglru.cu).  A block of 256
// threads owns kC = 64 channels of one batch row, each channel one
// sequential chain with the plain version's separately rounded operations,
// so dx, dh0 and dlog_a are bit-identical to rglru_backward_plain (the
// same operations in the same order; h_{t-1} is the forward's chain
// itself).  Two passes over kT = 64-step tiles streamed through a
// kStages = 3 cp.async ring:
//   1. forward, tiles 0 .. n - 2: the h chain, writing h at the start of
//      every tile (h0 for tile 0) to a float32 scratch [B, n_tiles, D];
//   2. backward, tiles n - 1 .. 0: a, b and b * x of the tile in parallel;
//      a thread a channel recomputes h_{t-1} across the tile from its
//      checkpoint into shared memory, then walks the g chain back over it;
//      then all 256 threads compute dx and dlog_a of the tile and store
//      them in coalesced rows.
// log_a and x are read twice (the forward output h is in x's dtype and
// cannot feed an exact backward, so the forward saves nothing).  At B 1
// the grid is D / 64 blocks (64 at D 4,096): half the card's SMs, each
// walking S steps in sequence; a time-parallel scan would round
// differently.  A form that fills the card is ROADMAP B.15b.
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

// Shared memory: the ring of (log_a then a, x, dh) tiles; b, h_{t-1}, and
// b * x then g of the tile being walked.
template <typename X>
struct Layout {
  static constexpr unsigned kLa = kT * kC * 4;
  static constexpr unsigned kX = kT * kC * sizeof(X);
  static constexpr unsigned kStage = kLa + 2 * kX;
  static constexpr unsigned oB = kStages * kStage;
  static constexpr unsigned oH = oB + kT * kC * 4;
  static constexpr unsigned oG = oH + kT * kC * 4;
  static constexpr size_t kBytes = oG + kT * kC * 4;
};

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 o;
  o.x = *reinterpret_cast<unsigned*>(&lo);
  o.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = o;
}

// dx and dlog_a of one element from a, b, g, h_{t-1} and x.
__device__ __forceinline__ void grads(float a, float b, float g, float hp,
                                      float xv, float& dx, float& dla) {
  dx = __fmul_rn(g, b);
  const float gb = __fmul_rn(g, xv);
  const float t1 = __fmul_rn(g, hp);
  const float cp = __fsub_rn(1.0f, __fmul_rn(a, a));
  const float t2 =
      cp >= 0.0f
          ? -2.0f * __fmul_rn(__fmul_rn(gb, __fdiv_rn(0.5f, b)), a) : 0.0f;
  dla = __fmul_rn(__fadd_rn(t1, t2), a);
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_kernel(const float* __restrict__ log_a, const X* __restrict__ x,
                 const float* __restrict__ h0, const X* __restrict__ dh,
                 const float* __restrict__ dh_last,
                 float* __restrict__ dlog_a, X* __restrict__ dx,
                 float* __restrict__ dh0, float* __restrict__ ckpt, int S,
                 int D, int vec) {
  using Lt = Layout<X>;
  constexpr int EX = 16 / (int)sizeof(X);   // x elements a 16-byte copy
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  float* Bv = reinterpret_cast<float*>(sm + Lt::oB);
  float* Hp = reinterpret_cast<float*>(sm + Lt::oH);
  float* G = reinterpret_cast<float*>(sm + Lt::oG);
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kC;
  const int nc = min(kC, D - d0);
  const long long row0 = (long long)blockIdx.y * S;   // (b, t = 0)
  const long long bd = (long long)blockIdx.y * D + d0;
  const int n_tiles = (S + kT - 1) / kT;
  const long long ck0 = (long long)blockIdx.y * n_tiles * D + d0;

  // Tile i of log_a, x (and dh) into stage s; zeros past S and D.
  auto load = [&](int i, int s, bool with_dh) {
    unsigned char* st = sm + s * Lt::kStage;
    float* La = reinterpret_cast<float*>(st);
    X* Xs = reinterpret_cast<X*>(st + Lt::kLa);
    X* Ds = reinterpret_cast<X*>(st + Lt::kLa + Lt::kX);
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
        if (with_dh) cp_async16(smem_addr(Ds + t * kC + c), dh + src, ok);
      }
    } else {
      for (int e = tid; e < nt * kC; e += kThreads) {
        const int t = e / kC, c = e % kC;
        if (c < nc) {
          const long long src = (row0 + t0 + t) * D + d0 + c;
          La[e] = log_a[src];
          Xs[e] = x[src];
          if (with_dh) Ds[e] = dh[src];
        }
      }
    }
  };
  auto stage = [&](int s) { return sm + s * Lt::kStage; };

  // ---- 1. forward: h at the start of every tile.
  float hv = tid < nc && h0 != nullptr ? h0[bd + tid] : 0.0f;
  if (tid < nc && n_tiles > 0) ckpt[ck0 + tid] = hv;
  const int n_fwd = n_tiles - 1;   // the last tile's end is never needed
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    if (i < n_fwd) load(i, i, false);
    cp_async_commit();
  }
  for (int i = 0; i < n_fwd; ++i) {
    float* La = reinterpret_cast<float*>(stage(i % kStages));
    const X* Xs = reinterpret_cast<const X*>(stage(i % kStages) + Lt::kLa);
    cp_async_wait<kStages - 1>();
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < kT * kC; e += kThreads) {
      const float a = expf(La[e]);
      const float b = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f));
      La[e] = a;
      G[e] = __fmul_rn(b, lm::load(Xs + e));
    }
    __syncthreads();
    if (tid < nc) {
#pragma unroll 8
      for (int t = 0; t < kT; ++t) {
        hv = __fadd_rn(__fmul_rn(La[t * kC + tid], hv), G[t * kC + tid]);
      }
      ckpt[ck0 + (long long)(i + 1) * D + tid] = hv;
    }
    __syncthreads();
    if (i + kStages < n_fwd) load(i + kStages, i % kStages, false);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  __threadfence_block();

  // ---- 2. backward, the last tile first.
  float carry = tid < nc && dh_last != nullptr ? dh_last[bd + tid] : 0.0f;
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    if (j < n_tiles) load(n_tiles - 1 - j, j, true);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int i = n_tiles - 1 - j, t0 = i * kT, nt = min(kT, S - t0);
    const int s = j % kStages;
    float* La = reinterpret_cast<float*>(stage(s));
    const X* Xs = reinterpret_cast<const X*>(stage(s) + Lt::kLa);
    const X* Ds = reinterpret_cast<const X*>(stage(s) + Lt::kLa + Lt::kX);
    cp_async_wait<kStages - 1>();
    __syncthreads();

    // a, b and b * x of the tile, in parallel.
#pragma unroll 4
    for (int e = tid; e < nt * kC; e += kThreads) {
      const float a = expf(La[e]);
      const float b = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a, a)), 0.0f));
      La[e] = a;
      Bv[e] = b;
      G[e] = __fmul_rn(b, lm::load(Xs + e));
    }
    __syncthreads();

    // A thread a channel: h_{t-1} across the tile, then g back over it.
    if (tid < nc) {
      float h = ckpt[ck0 + (long long)i * D + tid];
#pragma unroll 8
      for (int t = 0; t < nt; ++t) {
        Hp[t * kC + tid] = h;
        h = __fadd_rn(__fmul_rn(La[t * kC + tid], h), G[t * kC + tid]);
      }
#pragma unroll 8
      for (int t = nt - 1; t >= 0; --t) {
        const float g = __fadd_rn(lm::load(Ds + t * kC + tid), carry);
        carry = __fmul_rn(La[t * kC + tid], g);
        G[t * kC + tid] = g;
      }
    }
    __syncthreads();

    // dx and dlog_a out, coalesced rows.
    if (vec) {
      for (int e = 4 * tid; e < nt * kC; e += 4 * kThreads) {
        const int t = e / kC, c = e % kC;
        if (c >= nc) continue;
        float ox[4], ol[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          grads(La[e + q], Bv[e + q], G[e + q], Hp[e + q],
                lm::load(Xs + e + q), ox[q], ol[q]);
        }
        const long long dst = (row0 + t0 + t) * D + d0 + c;
        store4(dx + dst, ox);
        store4(dlog_a + dst, ol);
      }
    } else {
      for (int e = tid; e < nt * kC; e += kThreads) {
        const int t = e / kC, c = e % kC;
        if (c >= nc) continue;
        float ox, ol;
        grads(La[e], Bv[e], G[e], Hp[e], lm::load(Xs + e), ox, ol);
        const long long dst = (row0 + t0 + t) * D + d0 + c;
        lm::store(dx + dst, ox);
        dlog_a[dst] = ol;
      }
    }
    __syncthreads();
    if (j + kStages < n_tiles) load(n_tiles - 1 - (j + kStages), s, true);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (tid < nc && dh0 != nullptr) dh0[bd + tid] = carry;
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename X>
int launch(const void* log_a, const void* x, const void* h0, const void* dh,
           const void* dh_last, void* dlog_a, void* dx, void* dh0,
           void* ckpt, int B, int S, int D, cudaStream_t s) {
  constexpr size_t smem = Layout<X>::kBytes;
  auto kern = rglru_bwd_kernel<X>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = D % 8 == 0 && aligned16(log_a) && aligned16(x)
                  && aligned16(dh) && aligned16(dlog_a) && aligned16(dx);
  const dim3 grid((unsigned)((D + kC - 1) / kC), (unsigned)B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(log_a), static_cast<const X*>(x),
      static_cast<const float*>(h0), static_cast<const X*>(dh),
      static_cast<const float*>(dh_last), static_cast<float*>(dlog_a),
      static_cast<X*>(dx), static_cast<float*>(dh0),
      static_cast<float*>(ckpt), S, D, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// ckpt: float32 scratch of B * ceil(S / 64) * D elements.  S = 0 writes
// dh0 = dh_last.
extern "C" int repro_rglru_bwd(const void* log_a, const void* x,
                               const void* h0, const void* dh,
                               const void* dh_last, void* dlog_a, void* dx,
                               void* dh0, void* ckpt, int B, int S, int D,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)B * D == 0) return (int)cudaGetLastError();
  if (dtype == lm::kBF16) {
    return launch<__nv_bfloat16>(log_a, x, h0, dh, dh_last, dlog_a, dx, dh0,
                                 ckpt, B, S, D, s);
  }
  return launch<float>(log_a, x, h0, dh, dh_last, dlog_a, dx, dh0, ckpt, B,
                       S, D, s);
}

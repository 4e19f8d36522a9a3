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
// Two kernels; the wrapper picks one by dtype and length:
//
// bfloat16 r, k, v and S >= 64 (the served prefill): repro_rwkv6_chunked,
// the chunked form on the tensor cores.  For a chunk of L = 64 tokens that
// starts with state S0 (t, s local, D(t, s) = prod_{s < tau < t} w_tau and
// d_t = prod_{tau < t} w_tau, all per key dimension):
//
//   out_t = S0^T (r_t * d_t) + sum_{s < t} ((r_t * D(t, s)) . k_s) v_s
//           + (r_t . (u * k_t)) v_t
//   S_end = diag(prod_tau w_tau) S0 + sum_s (k_s * D(L, s)) v_s^T
//
// Two numerical traps shape it.  (1) No logarithm and no division: w =
// exp(-exp(w0 + x W)) spans 1e-24 to 0.9975 and can be exactly 0, so the
// usual r exp(cumsum log w) / k exp(-cumsum log w) factorisation
// overflows, and even anchored per sub-chunk it loses the near-1 factors
// behind a tiny one.  Every decay factor here is instead a running product
// of w anchored at a sub-block boundary that lies between the two
// positions it joins: f_t = prod_{b_i <= tau < t} w (forward from the
// start b_i of t's 16-token sub-block) and g_s = prod_{s < tau < e_j} w
// (backward from the end e_j of s's sub-block), times whole sub-block
// products W_m between them.  Every factor is <= 1, exact to a few float32
// ulps, and underflows only where the true value does.  The intra-chunk
// matrix A(t, s) is built from 16 x 16 sub-blocks: off the diagonal,
// (r_t f_t prod_{j < m < i} W_m) . (k_s g_s), anchored at the end of s's
// sub-block (one K-hat = k * g for every row block, so the products write
// A in the layout the next product reads); on the diagonal, pairwise on
// scalar float32 FMAs with the factor accumulated step by step.  (2)
// Float32 accuracy from bf16 tensor cores: r, k and v are exact in bf16,
// but S0, r * d, r * f * W, K-hat and A are float32.  Each float32 operand
// is split into three bf16 parts (hi + mid + lo, 24 bits); a product with
// one split operand takes its three parts against the exact one, and a
// product of two split operands takes the six part-products down to 2^-18
// (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid), dropping only those
// below float32 precision; without mid.mid, bf16 outputs of a float32
// emulation of this algebra (tests/test_torch_recurrent_redesign.py) fell
// 4 ulps from the plain version.  3xTF32 was not taken: it needs both
// operands K-major, and the state and V are read transposed.
//
// The block (b, h, 64 state columns) keeps the state in registers and
// walks the chunks in order, the next chunk's r, k, v and w in flight
// through a two-stage cp.async ring (one stage at Dk 128, for shared
// memory).  Each chunk: (1) all 256 threads take the running products of w
// per key column and sub-block, forward (r * f) and backward (K-hat,
// split into three bf16 tiles), and the sub-block products W_m; (2)
// warpgroup 0 multiplies (r * d) . S0 (m64n64k16, 6 part-products, A from
// registers, S0 from three bf16 tiles) and the off-diagonal A (three
// m64n16k16 column blocks, 6 part-products), two passes in flight, while
// warpgroup 1 computes the diagonal sub-blocks on scalar FMAs (a lane per
// key pair, partials summed through shared memory) and updates the state
// by Horner over the sub-blocks, S <- W_j * S + K-hat_j^T V_j (m64n64k16,
// K-hat transposed from shared memory, 3 parts); (3) warpgroup 0 adds
// A . V (3 parts on 3 accumulators, A from registers) and stores out,
// while warpgroup 1 writes the new state as three bf16 tiles for the next
// chunk and starts the copies of chunk c + 2's r, k and w.  192 blocks at
// rwkv6-3b's prefill, one an SM (254 registers, 170 KB of shared memory),
// in two waves on 132 SMs: 0.82 ms, 17.5% of the bound; what holds it
// back is ROADMAP's B.16b.
//
// float32 r, k, v, or S < 64 (decode, short prompts): repro_rwkv6, the
// recurrent kernel.  One block per (b, h) and up to 256 / (Dk/16) state
// columns walks t; the [Dk, Dv] state never leaves registers.  Thread
// (j, q) holds rows 16q..16q+15 of state column j, so Dk/16 adjacent lanes
// share a column and add their partial outputs with warp shuffles (Dk =
// Dv = 64: 256 threads a head).  The block stages kChunk steps of r, k, w
// and v in shared memory at a time, coalesced, and syncs twice a chunk;
// each 16-row group of a staged step is padded to 20 floats so that the
// lanes of one column read their float4s from distinct banks.  The state
// update rounds its multiplies and add separately (__fmul_rn, __fadd_rn),
// as the plain version's tensor ops, so s_last does not drift from it;
// out's sum over k runs in another order than the plain version's einsum.
#include <cuda_runtime.h>

#include "lm_dtype.cuh"
#include "wgmma.cuh"

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

// ------------------------------------- bfloat16, S >= kL: the chunked form
namespace chunk {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kL = 64;                        // tokens a chunk: wgmma's M
constexpr int kSub = 16;                      // tokens a sub-block
constexpr int kNB = kL / kSub;
constexpr int kVN = 64;                       // state columns a block
constexpr int kThreads = 256;                 // two warpgroups
constexpr int kPairs = kSub * (kSub + 1) / 2; // (t, s <= t) of a sub-block

// Shared memory, from a 1,024-byte-aligned base: the ring of r, k, v
// (swizzled bf16 tiles) and w (float32 rows); the state and K-hat as three
// bf16 tiles each; r * f (float32); the diagonal sub-blocks; the
// sub-block products W_m; u; and the diagonal's reduction buffers.
template <int KP>
struct Layout {
  static constexpr int kStages = KP == 64 ? 2 : 1;
  static constexpr unsigned kRK = kL * KP * 2;
  static constexpr unsigned kV = kL * kVN * 2;
  static constexpr unsigned kW = kL * KP * 4;
  static constexpr unsigned kStage = 2 * kRK + kV + kW;
  static constexpr unsigned kSPart = KP * kVN * 2;
  static constexpr unsigned kKhPart = kL * KP * 2;
  static constexpr int kRFS = KP == 64 ? KP + 8 : KP;  // floats a row of RF
  static constexpr unsigned oS = kStages * kStage;
  static constexpr unsigned oKh = oS + 3 * kSPart;
  static constexpr unsigned oRF = oKh + 3 * kKhPart;
  static constexpr unsigned oAd = oRF + kL * kRFS * 4;
  static constexpr unsigned oWb = oAd + kNB * kPairs * 4;
  static constexpr unsigned oU = oWb + kNB * KP * 4;
  static constexpr unsigned oRed = oU + KP * 4;
  static constexpr size_t kBytes = 1024 + oRed + 4 * 32 * 33 * 4;
};

__device__ __forceinline__ float2 ld_bf2(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The three parts of (x, y) as packed bf16 pairs.
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  x -= hf.x;
  y -= hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(x, y);
  const float2 mf = __bfloat1622float2(m);
  hi = pack(h);
  mid = pack(m);
  lo = pack(__floats2bfloat162_rn(x - mf.x, y - mf.y));
}

// The part-products of two split operands kept, down to 2^-18: (A's part,
// B's part) = (0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1) for q = 0..5.
constexpr int kProducts = 6;
__device__ __forceinline__ int part_a(int q) {
  return q == 2 || q == 5 ? 1 : q == 4 ? 2 : 0;
}
__device__ __forceinline__ int part_b(int q) {
  return q == 1 || q == 5 ? 1 : q == 3 ? 2 : 0;
}

// Column block j (0..2) of d += A . B on m64n16k16: j as a template
// argument, from an unrolled loop.
__device__ __forceinline__ void wgmma_block(int j, float (&d)[32],
                                            const unsigned (&a)[4],
                                            unsigned long long db) {
  switch (j) {
    case 0: wgmma_rs_n16<0>(d, a, db); break;
    case 1: wgmma_rs_n16<1>(d, a, db); break;
    default: wgmma_rs_n16<2>(d, a, db); break;
  }
}

// Position of (t, s), s <= t, in a sub-block's list of pairs: s-major, t
// ascending from s.
__device__ __forceinline__ int pair_index(int t, int s) {
  return kSub * s - s * (s - 1) / 2 + (t - s);
}

template <int N>
__device__ __forceinline__ void fence_frags(unsigned (&f)[3][N][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) fence_regs(f[p]);
}

// One block per (b, h) and 64 state columns.  Warpgroup 0 owns the chunk's
// outputs (rows t = 16 warp + g and + 8, the m64 accumulator layout);
// warpgroup 1 owns the state (rows k = 64 mt + 16 warp + g and + 8) and
// the diagonal sub-blocks (warp i: sub-block i, a lane per key pair).
template <int KP>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_chunked(const bf16* __restrict__ r, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ s0,
              bf16* __restrict__ out, float* __restrict__ s_last, int H,
              int S, int Dk, int Dv) {
  using Lt = Layout<KP>;
  constexpr int NKC = KP / 64;          // 64-column chunks of the key width
  constexpr int RFS = Lt::kRFS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const unsigned sb = smem_addr(sm);
  float* RF = reinterpret_cast<float*>(sm + Lt::oRF);
  float* Ad = reinterpret_cast<float*>(sm + Lt::oAd);
  float* Wb = reinterpret_cast<float*>(sm + Lt::oWb);
  float* Us = reinterpret_cast<float*>(sm + Lt::oU);
  float* red = reinterpret_cast<float*>(sm + Lt::oRed);

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long bh = blockIdx.x;
  const int h = (int)(bh % H);
  const int v0 = blockIdx.y * kVN;
  const int n_chunks = (S + kL - 1) / kL;

  // Chunk c's r, k and w, and its v, into its stage, by threads first,
  // first + stride, ...; zeros past S, Dk and Dv.
  auto load_rkw = [&](int c, int first, int stride) {
    const unsigned base = sb + (c % Lt::kStages) * Lt::kStage;
    const int c0 = c * kL;
    for (int i = first; i < kL * KP / 8; i += stride) {
      const int row = i / (KP / 8), col = i % (KP / 8) * 8;
      const bool ok = c0 + row < S && col < Dk;
      const long long src = ok ? (bh * S + c0 + row) * Dk + col : 0;
      const unsigned off = swz<kL>(row, col);
      cp_async16(base + off, r + src, ok);
      cp_async16(base + Lt::kRK + off, k + src, ok);
    }
    for (int i = first; i < kL * KP / 4; i += stride) {
      const int row = i / (KP / 4), col = i % (KP / 4) * 4;
      const bool ok = c0 + row < S && col < Dk;
      const long long src = ok ? (bh * S + c0 + row) * Dk + col : 0;
      cp_async16(base + 2 * Lt::kRK + Lt::kV + (row * KP + col) * 4, w + src,
                 ok);
    }
  };
  auto load_v = [&](int c) {
    const unsigned base = sb + (c % Lt::kStages) * Lt::kStage;
    const int c0 = c * kL;
    for (int i = tid; i < kL * kVN / 8; i += kThreads) {
      const int row = i / (kVN / 8), col = i % (kVN / 8) * 8;
      const bool ok = c0 + row < S && v0 + col < Dv;
      const long long src = ok ? (bh * S + c0 + row) * Dv + v0 + col : 0;
      cp_async16(base + 2 * Lt::kRK + swz<kL>(row, col), v + src, ok);
    }
  };

  // Warpgroup 1: the state, rows k, columns v (m64n64 accumulator layout).
  float Sacc[NKC][32];
  auto write_state = [&]() {
#pragma unroll
    for (int mt = 0; mt < NKC; ++mt)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const unsigned off =
              swz<KP>(64 * mt + 16 * warp + g + 8 * rr, 8 * jj + 2 * t4);
          unsigned part[3];
          split2(Sacc[mt][4 * jj + 2 * rr], Sacc[mt][4 * jj + 2 * rr + 1],
                 part[0], part[1], part[2]);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            *reinterpret_cast<unsigned*>(sm + Lt::oS + p * Lt::kSPart + off) =
                part[p];
          }
        }
    fence_proxy_async();
  };

  for (int i = tid; i < KP; i += kThreads) {
    Us[i] = i < Dk ? u[h * Dk + i] : 0.f;
  }
  if (wg == 1) {
#pragma unroll
    for (int mt = 0; mt < NKC; ++mt)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kr = 64 * mt + 16 * warp + g + 8 * ((e >> 1) & 1);
        const int vc = v0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
        Sacc[mt][e] =
            kr < Dk && vc < Dv ? s0[(bh * Dk + kr) * Dv + vc] : 0.f;
      }
    write_state();
  }
#pragma unroll
  for (int c = 0; c < Lt::kStages; ++c) {
    if (c < n_chunks) {
      load_rkw(c, tid, kThreads);
      load_v(c);
    }
    cp_async_commit();
  }

  float O[32], A[32];   // warpgroup 0: out and the intra-chunk matrix
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kL;
    const unsigned stage = (c % Lt::kStages) * Lt::kStage;
    const unsigned char* Rs = sm + stage;
    const unsigned char* Ks = Rs + Lt::kRK;
    const float* Ws = reinterpret_cast<const float*>(Ks + Lt::kRK + Lt::kV);
    const unsigned sV = sb + stage + 2 * Lt::kRK;
    cp_async_wait<Lt::kStages - 1>();
    fence_proxy_async();   // cp.async's writes, seen by wgmma's reads
    __syncthreads();

    // (1) Running products per key column and sub-block: forward r * f
    // (float32), backward K-hat = k * g (three bf16 tiles), and W_m.
    // Steps past S are identity steps (w = 1).
    for (int it = tid; it < KP * kNB; it += kThreads) {
      const int kc = it % KP, i = it / KP;
      float pf = 1.f, pb = 1.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int tf = i * kSub + j, tb = i * kSub + kSub - 1 - j;
        const float wf = c0 + tf < S ? Ws[tf * KP + kc] : 1.f;
        const float wb = c0 + tb < S ? Ws[tb * KP + kc] : 1.f;
        RF[tf * RFS + kc] = ld_bf(Rs + swz<kL>(tf, kc)) * pf;
        bf16 part[3];
        split3(ld_bf(Ks + swz<kL>(tb, kc)) * pb, part);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          *reinterpret_cast<bf16*>(sm + Lt::oKh + p * Lt::kKhPart
                                   + swz<kL>(tb, kc)) = part[p];
        }
        pf *= wf;
        pb *= wb;
      }
      Wb[i * KP + kc] = pf;
    }
    fence_proxy_async();   // K-hat's stores, seen by wgmma's reads
    __syncthreads();

    if (wg == 0) {
      // (2a) out = (r * d) . S0 with d_t = prod_{m < warp} W_m * f_t, and
      // (2b) A off the diagonal, column block j (rows of sub-blocks warp >
      // j): (r * f * prod_{j < m < warp} W_m) . K-hat_j.  A pass (j = -1
      // for (2a); 64 key columns hk) chains 24 products on one
      // accumulator; two passes on different accumulators are in flight
      // at once, and a pass's fragments are built (in the other of two
      // buffers) under the previous pass's products.
      const int t0 = 16 * warp + g;
      auto build = [&](int j, int hk, unsigned (&fr)[3][4][4]) {
        const bool zero = j >= 0 && warp <= j;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int col = 64 * hk + 16 * kk + 8 * hf + 2 * t4;
            float2 a = make_float2(0.f, 0.f), b = a;
            if (!zero) {
              float f0 = 1.f, f1 = 1.f;
              for (int m = j + 1; m < warp; ++m) {
                f0 *= Wb[m * KP + col];
                f1 *= Wb[m * KP + col + 1];
              }
              a = *reinterpret_cast<const float2*>(RF + t0 * RFS + col);
              b = *reinterpret_cast<const float2*>(RF + (t0 + 8) * RFS + col);
              a.x *= f0;
              a.y *= f1;
              b.x *= f0;
              b.y *= f1;
            }
            split2(a.x, a.y, fr[0][kk][2 * hf], fr[1][kk][2 * hf],
                   fr[2][kk][2 * hf]);
            split2(b.x, b.y, fr[0][kk][2 * hf + 1], fr[1][kk][2 * hf + 1],
                   fr[2][kk][2 * hf + 1]);
          }
      };
      // The accumulator of pass j: O, or columns 16 j.. of A.
      auto fence_acc = [&](int j) {
        if (j < 0) {
          fence_regs(O);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            asm volatile("" : "+f"(A[8 * j + e]) :: "memory");
          }
        }
      };
      auto multiply = [&](int j, int hk, unsigned (&fr)[3][4][4]) {
        fence_acc(j);
        fence_frags(fr);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < kProducts; ++q) {
            if (j < 0) {
              wgmma_rs_t<64>(O, fr[part_a(q)][kk],
                             desc(sb + Lt::oS + part_b(q) * Lt::kSPart
                                      + (4 * hk + kk) * 16 * kRow,
                                  KP * kRow, 1024));
            } else {
              wgmma_block(j, A, fr[part_a(q)][kk],
                          desc(sb + Lt::oKh + part_b(q) * Lt::kKhPart
                                   + hk * (kL * kRow) + j * 16 * kRow
                                   + kk * 32,
                               16, 1024));
            }
          }
        wgmma_commit();
      };
      // Pass p: (2a) and j = 0 alternate over hk, then j = 1 and 2, so
      // neighbouring passes never share an accumulator.
      auto pass_j = [](int p) {
        const int which = p % 2;
        return p < 2 * NKC ? which - 1 : which + 1;
      };
#pragma unroll
      for (int e = 0; e < 32; ++e) O[e] = A[e] = 0.f;
      unsigned fr[2][3][4][4];
      constexpr int kPasses = kNB * NKC;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        build(pass_j(p), p % (2 * NKC) / 2, fr[p % 2]);
        multiply(pass_j(p), p % (2 * NKC) / 2, fr[p % 2]);
        if (p) wgmma_wait<1>();
      }
      wgmma_wait<0>();
      fence_regs(O);
      fence_regs(A);
    } else {
      // (2c) The diagonal sub-block `warp`: pairs s <= t, partial sums over
      // this lane's key pairs, then summed over the lanes through `red`.
      const int i = warp;
      float* rw = red + warp * (32 * 33);
#pragma unroll
      for (int hk = 0; hk < NKC; ++hk) {
        const int kc = 64 * hk + 2 * lane;
        float rr[kSub][2], kv[kSub][2], ww[kSub][2];
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
          const int T = i * kSub + t;
          const float2 a = ld_bf2(Rs + swz<kL>(T, kc));
          const float2 b = ld_bf2(Ks + swz<kL>(T, kc));
          const float2 d = c0 + T < S
              ? *reinterpret_cast<const float2*>(Ws + T * KP + kc)
              : make_float2(1.f, 1.f);
          rr[t][0] = a.x;
          rr[t][1] = a.y;
          kv[t][0] = b.x;
          kv[t][1] = b.y;
          ww[t][0] = d.x;
          ww[t][1] = d.y;
        }
        const float u0 = Us[kc], u1 = Us[kc + 1];
        float part[32];
        auto flush = [&](int G, int cnt) {
#pragma unroll
          for (int q = 0; q < 32; ++q) {
            if (q < cnt) rw[lane * 33 + q] = part[q];
          }
          __syncwarp();
          if (lane < cnt) {
            float sum = 0.f;
#pragma unroll
            for (int l = 0; l < 32; ++l) sum += rw[l * 33 + lane];
            float* dst = Ad + i * kPairs + 32 * G + lane;
            *dst = hk == 0 ? sum : *dst + sum;
          }
          __syncwarp();
        };
        int n = 0;
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          part[n % 32] =
              fmaf(rr[s][1] * u1, kv[s][1], rr[s][0] * u0 * kv[s][0]);
          if (++n % 32 == 0) flush(n / 32 - 1, 32);
          float f0 = 1.f, f1 = 1.f;   // prod_{s < tau < t} w_tau
#pragma unroll
          for (int t = s + 1; t < kSub; ++t) {
            part[n % 32] =
                fmaf(rr[t][1], kv[s][1] * f1, rr[t][0] * (kv[s][0] * f0));
            if (++n % 32 == 0) flush(n / 32 - 1, 32);
            f0 *= ww[t][0];
            f1 *= ww[t][1];
          }
        }
        flush(kPairs / 32, kPairs % 32);
      }

      // (2d) The state, by Horner over the sub-blocks:
      // S <- W_j * S + K-hat_j^T . V_j (rows k, K-hat from three tiles).
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int mt = 0; mt < NKC; ++mt) {
          const int kr = 64 * mt + 16 * warp + g;
          const float w0 = Wb[j * KP + kr], w1 = Wb[j * KP + kr + 8];
#pragma unroll
          for (int e = 0; e < 32; ++e) Sacc[mt][e] *= (e & 2) ? w1 : w0;
          fence_regs(Sacc[mt]);
        }
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < NKC; ++mt)
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            wgmma_ss<1, 1>(Sacc[mt],
                           desc(sb + Lt::oKh + p * Lt::kKhPart
                                    + mt * (kL * kRow) + j * 16 * kRow,
                                kL * kRow, 1024),
                           desc(sV + j * 16 * kRow, kL * kRow, 1024), 1);
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < NKC; ++mt) fence_regs(Sacc[mt]);
      }
    }
    __syncthreads();

    if (wg == 0) {
      // (3a) The diagonal sub-block of this warp's rows into A, then
      // out += A . V and the store.
      const int t0 = 16 * warp + g;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (jj / 2 != warp) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = g + 8 * (e >> 1);
          const int sl = 8 * (jj & 1) + 2 * t4 + (e & 1);
          A[4 * jj + e] =
              sl <= tl ? Ad[warp * kPairs + pair_index(tl, sl)] : 0.f;
        }
      }
      unsigned fr[3][4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          split2(A[8 * ks + 2 * q], A[8 * ks + 2 * q + 1], fr[0][ks][q],
                 fr[1][ks][q], fr[2][ks][q]);
        }
      // One accumulator a part (three chains of 4 products, not one of
      // 12), summed after.
      float T[2][32];
#pragma unroll
      for (int e = 0; e < 32; ++e) T[0][e] = T[1][e] = 0.f;
      fence_regs(O);
      fence_regs(T[0]);
      fence_regs(T[1]);
      fence_frags(fr);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const unsigned long long dv =
            desc(sV + ks * 16 * kRow, kL * kRow, 1024);
        wgmma_rs_t<64>(O, fr[0][ks], dv);
        wgmma_rs_t<64>(T[0], fr[1][ks], dv);
        wgmma_rs_t<64>(T[1], fr[2][ks], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(O);
      fence_regs(T[0]);
      fence_regs(T[1]);
#pragma unroll
      for (int e = 0; e < 32; ++e) O[e] += T[0][e] + T[1][e];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int t = c0 + t0 + 8 * rr, vc = v0 + 8 * jj + 2 * t4;
          if (t < S && vc < Dv) {
            *reinterpret_cast<__nv_bfloat162*>(out + (bh * S + t) * Dv + vc) =
                __floats2bfloat162_rn(O[4 * jj + 2 * rr],
                                      O[4 * jj + 2 * rr + 1]);
          }
        }
    } else {
      // (3b) The new state as three bf16 tiles for the next chunk's (2a);
      // r, k and w of chunk c + kStages into this stage, dead since (2).
      write_state();
      if (c + Lt::kStages < n_chunks) {
        load_rkw(c + Lt::kStages, tid - 128, 128);
      }
    }
    __syncthreads();
    if (c + Lt::kStages < n_chunks) load_v(c + Lt::kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (wg == 1) {
#pragma unroll
    for (int mt = 0; mt < NKC; ++mt)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kr = 64 * mt + 16 * warp + g + 8 * ((e >> 1) & 1);
        const int vc = v0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
        if (kr < Dk && vc < Dv) s_last[(bh * Dk + kr) * Dv + vc] = Sacc[mt][e];
      }
  }
}

template <int KP>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_last, int B,
           int H, int S, int Dk, int Dv, cudaStream_t s) {
  constexpr size_t smem = Layout<KP>::kBytes;
  auto kern = rwkv6_chunked<KP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)((Dv + kVN - 1) / kVN));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<bf16*>(out), static_cast<float*>(s_last), H, S, Dk, Dv);
  return (int)cudaGetLastError();
}

}  // namespace chunk

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

// bfloat16 r, k, v; S >= 64; Dk 16, 32, 64 or 128; Dv a multiple of 8;
// every tensor 16-byte aligned (the wrapper checks).
extern "C" int repro_rwkv6_chunked(const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* u, const void* s0, void* out,
                                   void* s_last, int B, int H, int S, int Dk,
                                   int Dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Dv == 0) return (int)cudaGetLastError();
  switch (Dk) {
    case 16:
    case 32:
    case 64:
      return chunk::launch<64>(r, k, v, w, u, s0, out, s_last, B, H, S, Dk,
                               Dv, s);
    case 128:
      return chunk::launch<128>(r, k, v, w, u, s0, out, s_last, B, H, S, Dk,
                                Dv, s);
  }
  return (int)cudaErrorInvalidValue;
}

// rwkv6_bwd: the gradient of the RWKV-6 wkv recurrence, for Hopper (sm_90a).
//
//   forward:  out_t = (S_{t-1} + (u * k_t) v_t^T)^T r_t
//             S_t   = diag(w_t) S_{t-1} + k_t v_t^T        (S: [Dk, Dv])
//   backward, dS_T = ds_last and dS_{t-1} = diag(w_t) dS_t + r_t dout_t^T:
//             dr_t = S_{t-1} dout_t + u * k_t (v_t . dout_t)
//             dk_t = dS_t v_t + u * r_t (v_t . dout_t)
//             dv_t = dS_t^T k_t + (sum_i r_t u k_t) dout_t
//             dw_t = rowsum(dS_t * S_{t-1})
//             du   = sum_{b, t} r_t * k_t (v_t . dout_t),   ds0 = dS_0
//
// A kernel of the port's own: the JAX package has no backward kernel and
// differentiates ops.rwkv6 (src/repro/models/recurrent.py:129), on the CPU
// the lax.scan of ref.rwkv6.  Its plain PyTorch version is
// rwkv6_backward_plain (src/repro_torch/kernels/rwkv6.py).  r, k, dr, dk
// [B, H, S, Dk] and v, dout, dv [B, H, S, Dv] in float32 or bfloat16 (one
// dtype); w, dw float32 [B, H, S, Dk]; u, du float32 [H, Dk]; s0, ds_last,
// ds0 float32 [B, H, Dk, Dv] or NULL (zeros; ds0 NULL: not written).  Both
// forward kernels (chunked and recurrent) feed either backward.
//
// Bound on this card: operations.  14 flops a state element and token
// (the state recomputed, w S + k v; dS, w dS + r dout; the contractions
// dS v, dS * S_{t-1}, S_{t-1} dout and dS^T k): at rwkv6-3b's training
// shape (B 1, H 48 as the model pads its 40 heads, S 4,096, Dk = Dv = 64,
// bf16) 11.27 GFLOP, 0.168 ms at the card's 67 TFLOP/s of float32 outside
// the tensor cores; the bytes (r, k, v, w, dout read, dr, dk, dv, dw
// written, 277 MB) take 0.083 ms.
//
// Two routes; the wrapper picks one by dtype and length (route, as for the
// forward):
//
// bfloat16 r, k, v and S >= 64: repro_rwkv6_bwd_chunked, split in time.
// A chain over 4,096 tokens is what holds the recurrent kernel below to
// one block per (b, h) (48 blocks on 132 SMs, each walking the sequence
// three times at ~0.33 us a token).  For a chunk of L = 64 tokens with
// local t, d_t = prod_{tau < t} w_tau, e_t = prod_{t < tau < L} w_tau and
// D(t, s) = prod_{s < tau < t} w_tau (per key dimension, the forward's
// notation, csrc/rwkv6.cu:22-30), the gradient splits in three parts:
//   1. Boundary chains, one chunk product a step over a head's chunks:
//        S_end    = diag(W) S0 + (k * e)^T V       (the forward's update)
//        dS_start = diag(W) dS_end + (r * d)^T dOut (its mirror)
//      W = prod_tau w_tau.  rwkv6_bwd_chain_kernel runs both, one block a
//      (b, h, 64 state columns, direction), 2 B H blocks, on wgmma as the
//      forward's chunked kernel does: Horner over 16-token sub-blocks with
//      running products of w anchored at a sub-block boundary (k * g from
//      the sub-block's end forward, r * f from its start backward: no
//      logarithm, no division, exact where w is 0, 1 or 1.9e-24), the
//      float32 operand split into three bf16 parts against the exact bf16
//      V or dOut (three part-products).  It writes S0 and dS_end of every
//      chunk to a float32 scratch (2 x 48 x 64 x 16 KB = 100 MB at the
//      training shape; the recurrent kernel's checkpoints take 402 MB),
//      and ds0 = dS_start of chunk 0.  A chain is latency: a chunk's step
//      is its running products (each thread one (key, sub-block) pair at
//      a time, its 16 w and X loaded into registers before the first
//      store, which would otherwise order every load behind the last
//      store), then four waits on wgmma.  One running product a key over
//      the whole chunk, anchored at the chunk's boundary (one product of
//      depth 64, one wait), measured slower on the card: its serial chain
//      of 64 steps costs more than three waits.
//   2. A chunk pass, rwkv6_bwd_chunk_kernel, one block a (b, h, chunk,
//      64 x 64 tile of the state): 3,072 blocks at the training shape.
//      dw_t = rowsum(dS_t * S_{t-1}) has no chunked form without a
//      logarithm or a division (the S_{t-1} dS_t pairs of a chunk do not
//      factor through its boundaries), so the block walks its 64 tokens
//      exactly, rounding every multiply and add as the plain version's
//      tensor ops do: forward from S0 with a checkpoint every 8 tokens
//      (shared memory, 128 KB), then interval by interval backward from
//      dS_end, the interval's 8 states recomputed into registers (thread
//      (i, q) holds row i, columns 16q..16q+15: 128 registers of states).
//      dr, dk and dv come from the same walk (the product form dv =
//      K-hat^T dS_end + A^T dOut and its transposes for dk and dr would
//      need the forward's intra-chunk matrix A on six part-products and
//      would still leave the walk for dw; it was not built, so which is
//      faster is not measured): per token three 16-term row partials,
//      summed over a row's 4 lanes by shuffles after the interval, and
//      the dv products summed over the warp's 8 rows by shuffles, then
//      over the 8 warps in a fixed order through shared memory after the
//      interval.  v and dout stay bf16 in shared memory: staged as
//      float32 they measured slower (four times the shared-memory loads,
//      with bank conflicts, against 16 conversions a token and operand).
//      A state of more than 64 rows or columns (Dk 128, Dv > 64) takes
//      several tiles, each writing float32 partials that
//      rwkv6_bwd_combine_kernel sums in tile order before the u terms.  One block an SM (199 KB of shared memory, 256
//      threads); every SM walks an equal share of the 3,072 chains.
//   3. du's sum over b and the chunks (du_sum_kernel), in (b, chunk)
//      order.  No float atomics anywhere: two calls give the same bits.
// The states S0 and dS_end differ from a sequential walk's by the chains'
// float32 rounding, so dw, du and ds0 are not bit-identical to the plain
// version (relative L2 ~1e-7 on the card's cases); dr, dk, dv round to
// bf16 as it does.  Measured at the training shape (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py's recurrent backward phase): 1.185 ms
// a call, 14% of the bound, against the recurrent kernel's 4.10; per
// launch the chunk pass 0.995 ms, the chains 0.178 (15% of the call,
// under the quarter at which saving each chunk's start state from the
// recomputed forward would pay) and du's sum 0.008.
//
// float32 r, k, v, or S < 64: repro_rwkv6_bwd, the recurrent kernel.  One
// block per (b, h).  Thread (i, q) holds row i of the state and of dS,
// columns 16q .. 16q + 15, in registers (KS = Dv / 16
// rounded up to a power of two threads a row; rows padded to fill a warp).
// The state walk is split into intervals of L tokens (8 at Dk = Dv = 64:
// L + 1 states of the block take 144 KB of shared memory):
//   1. forward, intervals 0 .. n - 2: the state, S_{t-1} at the start of
//      every interval written to a float32 scratch [B, H, n, Dk, Dv]
//      (n = ceil(S / L));
//   2. backward, intervals n - 1 .. 0: the interval's states recomputed
//      from its checkpoint into shared memory, each thread its own 16
//      values a state (no barrier), then the reverse walk over them.  The
//      walk takes no sum across threads: a token's partial row sums of
//      dk, dw and dr (16 FMAs each) go to shared memory, and its dv
//      products dS_t k_t overwrite the thread's S_{t-1}, which it no
//      longer needs.  After the interval one barrier, then the sums in a
//      fixed order (the KS partials of a row; dv's column over the rows
//      in row order), v . dout and sum_i r u k by a warp a token, all
//      written in coalesced rows.  The next interval's inputs (r, k, v,
//      w, dout) come through a two-stage cp.async ring, its checkpoint
//      through cp.async into slot L.
// A thread's 16 values of a state are four float4s stored in the order
// m ^ ((tid >> 1) & 3), so that a quarter-warp's float4 accesses hit 32
// distinct banks.  The state and dS updates round each multiply and add
// separately, as the plain version's tensor ops, so the recomputed states
// equal the forward's and ds0 is bit-identical to the plain version; the
// sums run in another order.  du's sum over b is a second launch, in b
// order.  Dk 16, 32, 64 or 128, Dv up to 128 (bfloat16: even), at most
// 1,024 threads.
#include <cuda_runtime.h>

#include "lm_dtype.cuh"
#include "wgmma.cuh"

namespace {

using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_addr;

constexpr int kCols = 16;                  // state columns a thread
constexpr int kMaxL = 64;                  // tokens an interval, at most
constexpr size_t kSmemBudget = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;

template <int DK, int KS>
struct Shape {
  static constexpr int kRowsPerWarp = 32 / KS;
  static constexpr int kDKp = DK < kRowsPerWarp ? kRowsPerWarp : DK;
  static constexpr int kThreads = kDKp * KS;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kDvp = KS * kCols;
};

__host__ __device__ constexpr size_t up16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of an interval of L tokens: L + 1 state slots (the
// interval's states S_{t-1}, which the reverse walk overwrites with its dv
// products, and the next interval's checkpoint), the row partials of dk,
// dw and dr (KS a row), v . dout and sum_i r u k a token, u, then two
// stages of (r, k, v, dout, w).
struct Plan {
  size_t oPart, oVd, oRuk, oU, oStage, kStage, kBytes;
  size_t sR, sK, sV, sD, sW;
  __host__ __device__ Plan(int L, int DKp, int KS, int Dvp, int xs) {
    oPart = up16((size_t)(L + 1) * DKp * Dvp * 4);
    oVd = oPart + up16((size_t)3 * L * DKp * KS * 4);
    oRuk = oVd + up16((size_t)L * 4);
    oU = oRuk + up16((size_t)L * 4);
    oStage = oU + up16((size_t)DKp * 4);
    sR = 0;
    sK = sR + up16((size_t)L * DKp * xs);
    sV = sK + up16((size_t)L * DKp * xs);
    sD = sV + up16((size_t)L * Dvp * xs);
    sW = sD + up16((size_t)L * Dvp * xs);
    kStage = sW + up16((size_t)L * DKp * 4);
    kBytes = oStage + 2 * kStage;
  }
};

// The interval length: the longest power of two up to kMaxL whose plan
// fits kSmemBudget.
inline int plan_L(int DKp, int KS, int Dvp, int xs) {
  int L = kMaxL;
  while (L > 1 && Plan(L, DKp, KS, Dvp, xs).kBytes > kSmemBudget) L /= 2;
  return L;
}

// 16 bytes global -> shared, asynchronously; ordered after the thread's
// earlier shared-memory reads by the compiler ("memory" clobber).
__device__ __forceinline__ void cp_async16_ordered(unsigned dst,
                                                   const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

template <typename X, int DK, int KS>
__global__ void __launch_bounds__(Shape<DK, KS>::kThreads)
rwkv6_bwd_kernel(const X* __restrict__ r, const X* __restrict__ k,
                 const X* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 const X* __restrict__ dout,
                 const float* __restrict__ ds_last, X* __restrict__ dr,
                 X* __restrict__ dk, X* __restrict__ dv,
                 float* __restrict__ dw, float* __restrict__ du_part,
                 float* __restrict__ ds0, float* __restrict__ ckpt, int H,
                 int S, int Dv, int L) {
  using Sh = Shape<DK, KS>;
  constexpr int DKp = Sh::kDKp, Dvp = Sh::kDvp, NT = Sh::kThreads;
  constexpr int NW = Sh::kWarps;
  constexpr int XS = (int)sizeof(X);
  const Plan pl(L, DKp, KS, Dvp, XS);
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  float* Sst = reinterpret_cast<float*>(sm);
  float* part = reinterpret_cast<float*>(sm + pl.oPart);
  float* vd = reinterpret_cast<float*>(sm + pl.oVd);
  float* ruk = reinterpret_cast<float*>(sm + pl.oRuk);
  float* us = reinterpret_cast<float*>(sm + pl.oU);
  auto stage = [&](int s) { return sm + pl.oStage + s * pl.kStage; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / KS, q = tid % KS, j0 = q * kCols;
  const int sw = (tid >> 1) & 3;   // float4 order of the thread's chunk
  const long long bh = blockIdx.x;
  const int h = (int)(bh % H);
  const int NC = (S + L - 1) / L;
  const long long rk0 = bh * S * DK, v0 = bh * S * Dv;
  float* ck = ckpt + bh * NC * (long long)(DKp * Dvp);
  const bool row_ok = i < DK;

  // Zero both stages (the padding of rows and columns stays zero), load u.
  for (int e = tid; e < (int)(2 * pl.kStage / 16); e += NT) {
    reinterpret_cast<float4*>(stage(0))[e] = make_float4(0, 0, 0, 0);
  }
  for (int e = tid; e < DKp; e += NT) us[e] = e < DK ? u[h * DK + e] : 0.0f;
  __syncthreads();

  // Interval c's rows of k, v, w (and r, dout) into stage s.
  auto rows = [&](const void* src, int row_bytes, int pad_bytes,
                  unsigned char* dst, long long row0, int n) {
    const int wpr = row_bytes / 4;
    const char* s8 = static_cast<const char*>(src);
    for (int e = tid; e < n * wpr; e += NT) {
      const int t = e / wpr, wi = e - t * wpr;
      cp_async4(smem_addr(dst + t * pad_bytes + wi * 4),
                s8 + (row0 + t) * row_bytes + wi * 4, true);
    }
  };
  auto stage_in = [&](int c, int s, bool all) {
    const int t0 = c * L, n = min(L, S - t0);
    unsigned char* st = stage(s);
    rows(k, DK * XS, DKp * XS, st + pl.sK, bh * S + t0, n);
    rows(v, Dv * XS, Dvp * XS, st + pl.sV, bh * S + t0, n);
    rows(w, DK * 4, DKp * 4, st + pl.sW, bh * S + t0, n);
    if (all) {
      rows(r, DK * XS, DKp * XS, st + pl.sR, bh * S + t0, n);
      rows(dout, Dv * XS, Dvp * XS, st + pl.sD, bh * S + t0, n);
    }
  };
  // The thread's 16 values of a state: checkpoint c in global memory, or
  // slot t of the interval's states in shared memory (float4 m at m ^ sw;
  // slot L holds the next checkpoint).
  auto ck_at = [&](int c) { return ck + ((long long)c * NT + tid) * kCols; };
  auto slot = [&](int t) { return Sst + ((long long)t * NT + tid) * kCols; };

  // The state update of one token: S = w S + k v^T, rounded as the plain
  // version (k v first, then w S, then the add).
  auto step = [&](float (&st)[kCols], const unsigned char* stg, int t) {
    const float ki = lm::load(reinterpret_cast<const X*>(stg + pl.sK)
                              + t * DKp + i);
    const float wi = reinterpret_cast<const float*>(stg + pl.sW)[t * DKp + i];
    const X* vr = reinterpret_cast<const X*>(stg + pl.sV) + t * Dvp + j0;
#pragma unroll
    for (int m = 0; m < kCols / 4; ++m) {
      float vv[4];
      load4(vr + 4 * m, vv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kv = __fmul_rn(ki, vv[e]);
        st[4 * m + e] = __fadd_rn(__fmul_rn(wi, st[4 * m + e]), kv);
      }
    }
  };

  // ---- 1. forward: the state at the start of every interval.
  if (NC > 0) {
    float st[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = j0 + c;
      st[c] = s0 != nullptr && row_ok && col < Dv
                  ? s0[(bh * DK + i) * Dv + col] : 0.0f;
    }
    auto store_ck = [&](int c) {
      float* p = ck_at(c);
#pragma unroll
      for (int m = 0; m < kCols / 4; ++m) {
        reinterpret_cast<float4*>(p)[m] = make_float4(
            st[4 * m], st[4 * m + 1], st[4 * m + 2], st[4 * m + 3]);
      }
    };
    store_ck(0);
    if (NC > 1) stage_in(0, 0, false);
    cp_async_commit();
    for (int c = 0; c < NC - 1; ++c) {
      cp_async_wait<0>();
      __syncthreads();
      if (c + 1 < NC - 1) stage_in(c + 1, (c + 1) & 1, false);
      cp_async_commit();
      const unsigned char* stg = stage(c & 1);
      for (int t = 0; t < L; ++t) step(st, stg, t);
      store_ck(c + 1);
    }
  }
  cp_async_wait<0>();
  __threadfence();
  __syncthreads();

  // ---- 2. backward, the last interval first.
  float ds[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = j0 + c;
    ds[c] = ds_last != nullptr && row_ok && col < Dv
                ? ds_last[(bh * DK + i) * Dv + col] : 0.0f;
  }
  float du_acc = 0.0f;   // thread i < DK: row i of du, over b's tokens
  auto ck_to_slot = [&](int c) {   // checkpoint c -> slot L
    const float* src = ck_at(c);
    float* dst = slot(L);
#pragma unroll
    for (int m = 0; m < kCols / 4; ++m) {
      cp_async16_ordered(smem_addr(dst + 4 * (m ^ sw)), src + 4 * m);
    }
  };
  if (NC > 0) {
    ck_to_slot(NC - 1);
    stage_in(NC - 1, 0, true);
  }
  cp_async_commit();
  for (int jj = 0; jj < NC; ++jj) {
    const int c = NC - 1 - jj, s = jj & 1, t0 = c * L, n = min(L, S - t0);
    cp_async_wait<0>();
    __syncthreads();
    if (c >= 1) stage_in(c - 1, s ^ 1, true);
    cp_async_commit();
    const unsigned char* stg = stage(s);
    const X* Rs = reinterpret_cast<const X*>(stg + pl.sR);
    const X* Ks = reinterpret_cast<const X*>(stg + pl.sK);
    const X* Vs = reinterpret_cast<const X*>(stg + pl.sV);
    const X* Ds = reinterpret_cast<const X*>(stg + pl.sD);
    const float* Ws = reinterpret_cast<const float*>(stg + pl.sW);

    // v . dout and sum_i r u k of every token: a warp a token.
    for (int t = warp; t < n; t += NW) {
      float a = 0.0f, b = 0.0f;
      for (int jc = lane; jc < Dvp; jc += 32) {
        a = fmaf(lm::load(Vs + t * Dvp + jc), lm::load(Ds + t * Dvp + jc),
                 a);
      }
      for (int ii = lane; ii < DKp; ii += 32) {
        b = fmaf(__fmul_rn(lm::load(Rs + t * DKp + ii), us[ii]),
                 lm::load(Ks + t * DKp + ii), b);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(kFull, a, off);
        b += __shfl_xor_sync(kFull, b, off);
      }
      if (lane == 0) {
        vd[t] = a;
        ruk[t] = b;
      }
    }

    // The interval's states S_{t-1}, from the checkpoint in slot L, which
    // then takes the next one.
    {
      float st[kCols];
      const float* p = slot(L);
#pragma unroll
      for (int m = 0; m < kCols / 4; ++m) {
        const float4 f = reinterpret_cast<const float4*>(p)[m ^ sw];
        st[4 * m] = f.x; st[4 * m + 1] = f.y;
        st[4 * m + 2] = f.z; st[4 * m + 3] = f.w;
      }
      if (c >= 1) ck_to_slot(c - 1);
      cp_async_commit();
      for (int t = 0; t < n; ++t) {
        float* d = slot(t);
#pragma unroll
        for (int m = 0; m < kCols / 4; ++m) {
          reinterpret_cast<float4*>(d)[m ^ sw] = make_float4(
              st[4 * m], st[4 * m + 1], st[4 * m + 2], st[4 * m + 3]);
        }
        step(st, stg, t);
      }
    }

    // The reverse walk: per token, the thread's row partials of dk, dw and
    // dr, and its dv products dS_t k_t over its S_{t-1} in slot t.  No
    // reduction on the way: the sums are taken after the interval.
    for (int t = n - 1; t >= 0; --t) {
      const float ri = lm::load(Rs + t * DKp + i);
      const float ki = lm::load(Ks + t * DKp + i);
      const float wi = Ws[t * DKp + i];
      float4* sp = reinterpret_cast<float4*>(slot(t));
      float pk = 0.0f, pw = 0.0f, pr = 0.0f;
#pragma unroll
      for (int m = 0; m < kCols / 4; ++m) {
        float vv[4], dd[4], pd[4];
        load4(Vs + t * Dvp + j0 + 4 * m, vv);
        load4(Ds + t * Dvp + j0 + 4 * m, dd);
        const float4 f = sp[m ^ sw];
        const float ss[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = 4 * m + e;
          pk = fmaf(ds[cc], vv[e], pk);
          pw = fmaf(ds[cc], ss[e], pw);
          pr = fmaf(ss[e], dd[e], pr);
          pd[e] = __fmul_rn(ds[cc], ki);
          ds[cc] = __fadd_rn(__fmul_rn(wi, ds[cc]), __fmul_rn(ri, dd[e]));
        }
        sp[m ^ sw] = make_float4(pd[0], pd[1], pd[2], pd[3]);
      }
      float* pp = part + ((t * 3) * DKp + i) * KS + q;
      pp[0] = pk;
      pp[DKp * KS] = pw;
      pp[2 * DKp * KS] = pr;
    }
    __syncthreads();

    // The interval's sums, written in coalesced rows: dr, dk, dw over the
    // KS partials of a row, dv over the rows' products (in row order),
    // and du's rows.
    for (int e = tid; e < n * DK; e += NT) {
      const int t = e / DK, ii = e - t * DK;
      const float* pp = part + (t * 3 * DKp + ii) * KS;
      float sk = 0.0f, sw_ = 0.0f, sr = 0.0f;
#pragma unroll
      for (int qq = 0; qq < KS; ++qq) {
        sk = __fadd_rn(sk, pp[qq]);
        sw_ = __fadd_rn(sw_, pp[DKp * KS + qq]);
        sr = __fadd_rn(sr, pp[2 * DKp * KS + qq]);
      }
      const float rv = lm::load(Rs + t * DKp + ii);
      const float kv = lm::load(Ks + t * DKp + ii);
      const long long o = rk0 + (long long)(t0 + t) * DK + ii;
      lm::store(dk + o, __fadd_rn(sk, __fmul_rn(__fmul_rn(us[ii], rv),
                                                vd[t])));
      lm::store(dr + o, __fadd_rn(sr, __fmul_rn(__fmul_rn(us[ii], kv),
                                                vd[t])));
      dw[o] = sw_;
    }
    for (int e = tid; e < n * Dv; e += NT) {
      const int t = e / Dv, jc = e - t * Dv;
      const int qj = jc / kCols, m = (jc % kCols) / 4, el = jc % 4;
      // Row i's product sits at thread i * KS + qj's chunk, float4 m at
      // m ^ sw of that thread: the swizzle repeats every 8 rows.
      int off[8];
#pragma unroll
      for (int r8 = 0; r8 < 8; ++r8) {
        const int th = r8 * KS + qj;
        off[r8] = th * kCols + 4 * (m ^ ((th >> 1) & 3)) + el;
      }
      const float* base = Sst + (long long)t * NT * kCols;
      float acc = 0.0f;
      for (int i0 = 0; i0 < DK; i0 += 8) {
#pragma unroll
        for (int r8 = 0; r8 < 8; ++r8) {
          acc = __fadd_rn(acc, base[i0 * KS * kCols + off[r8]]);
        }
      }
      acc = __fadd_rn(acc, __fmul_rn(ruk[t], lm::load(Ds + t * Dvp + jc)));
      lm::store(dv + v0 + (long long)(t0 + t) * Dv + jc, acc);
    }
    if (tid < DK) {
      for (int t = n - 1; t >= 0; --t) {
        du_acc = __fadd_rn(du_acc, __fmul_rn(__fmul_rn(
            lm::load(Rs + t * DKp + tid), lm::load(Ks + t * DKp + tid)),
            vd[t]));
      }
    }
  }
  cp_async_wait<0>();
  if (ds0 != nullptr && row_ok) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = j0 + c;
      if (col < Dv) ds0[(bh * DK + i) * Dv + col] = ds[c];
    }
  }
  if (tid < DK) du_part[bh * DK + tid] = du_acc;
}

// du[h, i] = sum over b and c of du_part[b, h, c, i], in (b, c) order
// (the sequential kernel: one c).
__global__ void du_sum_kernel(const float* __restrict__ du_part,
                              float* __restrict__ du, int B, int H, int NC,
                              int DK) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * DK) return;
  const int h = e / DK, i = e % DK;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    for (int c = 0; c < NC; ++c) {
      acc = __fadd_rn(acc, du_part[(((long long)b * H + h) * NC + c) * DK
                                   + i]);
    }
  }
  du[e] = acc;
}

struct Args {
  const void *r, *k, *v, *w, *u, *s0, *dout, *ds_last;
  void *dr, *dk, *dv, *dw, *du, *ds0, *scratch;
};

template <int DK, int KS>
long long scratch_floats(int B, int H, int S, int xs) {
  using Sh = Shape<DK, KS>;
  const int L = plan_L(Sh::kDKp, KS, Sh::kDvp, xs);
  const long long nc = (S + L - 1) / L;
  return (long long)B * H * nc * Sh::kDKp * Sh::kDvp + (long long)B * H * DK;
}

template <typename X, int DK, int KS>
int launch(const Args& a, int B, int H, int S, int Dv, cudaStream_t s) {
  using Sh = Shape<DK, KS>;
  constexpr int xs = (int)sizeof(X);
  const int L = plan_L(Sh::kDKp, KS, Sh::kDvp, xs);
  const size_t smem = Plan(L, Sh::kDKp, KS, Sh::kDvp, xs).kBytes;
  auto kern = rwkv6_bwd_kernel<X, DK, KS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long nc = (S + L - 1) / L;
  float* ckpt = static_cast<float*>(a.scratch);
  float* du_part = ckpt + (long long)B * H * nc * Sh::kDKp * Sh::kDvp;
  kern<<<(unsigned)(B * H), Sh::kThreads, smem, s>>>(
      static_cast<const X*>(a.r), static_cast<const X*>(a.k),
      static_cast<const X*>(a.v), static_cast<const float*>(a.w),
      static_cast<const float*>(a.u), static_cast<const float*>(a.s0),
      static_cast<const X*>(a.dout), static_cast<const float*>(a.ds_last),
      static_cast<X*>(a.dr), static_cast<X*>(a.dk), static_cast<X*>(a.dv),
      static_cast<float*>(a.dw), du_part, static_cast<float*>(a.ds0), ckpt,
      H, S, Dv, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int HDK = H * DK;
  du_sum_kernel<<<(unsigned)((HDK + 255) / 256), 256, 0, s>>>(
      du_part, static_cast<float*>(a.du), B, H, 1, DK);
  return (int)cudaGetLastError();
}

int key_split(int Dv) {   // KS: threads a row
  const int n = (Dv + kCols - 1) / kCols;
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 0;
}

template <typename X, int DK>
int by_split(const Args& a, int B, int H, int S, int Dv, cudaStream_t s) {
  switch (key_split(Dv)) {
    case 1: return launch<X, DK, 1>(a, B, H, S, Dv, s);
    case 2: return launch<X, DK, 2>(a, B, H, S, Dv, s);
    case 4: return launch<X, DK, 4>(a, B, H, S, Dv, s);
    case 8: return launch<X, DK, 8>(a, B, H, S, Dv, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename X>
int by_key(const Args& a, int B, int H, int S, int Dk, int Dv,
           cudaStream_t s) {
  switch (Dk) {
    case 16: return by_split<X, 16>(a, B, H, S, Dv, s);
    case 32: return by_split<X, 32>(a, B, H, S, Dv, s);
    case 64: return by_split<X, 64>(a, B, H, S, Dv, s);
    case 128: return by_split<X, 128>(a, B, H, S, Dv, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int DK>
long long scratch_by_split(int B, int H, int S, int Dv, int xs) {
  switch (key_split(Dv)) {
    case 1: return scratch_floats<DK, 1>(B, H, S, xs);
    case 2: return scratch_floats<DK, 2>(B, H, S, xs);
    case 4: return scratch_floats<DK, 4>(B, H, S, xs);
    case 8: return scratch_floats<DK, 8>(B, H, S, xs);
  }
  return -1;
}

// ----------------------------------------- bfloat16, S >= 64: split in time
namespace chunked {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kL = 64;                   // tokens a chunk
constexpr int kSub = 16;                 // tokens a sub-block
constexpr int kNB = kL / kSub;           // sub-blocks a chunk
constexpr int kT = 64;                   // state rows and columns a tile
constexpr int kChainThreads = 128;       // one warpgroup
constexpr int kPassThreads = 256;
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kPC = 16;                  // state columns a pass thread
constexpr int kIv = 8;                   // tokens an interval of the pass
constexpr int kNIv = kL / kIv;
constexpr int kCombineThreads = 256;

// 16 bfloat16 values from shared memory (32-byte aligned) as floats.
__device__ __forceinline__ void load16(const bf16* p, float (&o)[kPC]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[h];
    const unsigned w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w4[e]));
      o[8 * h + 2 * e] = f.x;
      o[8 * h + 2 * e + 1] = f.y;
    }
  }
}

// ---- 1. The boundary chains.
// Shared memory, from a 1,024-byte-aligned base: two stages of (X = k or
// r, Y = v or dout: swizzled bf16 tiles; w: float32 rows), X-hat as three
// bf16 tiles, the sub-block products W_j.
template <int KP>
struct ChainLayout {
  static constexpr unsigned kX = kL * KP * 2;
  static constexpr unsigned kY = kL * kT * 2;
  static constexpr unsigned kW = kL * KP * 4;
  static constexpr unsigned kStage = kX + kY + kW;
  static constexpr unsigned oXh = 2 * kStage;
  static constexpr unsigned oWb = oXh + 3 * kX;
  static constexpr size_t kBytes = 1024 + oWb + kNB * KP * 4;
};

// One block a (b, h), 64 state columns and direction (blockIdx.z: 0 the
// states forward, X = k, Y = v; 1 the gradients backward, X = r, Y =
// dout).  The warpgroup holds its [KP, 64] state in the m64n64 accumulator
// layout (rows 64 mt + 16 warp + g and + 8) and, per chunk, writes it to
// `states` (S0 of the chunk forward, dS_end backward), then takes the
// chunk: running products of w per key and sub-block (forward from each
// token to its sub-block's end, backward from its sub-block's start to
// the token), X-hat = X * product split into three bf16 tiles, and Horner
// over the sub-blocks, S <- W_j * S + X-hat_j^T Y_j (three part-products
// of m64n64k16).  Steps past S are identity steps (w = 1, X = 0).
template <int KP>
__global__ void __launch_bounds__(kChainThreads, 1)
rwkv6_bwd_chain_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ w,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ s0,
                       const float* __restrict__ ds_last,
                       float* __restrict__ ds0, float* __restrict__ states,
                       int S, int Dk, int Dv) {
  using Lt = ChainLayout<KP>;
  constexpr int NKC = KP / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const unsigned sb = smem_addr(sm);
  float* Wb = reinterpret_cast<float*>(sm + Lt::oWb);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long bh = blockIdx.x, BH = gridDim.x;
  const int v0 = blockIdx.y * kT;
  const bool back = blockIdx.z == 1;
  const int NC = (S + kL - 1) / kL;
  const long long DKV = (long long)Dk * Dv;
  const bf16* X = back ? r : k;
  const bf16* Y = back ? dout : v;
  float* out = states + (blockIdx.z * BH + bh) * NC * DKV;
  const int steps = back ? NC : NC - 1;
  auto chunk_of = [&](int s) { return back ? NC - 1 - s : s; };

  auto load = [&](int s) {   // step s's chunk into stage s % 2
    const int c0 = chunk_of(s) * kL;
    const unsigned base = sb + (s & 1) * Lt::kStage;
    for (int e = tid; e < kL * KP / 8; e += kChainThreads) {
      const int row = e / (KP / 8), col = e % (KP / 8) * 8;
      const bool ok = c0 + row < S && col < Dk;
      cp_async16(base + swz<kL>(row, col),
                 X + (ok ? (bh * S + c0 + row) * Dk + col : 0), ok);
    }
    for (int e = tid; e < kL * kT / 8; e += kChainThreads) {
      const int row = e / (kT / 8), col = e % (kT / 8) * 8;
      const bool ok = c0 + row < S && v0 + col < Dv;
      cp_async16(base + Lt::kX + swz<kL>(row, col),
                 Y + (ok ? (bh * S + c0 + row) * Dv + v0 + col : 0), ok);
    }
    for (int e = tid; e < kL * KP / 4; e += kChainThreads) {
      const int row = e / (KP / 4), col = e % (KP / 4) * 4;
      const bool ok = c0 + row < S && col < Dk;
      cp_async16(base + Lt::kX + Lt::kY + (row * KP + col) * 4,
                 w + (ok ? (bh * S + c0 + row) * Dk + col : 0), ok);
    }
  };

  float Sacc[NKC][32];
  const float* init = back ? ds_last : s0;
#pragma unroll
  for (int mt = 0; mt < NKC; ++mt)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int kr = 64 * mt + 16 * warp + g + 8 * ((e >> 1) & 1);
      const int vc = v0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
      Sacc[mt][e] = init != nullptr && kr < Dk && vc < Dv
                        ? init[bh * DKV + (long long)kr * Dv + vc] : 0.f;
    }
  auto store = [&](float* dst) {   // the state into a row-major [Dk, Dv]
#pragma unroll
    for (int mt = 0; mt < NKC; ++mt)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int kr = 64 * mt + 16 * warp + g + 8 * rr;
          const int vc = v0 + 8 * jj + 2 * t4;
          if (kr < Dk && vc < Dv) {
            *reinterpret_cast<float2*>(dst + (long long)kr * Dv + vc) =
                make_float2(Sacc[mt][4 * jj + 2 * rr],
                            Sacc[mt][4 * jj + 2 * rr + 1]);
          }
        }
  };

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int c = chunk_of(s), c0 = c * kL;
    store(out + c * DKV);
    const unsigned stage = (s & 1) * Lt::kStage;
    const unsigned char* Xs = sm + stage;
    const float* Ws = reinterpret_cast<const float*>(sm + stage + Lt::kX
                                                     + Lt::kY);
    cp_async_wait<1>();
    fence_proxy_async();   // cp.async's writes, seen by wgmma's reads
    __syncthreads();

    for (int it = tid; it < KP * kNB; it += kChainThreads) {
      const int kc = it % KP, i = it / KP;
      // The sub-block's w and X first, so that no store orders the loads.
      float wv[kSub], xv[kSub];
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int t = back ? i * kSub + jj : i * kSub + kSub - 1 - jj;
        wv[jj] = c0 + t < S ? Ws[t * KP + kc] : 1.f;
        xv[jj] = ld_bf(Xs + swz<kL>(t, kc));
      }
      float p = 1.f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const int t = back ? i * kSub + jj : i * kSub + kSub - 1 - jj;
        const float wt = wv[jj];
        bf16 part[3];
        split3(xv[jj] * p, part);
#pragma unroll
        for (int pp = 0; pp < 3; ++pp) {
          *reinterpret_cast<bf16*>(sm + Lt::oXh + pp * Lt::kX
                                   + swz<kL>(t, kc)) = part[pp];
        }
        p *= wt;
      }
      Wb[i * KP + kc] = p;
    }
    fence_proxy_async();   // X-hat's stores, seen by wgmma's reads
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < kNB; ++jj) {
      const int j = back ? kNB - 1 - jj : jj;
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
        for (int pp = 0; pp < 3; ++pp) {
          wgmma_ss<1, 1>(Sacc[mt],
                         desc(sb + Lt::oXh + pp * Lt::kX + mt * (kL * kRow)
                                  + j * 16 * kRow,
                              kL * kRow, 1024),
                         desc(sb + stage + Lt::kX + j * 16 * kRow,
                              kL * kRow, 1024),
                         1);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < NKC; ++mt) fence_regs(Sacc[mt]);
    }
    __syncthreads();   // the stage and X-hat are free
    if (s + 2 < steps) load(s + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (!back) {
    store(out + (NC - 1) * DKV);
  } else if (ds0 != nullptr) {
    store(ds0 + bh * DKV);
  }
}

// ---- 2. The chunk pass.
// Shared memory: the chunk's r, k rows of the tile and v, dout columns
// (bf16 [64 tokens, 64]), w (float32 [64, 64]), 8 checkpoints ([interval]
// [float4 m][thread], conflict-free), the dv partials of an interval
// ([token][warp][column]), its row sums ([token][dk, dw, dr][row]), v . dout
// and sum_i r u k a token, u.
struct PassLayout {
  static constexpr unsigned kTile = kL * kT * 2;
  static constexpr unsigned oR = 0, oK = kTile, oV = 2 * kTile,
                            oD = 3 * kTile, oW = 4 * kTile;
  static constexpr unsigned oCk = oW + kL * kT * 4;
  static constexpr unsigned oDv = oCk + kNIv * kT * kT * 4;
  static constexpr unsigned oRow = oDv + kIv * kPassWarps * kT * 4;
  static constexpr unsigned oVd = oRow + kIv * 3 * kT * 4;
  static constexpr unsigned oU = oVd + 2 * kL * 4;
  static constexpr size_t kBytes = oU + kT * 4;
};

// One block a (b, h) (x), chunk (y) and tile (z = rt * n_ct + ct).  Thread
// (i, q) = (tid / 4, tid % 4) holds row i of the tile's state and of dS,
// columns 16q .. 16q + 15, in registers; a warp holds 8 rows.  PARTIAL
// (more than one tile): float32 partials without the u terms into
// rowpart [n_ct][dk, dw, dr][B H S, Dk] and colpart [n_rt][B H S, Dv];
// else the outputs, and du's partial of the chunk.
template <bool PARTIAL>
__global__ void __launch_bounds__(kPassThreads, 1)
rwkv6_bwd_chunk_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ states, bf16* __restrict__ dr,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       float* __restrict__ dw, float* __restrict__ du_part,
                       float* __restrict__ rowpart,
                       float* __restrict__ colpart, int H, int S, int Dk,
                       int Dv) {
  using Lt = PassLayout;
  extern __shared__ float4 smem4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem4);
  const unsigned sb = smem_addr(sm);
  const bf16* Rs = reinterpret_cast<const bf16*>(sm + Lt::oR);
  const bf16* Ks = reinterpret_cast<const bf16*>(sm + Lt::oK);
  const bf16* Vs = reinterpret_cast<const bf16*>(sm + Lt::oV);
  const bf16* Ds = reinterpret_cast<const bf16*>(sm + Lt::oD);
  const float* Ws = reinterpret_cast<const float*>(sm + Lt::oW);
  float4* Ck = reinterpret_cast<float4*>(sm + Lt::oCk);
  float* dvb = reinterpret_cast<float*>(sm + Lt::oDv);
  float* rowb = reinterpret_cast<float*>(sm + Lt::oRow);
  float* vd = reinterpret_cast<float*>(sm + Lt::oVd);
  float* ruk = vd + kL;
  float* us = reinterpret_cast<float*>(sm + Lt::oU);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid >> 2, q = tid & 3, j0 = q * kPC;
  const long long bh = blockIdx.x, BH = gridDim.x;
  const int h = (int)(bh % H);
  const int c = blockIdx.y, NC = gridDim.y;
  const int n_ct = (Dv + kT - 1) / kT;
  const int rt = blockIdx.z / n_ct, ct = blockIdx.z % n_ct;
  const int r0 = rt * kT, cv0 = ct * kT;   // the tile's first row, column
  const int t0 = c * kL, n = min(kL, S - t0);
  const long long BHS = BH * S, DKV = (long long)Dk * Dv;

  // The chunk's inputs; zeros past S, Dk and Dv.
  for (int e = tid; e < kL * 8; e += kPassThreads) {
    const int t = e >> 3, u8 = (e & 7) * 8;
    const bool okr = t < n && r0 + u8 < Dk, okc = t < n && cv0 + u8 < Dv;
    const long long rs = okr ? (bh * S + t0 + t) * Dk + r0 + u8 : 0;
    const long long cs = okc ? (bh * S + t0 + t) * Dv + cv0 + u8 : 0;
    const unsigned off = (t * kT + u8) * 2;
    cp_async16(sb + Lt::oR + off, r + rs, okr);
    cp_async16(sb + Lt::oK + off, k + rs, okr);
    cp_async16(sb + Lt::oV + off, v + cs, okc);
    cp_async16(sb + Lt::oD + off, dout + cs, okc);
  }
  for (int e = tid; e < kL * 16; e += kPassThreads) {
    const int t = e >> 4, u4 = (e & 15) * 4;
    const bool ok = t < n && r0 + u4 < Dk;
    cp_async16(sb + Lt::oW + (t * kT + u4) * 4,
               w + (ok ? (bh * S + t0 + t) * Dk + r0 + u4 : 0), ok);
  }
  cp_async_commit();
  if (!PARTIAL) {
    for (int e = tid; e < kT; e += kPassThreads) {
      us[e] = e < Dk ? u[h * Dk + e] : 0.f;
    }
  }

  // S0 and dS_end of the chunk, this thread's 16 values of each.
  float st0[kPC], dS[kPC];
  {
    const float* s0p = states + (bh * NC + c) * DKV;
    const float* dEp = states + ((BH + bh) * NC + c) * DKV;
    const int gi = r0 + i;
#pragma unroll
    for (int m = 0; m < kPC / 4; ++m) {
      const int col = cv0 + j0 + 4 * m;
      const bool ok = gi < Dk && col < Dv;
      const long long o = (long long)gi * Dv + col;
      const float4 a = ok ? *reinterpret_cast<const float4*>(s0p + o)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 b = ok ? *reinterpret_cast<const float4*>(dEp + o)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      st0[4 * m] = a.x; st0[4 * m + 1] = a.y; st0[4 * m + 2] = a.z;
      st0[4 * m + 3] = a.w;
      dS[4 * m] = b.x; dS[4 * m + 1] = b.y; dS[4 * m + 2] = b.z;
      dS[4 * m + 3] = b.w;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if (!PARTIAL) {
    // v . dout and sum_i r u k of every token: a warp a token; du's
    // partial of the chunk, a thread a row.
    for (int t = warp; t < n; t += kPassWarps) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int jc = lane; jc < kT; jc += 32) {
        a = fmaf(__bfloat162float(Vs[t * kT + jc]),
                 __bfloat162float(Ds[t * kT + jc]), a);
        b = fmaf(__fmul_rn(__bfloat162float(Rs[t * kT + jc]), us[jc]),
                 __bfloat162float(Ks[t * kT + jc]), b);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(kFull, a, off);
        b += __shfl_xor_sync(kFull, b, off);
      }
      if (lane == 0) {
        vd[t] = a;
        ruk[t] = b;
      }
    }
    __syncthreads();
    if (tid < Dk) {
      float acc = 0.f;
      for (int t = n - 1; t >= 0; --t) {
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(
            __bfloat162float(Rs[t * kT + tid]),
            __bfloat162float(Ks[t * kT + tid])), vd[t]));
      }
      du_part[(bh * NC + c) * Dk + tid] = acc;
    }
  }

  // The state update of token t: S = w S + k v^T, rounded as the plain
  // version (k v, w S, then the add).
  auto step = [&](float (&st)[kPC], int t) {
    const float ki = __bfloat162float(Ks[t * kT + i]);
    const float wi = Ws[t * kT + i];
    float vv[kPC];
    load16(Vs + t * kT + j0, vv);
#pragma unroll
    for (int e = 0; e < kPC; ++e) {
      st[e] = __fadd_rn(__fmul_rn(wi, st[e]), __fmul_rn(ki, vv[e]));
    }
  };
  auto ck = [&](int m, int hq) -> float4& {
    return Ck[(m * (kPC / 4) + hq) * kPassThreads + tid];
  };

  // Forward: the state at the start of every interval.
  const int M = (n + kIv - 1) / kIv;
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int hq = 0; hq < kPC / 4; ++hq) {
      ck(m, hq) = make_float4(st0[4 * hq], st0[4 * hq + 1], st0[4 * hq + 2],
                              st0[4 * hq + 3]);
    }
    if (m + 1 < M) {
#pragma unroll
      for (int tt = 0; tt < kIv; ++tt) step(st0, m * kIv + tt);
    }
  }

  // Backward, the last interval first.
  const int b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1, b4 = (lane >> 4) & 1;
  const int q0 = lane & 1, q1 = (lane >> 1) & 1;
  for (int m = M - 1; m >= 0; --m) {
    // The interval's states S_{t-1}, recomputed from its checkpoint.
    float st[kIv][kPC];
#pragma unroll
    for (int hq = 0; hq < kPC / 4; ++hq) {
      const float4 f = ck(m, hq);
      st[0][4 * hq] = f.x; st[0][4 * hq + 1] = f.y;
      st[0][4 * hq + 2] = f.z; st[0][4 * hq + 3] = f.w;
    }
#pragma unroll
    for (int tt = 1; tt < kIv; ++tt) {
#pragma unroll
      for (int e = 0; e < kPC; ++e) st[tt][e] = st[tt - 1][e];
      step(st[tt], m * kIv + tt - 1);
    }
    // The reverse walk: per token the row partials of dk, dw, dr, and the
    // dv products dS_t k_t summed over the warp's rows.
    // acc: the row partials; dvp: the token's dv sums over the warp's
    // rows, kept in registers until the interval ends, so that no store
    // sits between one token's loads and the next's.
    float acc[3][kIv], dvp[kIv][2];
#pragma unroll
    for (int tt = kIv - 1; tt >= 0; --tt) {
      const int t = m * kIv + tt;
      if (t < n) {
        const float ri = __bfloat162float(Rs[t * kT + i]);
        const float ki = __bfloat162float(Ks[t * kT + i]);
        const float wi = Ws[t * kT + i];
        float vv[kPC], dd[kPC], pd[kPC];
        load16(Vs + t * kT + j0, vv);
        load16(Ds + t * kT + j0, dd);
        // Two chains of 8 FMAs a partial, added after.
        float pk[2] = {0.f, 0.f}, pw[2] = {0.f, 0.f}, pr[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < kPC; ++e) {
          pk[e & 1] = fmaf(dS[e], vv[e], pk[e & 1]);
          pw[e & 1] = fmaf(dS[e], st[tt][e], pw[e & 1]);
          pr[e & 1] = fmaf(st[tt][e], dd[e], pr[e & 1]);
          pd[e] = __fmul_rn(dS[e], ki);
          dS[e] = __fadd_rn(__fmul_rn(wi, dS[e]), __fmul_rn(ri, dd[e]));
        }
        acc[0][tt] = pk[0] + pk[1];
        acc[1][tt] = pw[0] + pw[1];
        acc[2][tt] = pr[0] + pr[1];
        // Over the warp's 8 rows (lane bits 2-4), halving the columns a
        // step: the lane keeps columns j0 + 8 b4 + 4 b3 + 2 b2, + 1.
        float a8[8], a4[4], a2[2];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float send = b4 ? pd[e] : pd[e + 8];
          a8[e] = (b4 ? pd[e + 8] : pd[e])
                  + __shfl_xor_sync(kFull, send, 16);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = b3 ? a8[e] : a8[e + 4];
          a4[e] = (b3 ? a8[e + 4] : a8[e]) + __shfl_xor_sync(kFull, send, 8);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float send = b2 ? a4[e] : a4[e + 2];
          a2[e] = (b2 ? a4[e + 2] : a4[e]) + __shfl_xor_sync(kFull, send, 4);
        }
        dvp[tt][0] = a2[0];
        dvp[tt][1] = a2[1];
      } else {
        acc[0][tt] = acc[1][tt] = acc[2][tt] = 0.f;
        dvp[tt][0] = dvp[tt][1] = 0.f;
      }
    }
#pragma unroll
    for (int tt = 0; tt < kIv; ++tt) {
      *reinterpret_cast<float2*>(
          dvb + (tt * kPassWarps + warp) * kT + j0 + 8 * b4 + 4 * b3
          + 2 * b2) = make_float2(dvp[tt][0], dvp[tt][1]);
    }
    // Row sums over the row's 4 lanes (bits 0-1), halving the tokens a
    // step: lane q keeps tokens 2q and 2q + 1.
    {
      float h4[3][4], h2[3][2];
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = q1 ? acc[x][e] : acc[x][e + 4];
          h4[x][e] = (q1 ? acc[x][e + 4] : acc[x][e])
                     + __shfl_xor_sync(kFull, send, 2);
        }
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float send = q0 ? h4[x][e] : h4[x][e + 2];
          h2[x][e] = (q0 ? h4[x][e + 2] : h4[x][e])
                     + __shfl_xor_sync(kFull, send, 1);
        }
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          rowb[((2 * q + e) * 3 + x) * kT + i] = h2[x][e];
        }
    }
    __syncthreads();

    // The interval's outputs, in coalesced rows: dk, dw, dr of a row, dv
    // of a column over the 8 warps in warp order, each with its u term.
    for (int e = tid; e < kIv * kT; e += kPassThreads) {
      const int tt = e / kT, ii = e % kT, t = m * kIv + tt;
      if (t >= n) continue;
      const long long tok = bh * S + t0 + t;
      if (r0 + ii < Dk) {
        const float sk = rowb[(tt * 3) * kT + ii];
        const float sw = rowb[(tt * 3 + 1) * kT + ii];
        const float sr = rowb[(tt * 3 + 2) * kT + ii];
        const long long o = tok * Dk + r0 + ii;
        if (PARTIAL) {
          float* p = rowpart + (long long)ct * 3 * BHS * Dk + o;
          p[0] = sk;
          p[BHS * Dk] = sw;
          p[2 * BHS * Dk] = sr;
        } else {
          const float rv = __bfloat162float(Rs[t * kT + ii]);
          const float kv = __bfloat162float(Ks[t * kT + ii]);
          lm::store(dk + o, __fadd_rn(sk, __fmul_rn(__fmul_rn(us[ii], rv),
                                                    vd[t])));
          lm::store(dr + o, __fadd_rn(sr, __fmul_rn(__fmul_rn(us[ii], kv),
                                                    vd[t])));
          dw[o] = sw;
        }
      }
      if (cv0 + ii < Dv) {
        float a = 0.f;
#pragma unroll
        for (int ww = 0; ww < kPassWarps; ++ww) {
          a = __fadd_rn(a, dvb[(tt * kPassWarps + ww) * kT + ii]);
        }
        const long long o = tok * Dv + cv0 + ii;
        if (PARTIAL) {
          colpart[(long long)rt * BHS * Dv + o] = a;
        } else {
          lm::store(dv + o, __fadd_rn(a, __fmul_rn(
              ruk[t], __bfloat162float(Ds[t * kT + ii]))));
        }
      }
    }
    __syncthreads();
  }
}

// ---- 2b. Several tiles: their partials summed in tile order, the u
// terms added, du's partial of the chunk.  One block a (b, h) and chunk.
__global__ void __launch_bounds__(kCombineThreads)
rwkv6_bwd_combine_kernel(const bf16* __restrict__ r,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ u,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ rowpart,
                         const float* __restrict__ colpart,
                         bf16* __restrict__ dr, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, float* __restrict__ dw,
                         float* __restrict__ du_part, int H, int S, int Dk,
                         int Dv) {
  __shared__ float vd[kL], ruk[kL];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x, BHS = (long long)gridDim.x * S;
  const int h = (int)(bh % H);
  const int c = blockIdx.y, NC = gridDim.y;
  const int t0 = c * kL, n = min(kL, S - t0);
  const int n_rt = (Dk + kT - 1) / kT, n_ct = (Dv + kT - 1) / kT;
  for (int t = warp; t < n; t += kCombineThreads / 32) {
    const long long tok = bh * S + t0 + t;
    float a = 0.f, b = 0.f;
    for (int jc = lane; jc < Dv; jc += 32) {
      a = fmaf(lm::load(v + tok * Dv + jc), lm::load(dout + tok * Dv + jc),
               a);
    }
    for (int ii = lane; ii < Dk; ii += 32) {
      b = fmaf(__fmul_rn(lm::load(r + tok * Dk + ii), u[h * Dk + ii]),
               lm::load(k + tok * Dk + ii), b);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(kFull, a, off);
      b += __shfl_xor_sync(kFull, b, off);
    }
    if (lane == 0) {
      vd[t] = a;
      ruk[t] = b;
    }
  }
  __syncthreads();
  for (int e = tid; e < n * Dk; e += kCombineThreads) {
    const int t = e / Dk, ii = e % Dk;
    const long long o = (bh * S + t0 + t) * Dk + ii;
    float sk = 0.f, sw = 0.f, sr = 0.f;
    for (int ct = 0; ct < n_ct; ++ct) {
      const float* p = rowpart + (long long)ct * 3 * BHS * Dk + o;
      sk = __fadd_rn(sk, p[0]);
      sw = __fadd_rn(sw, p[BHS * Dk]);
      sr = __fadd_rn(sr, p[2 * BHS * Dk]);
    }
    const float uu = u[h * Dk + ii];
    lm::store(dk + o, __fadd_rn(sk, __fmul_rn(__fmul_rn(uu, lm::load(r + o)),
                                              vd[t])));
    lm::store(dr + o, __fadd_rn(sr, __fmul_rn(__fmul_rn(uu, lm::load(k + o)),
                                              vd[t])));
    dw[o] = sw;
  }
  for (int e = tid; e < n * Dv; e += kCombineThreads) {
    const int t = e / Dv, jc = e % Dv;
    const long long o = (bh * S + t0 + t) * Dv + jc;
    float a = 0.f;
    for (int rt = 0; rt < n_rt; ++rt) {
      a = __fadd_rn(a, colpart[(long long)rt * BHS * Dv + o]);
    }
    lm::store(dv + o, __fadd_rn(a, __fmul_rn(ruk[t], lm::load(dout + o))));
  }
  if (tid < Dk) {
    float acc = 0.f;
    for (int t = n - 1; t >= 0; --t) {
      const long long o = (bh * S + t0 + t) * Dk + tid;
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(lm::load(r + o),
                                               lm::load(k + o)), vd[t]));
    }
    du_part[(bh * NC + c) * Dk + tid] = acc;
  }
}

struct Sizes {
  long long states, du, rowpart, colpart;
  int NC, n_rt, n_ct;
  Sizes(int B, int H, int S, int Dk, int Dv) {
    const long long BH = (long long)B * H;
    NC = (S + kL - 1) / kL;
    n_rt = (Dk + kT - 1) / kT;
    n_ct = (Dv + kT - 1) / kT;
    const bool partial = n_rt * n_ct > 1;
    states = 2 * BH * NC * Dk * Dv;
    du = BH * NC * Dk;
    rowpart = partial ? 3LL * n_ct * BH * S * Dk : 0;
    colpart = partial ? (long long)n_rt * BH * S * Dv : 0;
  }
  long long total() const { return states + du + rowpart + colpart; }
};

template <int KP>
int launch_chain(const Args& a, int B, int H, int S, int Dk, int Dv,
                 float* states, cudaStream_t s) {
  constexpr size_t smem = ChainLayout<KP>::kBytes;
  auto kern = rwkv6_bwd_chain_kernel<KP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)((Dv + kT - 1) / kT), 2);
  kern<<<grid, kChainThreads, smem, s>>>(
      static_cast<const bf16*>(a.r), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.w),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.s0),
      static_cast<const float*>(a.ds_last), static_cast<float*>(a.ds0),
      states, S, Dk, Dv);
  return (int)cudaGetLastError();
}

template <bool PARTIAL>
int launch_pass(const Args& a, const Sizes& z, int B, int H, int S, int Dk,
                int Dv, float* states, float* du_part, float* rowpart,
                float* colpart, cudaStream_t s) {
  constexpr size_t smem = PassLayout::kBytes;
  auto kern = rwkv6_bwd_chunk_kernel<PARTIAL>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)z.NC,
                  (unsigned)(z.n_rt * z.n_ct));
  kern<<<grid, kPassThreads, smem, s>>>(
      static_cast<const bf16*>(a.r), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.w),
      static_cast<const float*>(a.u), static_cast<const bf16*>(a.dout),
      states, static_cast<bf16*>(a.dr), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), static_cast<float*>(a.dw), du_part, rowpart,
      colpart, H, S, Dk, Dv);
  return (int)cudaGetLastError();
}

int launch(const Args& a, int B, int H, int S, int Dk, int Dv,
           cudaStream_t s) {
  const Sizes z(B, H, S, Dk, Dv);
  float* states = static_cast<float*>(a.scratch);
  float* du_part = states + z.states;
  float* rowpart = du_part + z.du;
  float* colpart = rowpart + z.rowpart;
  int rc = Dk == 128 ? launch_chain<128>(a, B, H, S, Dk, Dv, states, s)
                     : launch_chain<64>(a, B, H, S, Dk, Dv, states, s);
  if (rc != 0) return rc;
  const bool partial = z.n_rt * z.n_ct > 1;
  rc = partial ? launch_pass<true>(a, z, B, H, S, Dk, Dv, states, du_part,
                                   rowpart, colpart, s)
               : launch_pass<false>(a, z, B, H, S, Dk, Dv, states, du_part,
                                    rowpart, colpart, s);
  if (rc != 0) return rc;
  if (partial) {
    rwkv6_bwd_combine_kernel<<<dim3((unsigned)(B * H), (unsigned)z.NC),
                               kCombineThreads, 0, s>>>(
        static_cast<const bf16*>(a.r), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const float*>(a.u),
        static_cast<const bf16*>(a.dout), rowpart, colpart,
        static_cast<bf16*>(a.dr), static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), static_cast<float*>(a.dw), du_part, H, S,
        Dk, Dv);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  const int HDK = H * Dk;
  du_sum_kernel<<<(unsigned)((HDK + 255) / 256), 256, 0, s>>>(
      du_part, static_cast<float*>(a.du), B, H, z.NC, Dk);
  return (int)cudaGetLastError();
}

}  // namespace chunked

}  // namespace

// float32 elements of the scratch the backward needs (the interval
// checkpoints, then du's per-(b, h) partials), or -1 for a shape it does
// not take.
extern "C" int repro_rwkv6_bwd_scratch(int B, int H, int S, int Dk, int Dv,
                                       int dtype, long long* out) {
  const int xs = dtype == lm::kBF16 ? 2 : 4;
  long long n = -1;
  switch (Dk) {
    case 16: n = scratch_by_split<16>(B, H, S, Dv, xs); break;
    case 32: n = scratch_by_split<32>(B, H, S, Dv, xs); break;
    case 64: n = scratch_by_split<64>(B, H, S, Dv, xs); break;
    case 128: n = scratch_by_split<128>(B, H, S, Dv, xs); break;
  }
  *out = n;
  return n < 0 ? (int)cudaErrorInvalidValue : 0;
}

// r, k, v, dout in one dtype; w, u, s0, ds_last float32; s0, ds_last and
// ds0 may be NULL; scratch of repro_rwkv6_bwd_scratch's size.  S = 0
// writes du = 0 and ds0 = ds_last.
extern "C" int repro_rwkv6_bwd(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* dout, const void* ds_last,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du, void* ds0, void* scratch, int B,
                               int H, int S, int Dk, int Dv, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Dv == 0) return (int)cudaGetLastError();
  const Args a{r, k, v, w, u, s0, dout, ds_last, dr, dk, dv, dw, du, ds0,
               scratch};
  if (dtype == lm::kBF16) {
    return by_key<__nv_bfloat16>(a, B, H, S, Dk, Dv, s);
  }
  return by_key<float>(a, B, H, S, Dk, Dv, s);
}

// float32 elements of the chunked route's scratch (each chunk's S0 and
// dS_end, du's per-(b, h, chunk) partials, and with more than one 64 x 64
// tile of the state the tiles' partials), or -1 for a shape it does not
// take.
extern "C" int repro_rwkv6_bwd_chunked_scratch(int B, int H, int S, int Dk,
                                               int Dv, long long* out) {
  const bool ok = (Dk == 16 || Dk == 32 || Dk == 64 || Dk == 128)
                  && Dv > 0 && Dv % 8 == 0 && S > 0;
  *out = ok ? chunked::Sizes(B, H, S, Dk, Dv).total() : -1;
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// bfloat16 r, k, v, dout; w, u, s0, ds_last float32; s0, ds_last and ds0
// may be NULL; S >= 1, Dk 16, 32, 64 or 128, Dv a multiple of 8; r, k, v,
// w, dout 16-byte aligned (the wrapper checks); scratch of
// repro_rwkv6_bwd_chunked_scratch's size.
extern "C" int repro_rwkv6_bwd_chunked(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dout, const void* ds_last,
    void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
    void* scratch, int B, int H, int S, int Dk, int Dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || Dv == 0) return (int)cudaGetLastError();
  if (!(Dk == 16 || Dk == 32 || Dk == 64 || Dk == 128) || Dv % 8 || S < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{r, k, v, w, u, s0, dout, ds_last, dr, dk, dv, dw, du, ds0,
               scratch};
  return chunked::launch(a, B, H, S, Dk, Dv, s);
}

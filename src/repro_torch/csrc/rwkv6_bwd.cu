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
// forward kernels (chunked and recurrent) feed this one backward.
//
// Bound on this card: operations.  14 flops a state element and token
// (the state recomputed, w S + k v; dS, w dS + r dout; the contractions
// dS v, dS * S_{t-1}, S_{t-1} dout and dS^T k): at rwkv6-3b's training
// shape (B 1, H 40, S 4,096, Dk = Dv = 64, bf16) 9.40 GFLOP, 0.140 ms at
// the card's 67 TFLOP/s of float32 outside the tensor cores; the bytes (r,
// k, v, w, dout read, dr, dk, dv, dw written, 233 MB) take 0.069 ms.
//
// Design: a simple sequential form (a chunked form on the tensor cores is
// ROADMAP B.16c).  One block per (b, h).  Thread (i, q) holds row i of the
// state and of dS, columns 16q .. 16q + 15, in registers (KS = Dv / 16
// rounded up to a power of two threads a row; rows padded to fill a warp).
// The state walk is split into intervals of L tokens (8 at Dk = Dv = 64:
// L + 1 states of the block take 144 KB of shared memory):
//   1. forward, intervals 0 .. n - 2: the state, S_{t-1} at the start of
//      every interval written to a float32 scratch [B, H, n, Dk, Dv]
//      (n = ceil(S / L); 335 MB at rwkv6-3b's training shape);
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
// sums run in another order.  No float atomics: two calls give the same
// bits.  du's sum over b is a second launch, in b order.  Dk 16, 32, 64
// or 128, Dv up to 128 (bfloat16: even), at most 1,024 threads.
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

// du[h, i] = sum over b of du_part[b, h, i], in b order.
__global__ void du_sum_kernel(const float* __restrict__ du_part,
                              float* __restrict__ du, int B, int HDK) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= HDK) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    acc = __fadd_rn(acc, du_part[(long long)b * HDK + e]);
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
      du_part, static_cast<float*>(a.du), B, HDK);
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

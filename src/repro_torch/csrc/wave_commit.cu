// wave_commit: the probe-family wave (claim install + probe + lane verdicts
// + version bumps) for Hopper (sm_90a).
//
// Replaces the TPU kernel wave_commit_pallas in
// src/repro/kernels/wave_commit.py; holds against the JAX oracle
// ref.wave_commit (src/repro/kernels/ref.py) and its plain PyTorch version
// wave_commit_plain (src/repro_torch/kernels/wave_commit.py).
//
// Bound on this card: bytes, and far below any launch.  At the main path's
// largest wave (T=128 lanes x K=64 slots, G=2 groups) one call reads the
// op vectors (~14 B x 8192 ops), one claim word per op (a row of 8 B when
// coarse) and writes at most one claim word and one conflict byte per op,
// plus one version word read and written per committed write: under
// 200 KB, i.e. well under 0.1 us at 3.35 TB/s.  Launch latency and
// the dependent row loads set the time.
//
// Design.  The Pallas kernel answers every probe from one row fetch plus an
// all-pairs wave term, which relies on the TPU's sequential grid.  Blocks
// on Hopper run in no order, so the wave is two launches on one stream:
//   1. install: one thread per op atomicMin's its claim word
//      (inv_wave << 16 | prio16) into claim_w (and claim_r when dual);
//   2. verdict: one block per lane, its threads striding over the lane's
//      ops (one op each up to 1,024 ops; the sharded owner's rows of one
//      source shard hold up to 4 x the fair share, 16,384 ops at one shard
//      with 256 lanes of 16).  The launch boundary is the grid-wide
//      barrier, so every probe reads the post-install table, which is
//      exactly ref.claim_probe_fused's answer.  Each thread ORs its ops'
//      verdicts, the block reduces them with __syncthreads_or, and
//      committed writers then atomicAdd 1 to their wts cell (bump) in a
//      second stride over the lane.
// min and + are commutative, so the result does not depend on the order in
// which blocks or atomics run.  Masked ops (key outside [0, N) or group
// outside [0, G)) install nothing and probe NO_PRIO.
#include "claim.cuh"

namespace {

using claim::kNoPrio;
using claim::probe;

__global__ void install_kernel(unsigned* __restrict__ claim_w,
                               unsigned* __restrict__ claim_r,
                               const int* __restrict__ keys,
                               const int* __restrict__ groups,
                               const int* __restrict__ prio,
                               const bool* __restrict__ do_w,
                               const bool* __restrict__ do_r, int n, int N,
                               int G, unsigned ivw, int dual) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int key = keys[i];
  int g = groups[i];
  if (!claim::in_cell(key, g, N, G)) return;
  const unsigned word = claim::word(ivw, prio[i]);
  const size_t cell = (size_t)key * G + g;
  if (do_w[i]) atomicMin(claim_w + cell, word);
  if (dual && do_r[i]) atomicMin(claim_r + cell, word);
}

__global__ void verdict_kernel(const unsigned* __restrict__ claim_w,
                               const unsigned* __restrict__ claim_r,
                               unsigned* __restrict__ wts,
                               const int* __restrict__ keys,
                               const int* __restrict__ groups,
                               const int* __restrict__ prio,
                               const bool* __restrict__ do_w,
                               const bool* __restrict__ check_w,
                               const bool* __restrict__ check_w2,
                               const bool* __restrict__ check_r,
                               const bool* __restrict__ extra,
                               bool* __restrict__ conflict,
                               bool* __restrict__ commit, int K, int N,
                               int G, unsigned ivw, int fine, int dual,
                               int bump) {
  const int t = blockIdx.x;
  const size_t row = (size_t)t * K;
  bool any = false;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const size_t i = row + k;
    const int key = keys[i];
    const int g = groups[i];
    const unsigned p = (unsigned)prio[i];
    const unsigned wp = probe(claim_w, key, g, N, G, ivw, fine);
    bool c = check_w[i] && wp < p;
    if (check_w2 != nullptr)
      c = c || (check_w2[i] && wp != kNoPrio && wp != p);
    if (dual && check_r != nullptr) {
      const unsigned rp = probe(claim_r, key, g, N, G, ivw, fine);
      c = c || (check_r[i] && rp < p);
    }
    if (extra != nullptr) c = c || extra[i];
    conflict[i] = c;
    any = any || c;
  }
  // Every thread of the block reaches the barrier, idle threads too.
  const bool ok = __syncthreads_or(any) == 0;
  if (threadIdx.x == 0) commit[t] = ok;
  if (!(bump && ok)) return;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const size_t i = row + k;
    const int key = keys[i];
    const int g = groups[i];
    if (do_w[i] && claim::in_cell(key, g, N, G))
      atomicAdd(wts + (size_t)key * G + g, 1u);
  }
}

}  // namespace

extern "C" int repro_wave_commit(
    void* claim_w, void* claim_r, void* wts, const void* keys,
    const void* groups, const void* prio, const void* do_w, const void* do_r,
    const void* check_w, const void* check_w2, const void* check_r,
    const void* extra, void* conflict, void* commit, int T, int K, int N,
    int G, int ivw, int fine, int dual, int bump, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = T * K;
  if (n > 0) {
    install_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<unsigned*>(claim_w), static_cast<unsigned*>(claim_r),
        static_cast<const int*>(keys), static_cast<const int*>(groups),
        static_cast<const int*>(prio), static_cast<const bool*>(do_w),
        static_cast<const bool*>(do_r), n, N, G, (unsigned)ivw, dual);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int threads = K < 1024 ? ((K + 31) / 32) * 32 : 1024;
    verdict_kernel<<<T, threads, 0, s>>>(
        static_cast<const unsigned*>(claim_w),
        static_cast<const unsigned*>(claim_r), static_cast<unsigned*>(wts),
        static_cast<const int*>(keys), static_cast<const int*>(groups),
        static_cast<const int*>(prio), static_cast<const bool*>(do_w),
        static_cast<const bool*>(check_w), static_cast<const bool*>(check_w2),
        static_cast<const bool*>(check_r), static_cast<const bool*>(extra),
        static_cast<bool*>(conflict), static_cast<bool*>(commit), K, N, G,
        (unsigned)ivw, fine, dual, bump);
  }
  return (int)cudaGetLastError();
}

// claim_probe: claim install + post-install strongest-claimant probe on one
// claim table, for Hopper (sm_90a).
//
// Replaces the TPU kernel claim_probe_fused_pallas in
// src/repro/kernels/claim_probe.py; holds against the JAX oracle
// ref.claim_probe_fused and the plain PyTorch version claim_probe_plain
// (src/repro_torch/kernels/claim_probe.py).  It min-installs the claim word
// (inv_wave << 16) | prio16 of every masked op, then returns for EVERY op
// the strongest live claimant prio16 of the post-install table: the op's own
// cell (fine) or the min over its row (coarse), kNoPrio where the key or
// the group is masked or nobody claims.
//
// Bound on this card: bytes, and far below two launches.  Per op it reads a
// key, a group, a priority and a mask byte (13 B) and writes a 4-byte
// answer; each distinct probed cell (a row when coarse) is read once and
// each distinct installed cell written once: at T=128, K=64 under 250 KB,
// under 0.08 us at 3.35 TB/s.  Launch latency sets the time.
//
// Design.  The Pallas kernel answers from one row DMA plus an all-pairs
// in-VMEM wave term, which relies on the TPU's sequential grid and on the
// monotone-tag precondition.  Blocks on Hopper run in no order, so this is
// two launches on one stream, as in wave_commit.cu: an atomicMin install of
// the masked ops, then one thread per op probing the installed table.  The
// launch boundary is the grid-wide barrier, so the answer is the literal
// install-then-probe and needs no precondition.
#include "claim.cuh"

namespace {

__global__ void install_kernel(unsigned* __restrict__ table,
                               const int* __restrict__ keys,
                               const int* __restrict__ groups,
                               const int* __restrict__ prio,
                               const bool* __restrict__ mask, int n, int N,
                               int G, unsigned ivw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  const int key = keys[i];
  const int g = groups[i];
  if (claim::in_cell(key, g, N, G))
    atomicMin(table + (size_t)key * G + g, claim::word(ivw, prio[i]));
}

__global__ void probe_kernel(const unsigned* __restrict__ table,
                             const int* __restrict__ keys,
                             const int* __restrict__ groups,
                             int* __restrict__ out, int n, int N, int G,
                             unsigned ivw, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (int)claim::probe(table, keys[i], groups[i], N, G, ivw, fine);
}

}  // namespace

extern "C" int repro_claim_probe(void* table, const void* keys,
                                 const void* groups, const void* prio,
                                 const void* mask, void* out, int n, int N,
                                 int G, int ivw, int fine, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int blocks = (n + 255) / 256;
    install_kernel<<<blocks, 256, 0, s>>>(
        static_cast<unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const int*>(prio),
        static_cast<const bool*>(mask), n, N, G, (unsigned)ivw);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    probe_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<int*>(out), n, N, G,
        (unsigned)ivw, fine);
  }
  return (int)cudaGetLastError();
}

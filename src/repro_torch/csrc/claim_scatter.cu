// claim_scatter: pack claim words and scatter-min them into a claim table,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel claim_scatter_pallas in
// src/repro/kernels/claim_scatter.py; holds against the JAX oracle
// ref.claim_scatter and the plain PyTorch version claim_scatter_plain
// (src/repro_torch/kernels/claim_scatter.py).  For every masked op with a
// cell inside the table: table[key, group] = min(table[key, group],
// (inv_wave << 16) | prio16), unsigned.
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a key,
// a group, a priority and a mask byte (13 B) and read-modify-writes one
// 4-byte word per distinct installed cell: at T=128, K=64 under 200 KB,
// under 0.06 us at 3.35 TB/s.  Launch latency sets the time.
//
// Design.  The TPU kernel packs the word in registers and walks the ops on a
// sequential grid with the table aliased in and out.  Here one thread per op
// packs the word and calls atomicMin on unsigned: min is commutative and
// idempotent, so any order of the atomics gives the sequential grid's table.
#include "claim.cuh"

namespace {

__global__ void claim_scatter_kernel(unsigned* __restrict__ table,
                                     const int* __restrict__ keys,
                                     const int* __restrict__ groups,
                                     const int* __restrict__ prio,
                                     const bool* __restrict__ mask,
                                     const long long* __restrict__ wave,
                                     int n, int N, int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  const int key = keys[i];
  const int g = groups[i];
  if (claim::in_cell(key, g, N, G))
    atomicMin(table + (size_t)key * G + g,
              claim::word(claim::inv_wave_at(wave), prio[i]));
}

}  // namespace

extern "C" int repro_claim_scatter(void* table, const void* keys,
                                   const void* groups, const void* prio,
                                   const void* mask, const void* wave, int n,
                                   int N, int G, void* stream) {
  if (wave == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    claim_scatter_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const int*>(prio),
        static_cast<const bool*>(mask), static_cast<const long long*>(wave),
        n, N, G);
  }
  return (int)cudaGetLastError();
}

// commit_install: +1 version bump per committed write op, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel occ_commit_pallas in
// src/repro/kernels/occ_commit.py; holds against the JAX oracle
// ref.occ_commit and the plain PyTorch version commit_install_plain
// (src/repro_torch/kernels/occ_commit.py).  For every op with `do` set and
// a cell inside the table, wts[key, group] += 1 (uint32, wrapping).
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a key,
// a group and a mask byte (9 B) and read-modify-writes one 4-byte word per
// distinct committed-write cell: at T=128, K=64 under 150 KB, under 0.05 us
// at 3.35 TB/s.  Launch latency sets the time.
//
// Design.  The TPU kernel walks the ops on a sequential grid with wts aliased
// in and out.  Here one thread per op calls atomicAdd: addition is
// commutative and wraps mod 2^32 like uint32 in JAX, so any order of the
// atomics gives the sequential grid's table.
#include "claim.cuh"

namespace {

__global__ void commit_install_kernel(unsigned* __restrict__ wts,
                                      const int* __restrict__ keys,
                                      const int* __restrict__ groups,
                                      const bool* __restrict__ do_, int n,
                                      int N, int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !do_[i]) return;
  const int key = keys[i];
  const int g = groups[i];
  if (claim::in_cell(key, g, N, G)) atomicAdd(wts + (size_t)key * G + g, 1u);
}

}  // namespace

extern "C" int repro_commit_install(void* wts, const void* keys,
                                    const void* groups, const void* do_,
                                    int n, int N, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    commit_install_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<unsigned*>(wts), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const bool*>(do_), n, N,
        G);
  }
  return (int)cudaGetLastError();
}

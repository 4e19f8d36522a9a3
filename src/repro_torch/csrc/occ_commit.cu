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
//
// With packed commit words (the sharded owner's install: ops in rows of
// `row`, words in verdict_pack.cu's wire format, W a row) op i = d * row
// + j bumps only where do[i] and its 2-bit field of word j/16 of row d is
// non-zero: the owner's verdict_unpack launch and the torch compare and
// mask before this one, folded in (4 bytes read a 16 ops in place of the
// mask's byte an op).
#include "claim.cuh"
#include "verdict_word.cuh"

namespace {

__global__ void commit_install_kernel(unsigned* __restrict__ wts,
                                      const int* __restrict__ keys,
                                      const int* __restrict__ groups,
                                      const bool* __restrict__ do_,
                                      const unsigned* __restrict__ words,
                                      int n, int N, int G, int row, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !do_[i]) return;
  if (words != nullptr && verdict::field(words, i, row, W) == 0u) return;
  const int key = keys[i];
  const int g = groups[i];
  if (claim::in_cell(key, g, N, G)) atomicAdd(wts + (size_t)key * G + g, 1u);
}

}  // namespace

// words: null, or int32[n / row, W] packed commit words (n a multiple of
// row, W = ceil(row / 16)).
extern "C" int repro_commit_install(void* wts, const void* keys,
                                    const void* groups, const void* do_,
                                    const void* words, int n, int N, int G,
                                    int row, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words != nullptr && !verdict::valid_rows(n, row, W))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    commit_install_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<unsigned*>(wts), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const bool*>(do_),
        static_cast<const unsigned*>(words), n, N, G, row, W);
  }
  return (int)cudaGetLastError();
}

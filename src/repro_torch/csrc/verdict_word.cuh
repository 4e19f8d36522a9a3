// The sharded wave's verdict wire format, the one definition of its
// layout for every kernel that writes or reads it (sm_90a).
//
// Ops come in rows of `row` ops, op i = d * row + j; its 2-bit field sits
// at bits 2*(j%16) and 2*(j%16)+1 of word j/16 of row d, W = ceil(row/16)
// words a row (src/repro_torch/kernels/verdict_pack.py).  verdict_pack.cu
// packs and unpacks whole rows and the sender's gathers, wave_commit.cu
// and claim_probe.cu write the owner's verdict words inside their claim
// launch, iterate_validate.cu ORs scan verdicts into them, and
// occ_commit.cu and mv_install.cu read the commit words.
#pragma once

#include <cuda_runtime.h>

namespace verdict {

// Ops a word.
constexpr int kOps = 16;

// Words of a row of `row` ops.
__host__ __device__ __forceinline__ int words_of(int row) {
  return (row + kOps - 1) / kOps;
}

// The word of op j of a row, and the shift of its field in that word.
__host__ __device__ __forceinline__ int word_of(int j) { return j / kOps; }
__host__ __device__ __forceinline__ int shift_of(int j) {
  return 2 * (j % kOps);
}

// The host's check of a words form's shape: n ops in whole rows.
inline bool valid_rows(int n, int row, int W) {
  return row > 0 && n % row == 0 && W == words_of(row);
}

// Op j's 2-bit field of the word that holds it.
__device__ __forceinline__ unsigned get(unsigned word, int j) {
  return (word >> shift_of(j)) & 3u;
}

// Op i's 2-bit field.
__device__ __forceinline__ unsigned field(const unsigned* words, int i,
                                          int row, int W) {
  const int d = i / row;
  const int j = i - d * row;
  return get(words[(size_t)d * W + word_of(j)], j);
}

// OR the 2-bit value v into op i's field.  A word's 16 ops may lie in two
// warps (row is a multiple of 8, not of 16), so the OR is atomic.
__device__ __forceinline__ void or_field(unsigned* words, int i, int row,
                                         int W, unsigned v) {
  const int d = i / row;
  const int j = i - d * row;
  atomicOr(words + (size_t)d * W + word_of(j), v << shift_of(j));
}

}  // namespace verdict

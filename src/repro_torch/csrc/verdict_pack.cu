// verdict_pack / verdict_unpack: the sharded wave's 2-bit verdict wire
// format, for Hopper (sm_90a).
//
// Replaces the TPU kernels verdict_pack_pallas and verdict_unpack_pallas in
// src/repro/kernels/verdict_pack.py; holds against the JAX oracles
// ref.verdict_pack / ref.verdict_unpack and the plain PyTorch versions
// verdict_pack_plain / verdict_unpack_plain
// (src/repro_torch/kernels/verdict_pack.py).  Op j of a row keeps its low
// two bits at bits 2*(j%16) and 2*(j%16)+1 of word j/16; a row of M ops
// packs into ceil(M/16) int32 words, the last one padded with zero fields
// (the layout is verdict_word.cuh's).
//
// Bound on this card: bytes, and far below a launch.  At the one-card
// sharded wave (one row of cap = 16,384 ops) pack reads 16 KB and writes
// 4 KB, unpack the reverse: about 6 ns at 3.35 TB/s.  The gather forms
// move little more: the sender's unpack reads 10 B an op (owner, pos, took;
// a byte out) and the words, its pack 4 B a buffer cell (the lane id), a
// commit byte a lane and 4 B a 16 cells out.  Launch latency sets the time.
//
// Design.  The Pallas kernels build each word with a word-by-op one-hot
// select over the whole row in VMEM.  Here every thread owns one output
// element: pack reads its word's 16 bytes and ORs the shifted fields;
// unpack reads one word and shifts its op's field out.  No thread writes
// another's element, so there are no atomics and no barriers.
//
// Since the launch, not the body, sets the time, the sharded wave calls
// each kernel once a wave, in the gather form that takes the torch ops
// around it into the launch (the owner side packs inside its claim
// launch and unpacks inside its install launch):
//   - repro_verdict_unpack_gather, the sender's verdicts: op i reads word
//     (owner[i], pos[i] / 16) of the arrived rows and returns its field, 0
//     where took[i] is false (or its coordinates lie outside the rows);
//     one thread an op.  It replaces the full-row unpack, the gather at
//     the routing coordinates and the mask.
//   - repro_verdict_pack_gather, the sender's commit bits: word w of row d
//     packs, for each of its 16 buffer cells, the commit byte of the lane
//     that cell carries (lane[d, j] from route_pack's lane channel; -1 for
//     an empty cell, which packs 0); one thread a word.  It replaces the
//     lane gather, its mask and casts, and the full-row pack.
#include <cuda_runtime.h>

#include "verdict_word.cuh"

namespace {

using verdict::kOps;

__global__ void verdict_pack_kernel(const signed char* __restrict__ v,
                                    int* __restrict__ words, int D, int M,
                                    int W) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)D * W) return;
  const int d = (int)(idx / W);
  const int w = (int)(idx % W);
  const signed char* row = v + (size_t)d * M;
  // Word w starts at op w * kOps, so its op w * kOps + k sits at
  // shift_of(k): a constant once the loop is unrolled.
  const int j0 = w * kOps;
  unsigned word = 0u;
#pragma unroll
  for (int k = 0; k < kOps; ++k)
    if (j0 + k < M)
      word |= ((unsigned)(unsigned char)row[j0 + k] & 3u)
              << verdict::shift_of(k);
  words[idx] = (int)word;
}

__global__ void verdict_unpack_kernel(const int* __restrict__ words,
                                      signed char* __restrict__ out, int D,
                                      int W, int n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)D * n) return;
  const int d = (int)(idx / n);
  const int j = (int)(idx % n);
  const unsigned word = (unsigned)words[(size_t)d * W + verdict::word_of(j)];
  out[idx] = (signed char)verdict::get(word, j);
}

__global__ void verdict_unpack_gather_kernel(
    const int* __restrict__ words, const int* __restrict__ owner,
    const int* __restrict__ pos, const bool* __restrict__ took,
    signed char* __restrict__ out, int M, int D, int W, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  unsigned v = 0u;
  if (took[i]) {
    const int d = owner[i];
    const int j = pos[i];
    if (d >= 0 && d < D && j >= 0 && j < n)
      v = verdict::get(
          (unsigned)words[(size_t)d * W + verdict::word_of(j)], j);
  }
  out[i] = (signed char)v;
}

__global__ void verdict_pack_gather_kernel(const unsigned char* __restrict__ v,
                                           const int* __restrict__ lane,
                                           int* __restrict__ words, int T,
                                           int D, int M, int W) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)D * W) return;
  const int d = (int)(idx / W);
  const int w = (int)(idx % W);
  const int* row = lane + (size_t)d * M;
  // All 16 lane loads in flight, then all 16 byte loads: two dependent
  // round trips a word, not 32.  As in verdict_pack_kernel, op j0 + k
  // sits at shift_of(k).
  const int j0 = w * kOps;
  int l[kOps];
#pragma unroll
  for (int k = 0; k < kOps; ++k) l[k] = j0 + k < M ? row[j0 + k] : -1;
  unsigned word = 0u;
#pragma unroll
  for (int k = 0; k < kOps; ++k)
    if (l[k] >= 0 && l[k] < T)
      word |= ((unsigned)v[l[k]] & 3u) << verdict::shift_of(k);
  words[idx] = (int)word;
}

}  // namespace

extern "C" int repro_verdict_pack(const void* v, void* words, int D, int M,
                                  int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)D * W;
  if (n > 0) {
    verdict_pack_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const signed char*>(v), static_cast<int*>(words), D, M,
        W);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_verdict_unpack(const void* words, void* out, int D,
                                    int W, int n_ops, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)D * n_ops;
  if (n > 0) {
    verdict_unpack_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const int*>(words), static_cast<signed char*>(out), D, W,
        n_ops);
  }
  return (int)cudaGetLastError();
}

// words int32[D, W] (W * 16 >= n), owner/pos int32[M], took bool[M] ->
// out int8[M].
extern "C" int repro_verdict_unpack_gather(const void* words,
                                           const void* owner, const void* pos,
                                           const void* took, void* out, int M,
                                           int D, int W, int n,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    verdict_unpack_gather_kernel<<<(M + 255) / 256, 256, 0, s>>>(
        static_cast<const int*>(words), static_cast<const int*>(owner),
        static_cast<const int*>(pos), static_cast<const bool*>(took),
        static_cast<signed char*>(out), M, D, W, n);
  }
  return (int)cudaGetLastError();
}

// v uint8[T] (a lane's commit byte), lane int32[D, M] -> words int32[D, W].
extern "C" int repro_verdict_pack_gather(const void* v, const void* lane,
                                         void* words, int T, int D, int M,
                                         int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)D * W;
  if (n > 0) {
    verdict_pack_gather_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        static_cast<const unsigned char*>(v), static_cast<const int*>(lane),
        static_cast<int*>(words), T, D, M, W);
  }
  return (int)cudaGetLastError();
}

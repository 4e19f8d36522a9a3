// verdict_pack / verdict_unpack: the sharded wave's 2-bit verdict wire
// format, for Hopper (sm_90a).
//
// Replaces the TPU kernels verdict_pack_pallas and verdict_unpack_pallas in
// src/repro/kernels/verdict_pack.py; holds against the JAX oracles
// ref.verdict_pack / ref.verdict_unpack and the plain PyTorch versions
// verdict_pack_plain / verdict_unpack_plain
// (src/repro_torch/kernels/verdict_pack.py).  Op j of a row keeps its low
// two bits at bits 2*(j%16) and 2*(j%16)+1 of word j/16; a row of M ops
// packs into ceil(M/16) int32 words, the last one padded with zero fields.
//
// Bound on this card: bytes, and far below a launch.  At the one-card
// sharded wave (one row of cap = 16,384 ops) pack reads 16 KB and writes
// 4 KB, unpack the reverse: about 6 ns at 3.35 TB/s.  Launch latency sets
// the time.
//
// Design.  The Pallas kernels build each word with a word-by-op one-hot
// select over the whole row in VMEM.  Here every thread owns one output
// element: pack reads its word's 16 bytes and ORs the shifted fields;
// unpack reads one word and shifts its op's field out.  No thread writes
// another's element, so there are no atomics and no barriers.
#include <cuda_runtime.h>

namespace {

__global__ void verdict_pack_kernel(const signed char* __restrict__ v,
                                    int* __restrict__ words, int D, int M,
                                    int W) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)D * W) return;
  const int d = (int)(idx / W);
  const int w = (int)(idx % W);
  const signed char* row = v + (size_t)d * M;
  unsigned word = 0u;
  for (int j = 0; j < 16; ++j) {
    const int i = w * 16 + j;
    if (i < M) word |= ((unsigned)(unsigned char)row[i] & 3u) << (2 * j);
  }
  words[idx] = (int)word;
}

__global__ void verdict_unpack_kernel(const int* __restrict__ words,
                                      signed char* __restrict__ out, int D,
                                      int W, int n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)D * n) return;
  const int d = (int)(idx / n);
  const int j = (int)(idx % n);
  const unsigned word = (unsigned)words[(size_t)d * W + j / 16];
  out[idx] = (signed char)((word >> (2 * (j % 16))) & 3u);
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

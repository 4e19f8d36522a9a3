// ts_gather: per-op timestamp observation for TicToc, for Hopper (sm_90a).
//
// Replaces the TPU kernel ts_gather_pallas in src/repro/kernels/ts_gather.py;
// holds against the JAX oracle ref.ts_gather and the plain PyTorch version
// ts_gather_plain (src/repro_torch/kernels/ts_gather.py).  Fine granularity
// reads table[key, group]; coarse reads the row max; masked ops (key
// outside [0, N)) read 0.
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a key,
// a group and one row of G words and writes one word: at T=128, K=64, G=2
// about 160 KB, under 0.05 us at 3.35 TB/s.  Launch latency sets the time.
//
// Design.  One thread per op, neighbouring threads on neighbouring ops so the
// key/group loads and the output store coalesce; the row loads are
// scattered by nature (one 8-byte row per op).  The TPU kernel's
// scalar-prefetched per-op row DMA becomes a plain load.
#include <cuda_runtime.h>

namespace {

__global__ void ts_gather_kernel(const unsigned* __restrict__ table,
                                 const int* __restrict__ keys,
                                 const int* __restrict__ groups,
                                 unsigned* __restrict__ out, int n, int N,
                                 int G, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  unsigned v = 0;
  if (key >= 0 && key < N) {
    const unsigned* row = table + (size_t)key * G;
    if (fine) {
      const int g = groups[i];
      if (g >= 0 && g < G) v = row[g];
    } else {
      for (int j = 0; j < G; ++j) v = max(v, row[j]);
    }
  }
  out[i] = v;
}

}  // namespace

extern "C" int repro_ts_gather(const void* table, const void* keys,
                               const void* groups, void* out, int n, int N,
                               int G, int fine, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    ts_gather_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<unsigned*>(out), n, N,
        G, fine);
  }
  return (int)cudaGetLastError();
}

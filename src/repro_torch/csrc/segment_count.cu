// segment_count: per op, the number of masked ops of the wave on the same
// (record, group) cell, for Hopper (sm_90a).
//
// Replaces the TPU kernel segment_count_pallas in
// src/repro/kernels/segment_count.py; holds against the JAX oracle
// ref.segment_count and the plain PyTorch version segment_count_plain
// (src/repro_torch/kernels/segment_count.py).  Output is float32, 0 where
// the op is masked.
//
// Bound on this card: bytes.  The function needs each op's key, group and
// mask read once and its count written once, 13 B per op: 106 KB at T=128,
// K=64, about 0.03 us at 3.35 TB/s.  A sort or a hash does the count in
// O(n log n) or O(n) compares, far below that.  This direct count does
// (T*K)^2 compares, 67M at T=128, K=64, about 1 us at the card's 67 Tops/s
// non-tensor rate, so its own design sits some 30x above the bound before
// latency is counted.  Launch latency is of the same order as that 1 us.
//
// Design.  One thread per op; a block of kTile threads walks the wave in
// tiles of kTile cells, each tile loaded once into shared memory by the
// block and compared by every thread from there, so device memory sees
// each cell once per block.  A count is an order-free sum, so the result
// equals the sort-based oracle exactly.  Masked cells take a sentinel that
// no real key * G + group reaches.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr long long kMaskedCell = -(1LL << 62);

__global__ void segment_count_kernel(const int* __restrict__ keys,
                                     const int* __restrict__ groups,
                                     const bool* __restrict__ mask,
                                     float* __restrict__ out, int n, int G) {
  __shared__ long long tile[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool mine = i < n && mask[i];
  const long long my = mine ? (long long)keys[i] * G + groups[i] : 0;
  int cnt = 0;
  for (int base = 0; base < n; base += kTile) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = (j < n && mask[j])
                            ? (long long)keys[j] * G + groups[j]
                            : kMaskedCell;
    __syncthreads();
    if (mine) {
      const int lim = min(kTile, n - base);
      for (int jj = 0; jj < lim; ++jj) cnt += tile[jj] == my;
    }
    __syncthreads();
  }
  if (i < n) out[i] = mine ? (float)cnt : 0.0f;
}

}  // namespace

extern "C" int repro_segment_count(const void* keys, const void* groups,
                                   const void* mask, void* out, int n, int G,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    segment_count_kernel<<<(n + kTile - 1) / kTile, kTile, 0, s>>>(
        static_cast<const int*>(keys), static_cast<const int*>(groups),
        static_cast<const bool*>(mask), static_cast<float*>(out), n, G);
  }
  return (int)cudaGetLastError();
}

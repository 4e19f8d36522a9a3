// ts_install_max: monotone scatter-max timestamp install for TicToc, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ts_install_max_pallas in
// src/repro/kernels/ts_install.py; holds against the JAX oracle
// ref.ts_install_max and the plain PyTorch version ts_install_max_plain
// (src/repro_torch/kernels/ts_install.py).  For every masked op with a key in
// [0, N): table[key, group] = max(table[key, group], val), unsigned; with
// whole_row, every group of the record.
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a
// key, a group, a value and a mask byte and read-modify-writes at most one
// row of G words: at T=128, K=64, G=2 under 250 KB, under 0.1 us at
// 3.35 TB/s.  Launch latency sets the time.
//
// Design.  The TPU kernel walks the ops on a sequential grid with the table
// aliased in and out; here one thread per op calls atomicMax.  Max is
// commutative and idempotent, so any order of the atomics gives the
// sequential grid's table.
#include <cuda_runtime.h>

namespace {

__global__ void ts_install_max_kernel(unsigned* __restrict__ table,
                                      const int* __restrict__ keys,
                                      const int* __restrict__ groups,
                                      const unsigned* __restrict__ vals,
                                      const bool* __restrict__ mask, int n,
                                      int N, int G, int whole_row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  const int key = keys[i];
  if (key < 0 || key >= N) return;
  unsigned* row = table + (size_t)key * G;
  const unsigned v = vals[i];
  if (whole_row) {
    for (int j = 0; j < G; ++j) atomicMax(row + j, v);
  } else {
    const int g = groups[i];
    if (g >= 0 && g < G) atomicMax(row + g, v);
  }
}

}  // namespace

extern "C" int repro_ts_install_max(void* table, const void* keys,
                                    const void* groups, const void* vals,
                                    const void* mask, int n, int N, int G,
                                    int whole_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    ts_install_max_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const unsigned*>(vals),
        static_cast<const bool*>(mask), n, N, G, whole_row);
  }
  return (int)cudaGetLastError();
}

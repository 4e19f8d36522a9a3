// mv_install: one new ring slot per written record per wave, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mv_install_pallas in src/repro/kernels/mv_install.py;
// holds against the JAX oracle ref.mv_install and the plain PyTorch version
// mv_install_plain (src/repro_torch/kernels/mv_install.py).  begin is
// uint32[N, D, G], head int32[N]; for every record that an op with `do` set
// writes (key in [0, N)), against the PRE-wave head:
//   h_new = (head[key] + 1) mod D
//   begin[key, h_new, :] = begin[key, head[key], :]   (carry forward)
//   begin[key, h_new, g] = ts for every such op's group g in [0, G)
//   head[key] = h_new
// A head outside [0, D) carries a zero row forward, as the oracle's fill.
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a key,
// a group and a mask byte (9 B); per distinct written record it reads the
// head and one G-word slot and writes one slot and the head (24 B at G = 2):
// at T=128, K=64 under 100 KB, under 0.03 us at 3.35 TB/s.  Two launches set
// the time.
//
// Design.  The TPU kernel walks the ops on its sequential grid and tells a
// record's first op of the wave from a revisit by finding ts already in the
// row.  Blocks here run in no order, so every op resolves against the
// pre-wave head instead, in two launches on one stream, whose boundary is
// the barrier:
//   1. each masked op reads head[key] (nobody writes it in this launch),
//      keeps h_new in a per-op buffer and copies slot h_old to slot h_new.
//      Ops of one record copy the same bytes; no op of this launch writes a
//      slot another reads (h_new != h_old unless D = 1, where the copy is
//      onto itself).
//   2. each masked op stamps begin[key, h_new, g] = ts and writes
//      head[key] = h_new: ops of one record write identical values.
// So any number of ops on a record, in any order, gives the oracle's result.
#include <cuda_runtime.h>

namespace {

__global__ void mv_copy_kernel(unsigned* __restrict__ begin,
                               const int* __restrict__ head,
                               const int* __restrict__ keys,
                               const bool* __restrict__ do_,
                               int* __restrict__ h_new_out, int n, int N,
                               int D, int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  if (!do_[i] || key < 0 || key >= N) {
    h_new_out[i] = -1;
    return;
  }
  const int h_old = head[key];
  const int h_new = (((h_old + 1) % D) + D) % D;
  h_new_out[i] = h_new;
  unsigned* row = begin + (size_t)key * D * G;
  const bool h_ok = h_old >= 0 && h_old < D;
  for (int j = 0; j < G; ++j) {
    row[h_new * G + j] = h_ok ? row[h_old * G + j] : 0u;
  }
}

__global__ void mv_stamp_kernel(unsigned* __restrict__ begin,
                                int* __restrict__ head,
                                const int* __restrict__ keys,
                                const int* __restrict__ groups,
                                const int* __restrict__ h_new_in, int n,
                                int D, int G, unsigned ts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int h_new = h_new_in[i];
  if (h_new < 0) return;
  const int key = keys[i];
  const int g = groups[i];
  if (g >= 0 && g < G) begin[((size_t)key * D + h_new) * G + g] = ts;
  head[key] = h_new;
}

}  // namespace

extern "C" int repro_mv_install(void* begin, void* head, const void* keys,
                                const void* groups, const void* do_,
                                void* h_new, int n, int N, int D, int G,
                                unsigned ts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int blocks = (n + 255) / 256;
    mv_copy_kernel<<<blocks, 256, 0, s>>>(
        static_cast<unsigned*>(begin), static_cast<const int*>(head),
        static_cast<const int*>(keys), static_cast<const bool*>(do_),
        static_cast<int*>(h_new), n, N, D, G);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    mv_stamp_kernel<<<blocks, 256, 0, s>>>(
        static_cast<unsigned*>(begin), static_cast<int*>(head),
        static_cast<const int*>(keys), static_cast<const int*>(groups),
        static_cast<const int*>(h_new), n, D, G, ts);
  }
  return (int)cudaGetLastError();
}

// mv_gather: snapshot version select on the multi-version ring, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mv_gather_pallas in src/repro/kernels/mv_gather.py;
// holds against the JAX oracle ref.mv_gather and the plain PyTorch version
// mv_gather_plain (src/repro_torch/kernels/mv_gather.py).  begin is
// uint32[N, D, G]; per op, over the D slots of its record:
//   eff   = fine ? begin[key, d, g] (0 for g outside [0, G))
//                : max over groups of begin[key, d, :]
//   score = eff <= ts ? eff + 1 : 0          (uint32, wrapping like the oracle)
// slot = the lowest d of the highest score, ok = best score > 0.  A key
// outside [0, N) reads nothing: slot 0, ok false.
//
// Every compare and max is unsigned: the empty slot's stamp is 0xFFFFFFFF,
// which an int32 compare would take for -1 and make visible.
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a key
// and a group (8 B) and writes a slot and a flag (5 B); each distinct live
// record's D x G begin words are read once (32 B at D = 4, G = 2): at T=128,
// K=64 under 400 KB, about 0.1 us at 3.35 TB/s.  Launch latency sets the time.
//
// Design.  The TPU kernel DMAs each op's whole ring row into VMEM and reduces
// it in a lane block.  Here one thread per op reads its record's D x G words
// and keeps the running best (mv::select in mv_ring.cuh, which validate's
// and claim_probe's multi-version forms also run); the table is only read,
// so thread order does not matter.  The engine's waves read the ring inside
// those launches; this entry is the backend op on its own.
#include <cuda_runtime.h>

#include "mv_ring.cuh"

namespace {

__global__ void mv_gather_kernel(const unsigned* __restrict__ begin,
                                 const int* __restrict__ keys,
                                 const int* __restrict__ groups,
                                 int* __restrict__ slot_out,
                                 bool* __restrict__ ok_out,
                                 const long long* __restrict__ ts, int n,
                                 int N, int D, int G, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int slot = 0;
  ok_out[i] = mv::select(begin, keys[i], groups[i], N, D, G, fine,
                         mv::stamp_at(ts), &slot);
  slot_out[i] = slot;
}

}  // namespace

extern "C" int repro_mv_gather(const void* begin, const void* keys,
                               const void* groups, void* slot_out,
                               void* ok_out, const void* ts, int n, int N,
                               int D, int G, int fine, void* stream) {
  if (ts == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    mv_gather_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(begin), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<int*>(slot_out),
        static_cast<bool*>(ok_out), static_cast<const long long*>(ts), n, N,
        D, G, fine);
  }
  return (int)cudaGetLastError();
}

// validate_dual: fine and coarse read-validation verdicts from one claim-row
// read per op, for Hopper (sm_90a).
//
// Replaces the TPU kernel occ_validate_dual_pallas in
// src/repro/kernels/occ_validate.py; holds against the JAX oracle
// ref.occ_validate_dual and the plain PyTorch version validate_dual_plain
// (src/repro_torch/kernels/occ_validate.py).  Per op:
//   fine   = check & (live prio16 of the op's own cell < myprio)
//   coarse = check & (min live prio16 over the record's row < myprio)
// A masked key reads no row and gives no conflict; an out-of-range group
// gives none on the fine side.
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a key,
// a group, a priority and a check byte (13 B) and writes two verdict bytes;
// each distinct checked row (G words) is read once: at T=128, K=64 under
// 200 KB, under 0.06 us at 3.35 TB/s.  Launch latency sets the time.
//
// Design.  The TPU kernel DMAs each op's row inside a lane block.  Here one
// thread per op reads its G-word row once and decodes both verdicts from it;
// ops whose check is false read nothing, since both verdicts are then false.
// Nothing is written to the table, so thread order does not matter.
#include "claim.cuh"

namespace {

__global__ void validate_dual_kernel(const unsigned* __restrict__ claim_w,
                                     const int* __restrict__ keys,
                                     const int* __restrict__ groups,
                                     const int* __restrict__ myprio,
                                     const bool* __restrict__ check,
                                     bool* __restrict__ fine_out,
                                     bool* __restrict__ coarse_out, int n,
                                     int N, int G, unsigned ivw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool c = check[i];
  const int key = keys[i];
  const int g = groups[i];
  unsigned fp = claim::kNoPrio;
  unsigned cp = claim::kNoPrio;
  if (c && key >= 0 && key < N) {
    const unsigned* row = claim_w + (size_t)key * G;
    for (int j = 0; j < G; ++j) {
      const unsigned v = claim::live_prio(row[j], ivw);
      cp = min(cp, v);
      if (j == g) fp = v;
    }
  }
  const unsigned p = (unsigned)myprio[i];
  fine_out[i] = c && fp < p;
  coarse_out[i] = c && cp < p;
}

}  // namespace

extern "C" int repro_validate_dual(const void* claim_w, const void* keys,
                                   const void* groups, const void* myprio,
                                   const void* check, void* fine_out,
                                   void* coarse_out, int n, int N, int G,
                                   int ivw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    validate_dual_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(claim_w), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const int*>(myprio),
        static_cast<const bool*>(check), static_cast<bool*>(fine_out),
        static_cast<bool*>(coarse_out), n, N, G, (unsigned)ivw);
  }
  return (int)cudaGetLastError();
}

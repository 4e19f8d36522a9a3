// validate and validate_dual: read-validation verdicts against a claim table,
// at one granularity or at both from one claim-row read per op, for Hopper
// (sm_90a).
//
// Replace the TPU kernels occ_validate_pallas and occ_validate_dual_pallas in
// src/repro/kernels/occ_validate.py; hold against the JAX oracles
// ref.occ_validate and ref.occ_validate_dual and the plain PyTorch versions
// validate_plain and validate_dual_plain
// (src/repro_torch/kernels/occ_validate.py).  Per op:
//   fine   = check & (live prio16 of the op's own cell < myprio)
//   coarse = check & (min live prio16 over the record's row < myprio)
// validate writes the one its `fine` flag names, validate_dual both.  A
// masked key reads no row and gives no conflict; an out-of-range group
// gives none on the fine side.
//
// Bound on this card: bytes, and far below a launch.  Per op they read a
// key, a group, a priority and a check byte (13 B) and write one or two
// verdict bytes; each distinct checked row (G words) is read once: at
// T=128, K=64 under 200 KB, under 0.06 us at 3.35 TB/s.  Launch latency
// sets the time.
//
// Design.  The TPU kernels DMA each op's row inside a lane block.  Here one
// thread per op reads its G-word row once (claim::probe for validate) and
// decodes the verdicts from it; ops whose check is false read nothing, since
// their verdicts are then false.  Nothing is written to the table, so thread
// order does not matter.
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

__global__ void validate_kernel(const unsigned* __restrict__ claim_w,
                                const int* __restrict__ keys,
                                const int* __restrict__ groups,
                                const int* __restrict__ myprio,
                                const bool* __restrict__ check,
                                bool* __restrict__ out, int n, int N, int G,
                                unsigned ivw, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool c = check[i];
  const unsigned wprio =
      c ? claim::probe(claim_w, keys[i], groups[i], N, G, ivw, fine)
        : claim::kNoPrio;
  out[i] = c && wprio < (unsigned)myprio[i];
}

}  // namespace

extern "C" int repro_validate(const void* claim_w, const void* keys,
                              const void* groups, const void* myprio,
                              const void* check, void* out, int n, int N,
                              int G, int ivw, int fine, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    validate_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(claim_w), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const int*>(myprio),
        static_cast<const bool*>(check), static_cast<bool*>(out), n, N, G,
        (unsigned)ivw, fine);
  }
  return (int)cudaGetLastError();
}

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

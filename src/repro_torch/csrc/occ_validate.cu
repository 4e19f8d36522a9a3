// validate and validate_dual: read-validation verdicts against claim tables,
// at one granularity (on one table, or per op on one or two of a pair) or at
// both from one claim-row read per op, for Hopper (sm_90a).
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
// gives none on the fine side.  validate's two-channel form (validate_pair)
// writes (check & verdict(claim_w)) | (check_r & verdict(claim_r)).
//
// Bound on this card: bytes, and far below a launch.  Per op they read a
// key, a group, a priority and one or two check bytes (13-14 B) and write
// one or two verdict bytes; each distinct checked row (G words) is read
// once: at T=128, K=64 under 200 KB, under 0.06 us at 3.35 TB/s.  Launch
// latency sets the time: an empty launch takes 4.8 us between its events
// on the H100 (launch/wave_commit_cost.py), the kernel about 5.8.
//
// Design.  The TPU kernels DMA each op's row inside a lane block.  Here one
// thread per op reads the rows its checks name (claim::probe) and decodes
// the verdicts from them; ops whose checks are all false read nothing,
// since their verdicts are then false.  Nothing is written to the tables,
// so thread order does not matter.  Since the launch is most of the time,
// the multi-version waves' two or three validate calls on the same ops
// (the write-write check on claim_w and on claim_r, MV-OCC's read check
// on claim_w) are one launch of validate_pair: the masks come from op
// kinds and are disjoint in the engine, but an op with both checks set
// reads both rows, so the kernel is exact for any masks.  Its two row
// reads do not depend on each other and are in flight together.
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

__global__ void validate_pair_kernel(const unsigned* __restrict__ claim_w,
                                     const unsigned* __restrict__ claim_r,
                                     const int* __restrict__ keys,
                                     const int* __restrict__ groups,
                                     const int* __restrict__ myprio,
                                     const bool* __restrict__ check,
                                     const bool* __restrict__ check_r,
                                     bool* __restrict__ out, int n, int N,
                                     int G, unsigned ivw, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool cw = check[i];
  const bool cr = check_r[i];
  if (!cw && !cr) {
    out[i] = false;
    return;
  }
  const int key = keys[i];
  const int g = groups[i];
  const unsigned wp =
      cw ? claim::probe(claim_w, key, g, N, G, ivw, fine) : claim::kNoPrio;
  const unsigned rp =
      cr ? claim::probe(claim_r, key, g, N, G, ivw, fine) : claim::kNoPrio;
  const unsigned p = (unsigned)myprio[i];
  out[i] = (cw && wp < p) || (cr && rp < p);
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

extern "C" int repro_validate_pair(const void* claim_w, const void* claim_r,
                                   const void* keys, const void* groups,
                                   const void* myprio, const void* check,
                                   const void* check_r, void* out, int n,
                                   int N, int G, int ivw, int fine,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    validate_pair_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(claim_w),
        static_cast<const unsigned*>(claim_r), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const int*>(myprio),
        static_cast<const bool*>(check), static_cast<const bool*>(check_r),
        static_cast<bool*>(out), n, N, G, (unsigned)ivw, fine);
  }
  return (int)cudaGetLastError();
}

// iterate_validate: interval (scan) validation, the phantom check, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel iterate_validate_pallas in
// src/repro/kernels/iterate_validate.py; holds against the JAX oracle
// ref.iterate_validate and the plain PyTorch version iterate_validate_plain
// (src/repro_torch/kernels/iterate_validate.py).  An op with check set and
// key >= 0 conflicts when a row of its validated interval carries a live
// claim of this wave stronger than its priority:
//   fine:   rows [key, key + ext) at the op's group;
//   coarse: rows [floor(key/B)*B, ceil((key+ext)/B)*B) with the whole-row
//           minimum (bucket-interval claims).
// ext = max(extent, 1).  At most `span` rows are walked (ref.scan_span of
// the config's max_extent); rows outside [0, N) read as no claimant.
//
// Bound on this card: bytes.  Per op it reads a key, an extent, a group, a
// priority and a check byte (17 B) and writes a verdict byte; each distinct
// row of the checked intervals is read once (G words).  TPC-C's scans (at
// most a few dozen intervals of up to 208 rows a wave) stay far below a
// launch: under 0.1 us at 3.35 TB/s.
//
// Design.  The TPU kernel DMAs every op's span rows into VMEM and reduces
// them in one vector pass.  Here one thread per op walks its own interval
// with a loop (not unrolled: TPC-C's coarse span is 208 rows) and stops at
// its first stronger claim, at the interval's end or at the table's edge.
// Ops whose check is false read nothing.  The table is only read, so thread
// order does not matter.
#include "claim.cuh"

namespace {

__global__ void iterate_validate_kernel(
    const unsigned* __restrict__ table, const int* __restrict__ keys,
    const int* __restrict__ extents, const int* __restrict__ groups,
    const int* __restrict__ myprio, const bool* __restrict__ check,
    bool* __restrict__ out, int n, int N, int G, unsigned ivw, int fine,
    int B, int span) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long key = keys[i];
  bool conflict = false;
  if (check[i] && key >= 0) {
    const long long ext = extents[i] > 1 ? extents[i] : 1;
    long long start = key, width = ext;
    if (!fine) {
      start = (key / B) * B;
      width = ((key + ext + B - 1) / B) * B - start;
    }
    const long long rows = width < span ? width : span;
    const unsigned p = (unsigned)myprio[i];
    const int g = groups[i];
    for (long long j = 0; j < rows && !conflict; ++j) {
      const long long row = start + j;
      if (row >= N) break;
      conflict =
          claim::probe(table, (int)row, g, N, G, ivw, fine) < p;
    }
  }
  out[i] = conflict;
}

}  // namespace

extern "C" int repro_iterate_validate(const void* table, const void* keys,
                                      const void* extents, const void* groups,
                                      const void* myprio, const void* check,
                                      void* out, int n, int N, int G, int ivw,
                                      int fine, int B, int span,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    iterate_validate_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(extents), static_cast<const int*>(groups),
        static_cast<const int*>(myprio), static_cast<const bool*>(check),
        static_cast<bool*>(out), n, N, G, (unsigned)ivw, fine, B, span);
  }
  return (int)cudaGetLastError();
}

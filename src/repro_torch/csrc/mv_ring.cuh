// Version-ring device helper shared by the ring readers (sm_90a): the
// snapshot select of mv_gather, which validate's and claim_probe's
// multi-version forms run inside their own launches.
//
// The ring is begin uint32[N, D, G] (src/repro_torch/core/mvstore.py).  Per
// op, over the D slots of its record:
//   eff   = fine ? begin[key, d, g] (0 for g outside [0, G))
//                : max over groups of begin[key, d, :]
//   score = eff <= ts ? eff + 1 : 0          (uint32, wrapping like the oracle)
// the slot is the lowest d of the highest score, ok = best score > 0.  A
// key outside [0, N) reads nothing: slot 0, ok false.  Every compare and
// max is unsigned: the empty slot's stamp is 0xFFFFFFFF, which an int32
// compare would take for -1 and make visible.  The snapshot and install
// timestamps are read from device memory (0-d int64 tensors derived from
// the run's wave on the device), never passed as launch arguments: stamp_at.
#pragma once

#include <cuda_runtime.h>

namespace mv {

// The uint32 timestamp at *ts (its low 32 bits).
__device__ __forceinline__ unsigned stamp_at(const long long* ts) {
  return (unsigned)__ldg(ts);
}

// Newest slot of the op's record visible at snapshot ts; returns ok and
// stores the slot (0 when nothing is visible) in *slot.
__device__ __forceinline__ bool select(const unsigned* __restrict__ begin,
                                       int key, int g, int N, int D, int G,
                                       int fine, unsigned ts, int* slot) {
  int best_d = 0;
  unsigned best = 0u;
  if (key >= 0 && key < N) {
    const unsigned* row = begin + (size_t)key * D * G;
    const bool g_ok = g >= 0 && g < G;
    for (int d = 0; d < D; ++d) {
      const unsigned* s = row + d * G;
      unsigned eff = 0u;
      if (fine) {
        if (g_ok) eff = s[g];
      } else {
        for (int j = 0; j < G; ++j) eff = max(eff, s[j]);
      }
      const unsigned score = eff <= ts ? eff + 1u : 0u;
      if (score > best) {
        best = score;
        best_d = d;
      }
    }
  }
  *slot = best_d;
  return best > 0u;
}

}  // namespace mv

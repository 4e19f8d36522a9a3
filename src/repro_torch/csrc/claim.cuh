// Claim-word device helpers shared by the claim-table kernels (sm_90a).
//
// A claim cell is one 32-bit word, (inv_wave << 16) | prio16, where inv_wave
// = 0xFFFF - (wave & 0xFFFF) falls as the wave number grows: the current
// wave's claims are numerically smaller than every stale wave's, so an
// atomicMin install never needs a reset (src/repro_torch/core/claimword.py).
// Tables are [N, G] words; an op addresses the cell (key, group).  Keys
// outside [0, N) and groups outside [0, G) are masked: they install nothing
// and probe kNoPrio.  A kernel reads the wave number from device memory
// (a 0-d int64 tensor, the run's wave), never as a launch argument, so a
// captured launch reads each replay's wave: inv_wave_at.
#pragma once

#include <cuda_runtime.h>

namespace claim {

constexpr unsigned kNoPrio = 0xFFFFu;
constexpr unsigned kMaxWave = 0xFFFFu;

// The claim tag of the wave at *wave: kMaxWave - (wave & kMaxWave).
__device__ __forceinline__ unsigned inv_wave_at(const long long* wave) {
  return kMaxWave - ((unsigned)__ldg(wave) & kMaxWave);
}

__device__ __forceinline__ unsigned word(unsigned ivw, int prio) {
  return (ivw << 16) | ((unsigned)prio & 0xFFFFu);
}

__device__ __forceinline__ bool in_cell(int key, int g, int N, int G) {
  return key >= 0 && key < N && g >= 0 && g < G;
}

// prio16 of a live claim word of this wave, kNoPrio for a stale or empty one.
__device__ __forceinline__ unsigned live_prio(unsigned w, unsigned ivw) {
  return (w >> 16) == ivw ? (w & 0xFFFFu) : kNoPrio;
}

// Strongest live claimant of the op's cell (fine) or row (coarse).
__device__ __forceinline__ unsigned probe(const unsigned* __restrict__ table,
                                          int key, int g, int N, int G,
                                          unsigned ivw, int fine) {
  if (key < 0 || key >= N) return kNoPrio;
  const unsigned* row = table + (size_t)key * G;
  if (fine) {
    if (g < 0 || g >= G) return kNoPrio;
    return live_prio(row[g], ivw);
  }
  unsigned best = kNoPrio;
  for (int j = 0; j < G; ++j) best = min(best, live_prio(row[j], ivw));
  return best;
}

// probe() through L2 (__ldcg), for a kernel that wrote the table itself
// before a grid barrier: the non-coherent read-only path and L1 may hold
// words from before the barrier.
__device__ __forceinline__ unsigned probe_l2(const unsigned* table, int key,
                                             int g, int N, int G,
                                             unsigned ivw, int fine) {
  if (key < 0 || key >= N) return kNoPrio;
  const unsigned* row = table + (size_t)key * G;
  if (fine) {
    if (g < 0 || g >= G) return kNoPrio;
    return live_prio(__ldcg(row + g), ivw);
  }
  unsigned best = kNoPrio;
  for (int j = 0; j < G; ++j)
    best = min(best, live_prio(__ldcg(row + j), ivw));
  return best;
}

}  // namespace claim

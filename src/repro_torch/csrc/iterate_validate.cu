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
// launch: under 0.1 us at 3.35 TB/s.  What costs time is latency: a walk
// that tests each row before it loads the next is a chain of dependent
// loads, one L2 or DRAM round trip a row.
//
// Design: a warp-cooperative walk.  The TPU kernel DMAs every op's span
// rows into VMEM and reduces them in one vector pass; here the warp takes
// that role.  One thread per op reads the op's vectors; __ballot_sync gives
// the warp the mask of ops that need a walk (check, key >= 0, at least one
// row before the table's end, and for fine a group inside [0, G)).  The
// warp then walks those ops one after another: the op's start, row count,
// group and priority are broadcast with __shfl_sync, and the 32 lanes take
// rows start + lane + 32*m, kUnroll rows a lane, so one batch of kBatch =
// 128 rows has all its loads in flight before any row is tested.  One
// __any_sync a batch; the walk stops at the first batch with a stronger
// claim.  TPC-C's coarse span of 208 rows is two batches: two round trips
// instead of 208.  A coarse row of G = 2 words is one 8-byte load (the
// table is 8-byte aligned, as PyTorch allocates it; other G, or a table
// that is not, read the row's words one by one).  The op's own thread
// keeps the verdict and writes it.  Ops whose check is false read no row.  The table is only
// read, so its loads may take the non-coherent path and thread order does
// not matter.
//
// The words form is the sharded owner's scan check: ops are rows of `row`
// ops (i = d * row + j) and, in place of the verdict bytes, a conflicting
// op ORs bit `bit` of its 2-bit field into word j/16 of row d of the
// verdict words its claim launch wrote (verdict_pack.cu's wire format; a
// word may span two warps or two rows, hence atomicOr).  It runs after
// that launch in the same stream, so no other ordering is needed.  This
// replaces the verdict bytes, their cast and the OR before the owner's
// verdict_pack launch.
#include "claim.cuh"
#include "verdict_word.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;
constexpr int kUnroll = 4;                  // rows a lane loads a batch
constexpr int kBatch = kWarp * kUnroll;     // rows a warp tests at once

__global__ void iterate_validate_kernel(
    const unsigned* __restrict__ table, const int* __restrict__ keys,
    const int* __restrict__ extents, const int* __restrict__ groups,
    const int* __restrict__ myprio, const bool* __restrict__ check,
    bool* __restrict__ out, unsigned* __restrict__ words, int n, int N,
    int G, unsigned ivw, int fine, int B, int span, int row, int W,
    int bit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  // Every thread of the warp takes part in the ballot and the walks, the
  // ones past n too (blockDim.x is a multiple of 32).
  long long start = 0;
  int rows = 0, g = 0;
  unsigned p = 0;
  bool need = false;
  if (i < n && check[i]) {
    const long long key = keys[i];
    g = groups[i];
    if (key >= 0 && (!fine || (g >= 0 && g < G))) {
      const long long ext = extents[i] > 1 ? extents[i] : 1;
      long long width = ext;
      start = key;
      if (!fine) {
        start = (key / B) * B;
        width = ((key + ext + B - 1) / B) * B - start;
      }
      long long r = width < span ? width : span;
      const long long room = (long long)N - start;  // rows before the end
      r = r < room ? r : room;
      rows = r > 0 ? (int)r : 0;
      p = (unsigned)myprio[i];
      need = rows > 0;
    }
  }
  const bool pair = !fine && G == 2 &&
                    (reinterpret_cast<size_t>(table) & 7) == 0;
  bool conflict = false;
  unsigned todo = __ballot_sync(kFull, need);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long s = __shfl_sync(kFull, start, src);
    const int r = __shfl_sync(kFull, rows, src);
    const int gg = __shfl_sync(kFull, g, src);
    const unsigned pp = __shfl_sync(kFull, p, src);
    bool hit = false;
    for (int base = 0; base < r && !hit; base += kBatch) {
      // Every load of the batch is in flight before any row is tested.
      unsigned pr[kUnroll];
      if (fine || G == 1) {
        const int col = fine ? gg : 0;
        unsigned w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = base + lane + kWarp * u;
          w[u] = j < r ? __ldg(table + (size_t)(s + j) * G + col) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          pr[u] = base + lane + kWarp * u < r ? claim::live_prio(w[u], ivw)
                                              : claim::kNoPrio;
      } else if (pair) {
        const uint2* t2 = reinterpret_cast<const uint2*>(table);
        uint2 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = base + lane + kWarp * u;
          w[u] = j < r ? __ldg(t2 + (s + j)) : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          pr[u] = base + lane + kWarp * u < r
                      ? min(claim::live_prio(w[u].x, ivw),
                            claim::live_prio(w[u].y, ivw))
                      : claim::kNoPrio;
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = base + lane + kWarp * u;
          pr[u] = j < r ? claim::probe(table, (int)(s + j), 0, N, G, ivw, 0)
                        : claim::kNoPrio;
        }
      }
      bool c = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) c = c || pr[u] < pp;
      hit = __any_sync(kFull, c);
    }
    if (lane == src) conflict = hit;
  }
  if (i >= n) return;
  if (words == nullptr) {
    out[i] = conflict;
  } else if (conflict) {
    verdict::or_field(words, i, row, W, 1u << bit);
  }
}

}  // namespace

extern "C" int repro_iterate_validate(const void* table, const void* keys,
                                      const void* extents, const void* groups,
                                      const void* myprio, const void* check,
                                      void* out, void* words, int n, int N,
                                      int G, int ivw, int fine, int B,
                                      int span, int row, int W, int bit,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((out == nullptr) == (words == nullptr) ||
      (words != nullptr &&
       (!verdict::valid_rows(n, row, W) || bit < 0 || bit > 1)))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    iterate_validate_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(extents), static_cast<const int*>(groups),
        static_cast<const int*>(myprio), static_cast<const bool*>(check),
        static_cast<bool*>(out), static_cast<unsigned*>(words), n, N, G,
        (unsigned)ivw, fine, B, span, row, W, bit);
  }
  return (int)cudaGetLastError();
}

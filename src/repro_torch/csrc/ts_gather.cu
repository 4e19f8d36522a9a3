// ts_gather: per-op timestamp observation for TicToc, on one table or as a
// TicToc wave's whole observation (both tables to commit_ts and ext_need) in
// one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel ts_gather_pallas in src/repro/kernels/ts_gather.py;
// holds against the JAX oracle ref.ts_gather and the plain PyTorch version
// ts_gather_plain (src/repro_torch/kernels/ts_gather.py).  Fine granularity
// reads table[key, group]; coarse reads the row max; masked ops (key
// outside [0, N)) and, when fine, groups outside [0, G) read 0.
//
// repro_ts_gather_tictoc is the TicToc wave's two gathers (wts and rts on
// the same keys and groups) and the arithmetic its wave did on them, which
// were two launches and about thirteen elementwise and reduction kernels.
// For T lanes of K ops, with rd and wr the wave's live read and write masks
// and extent its op extents:
//   term[t, k]   = wr ? rts_op + 1 (mod 2**32) : rd ? wts_op : 0
//   commit_ts[t] = max over k of term                         (int64[T])
//   ext_need     = rd & commit_ts[t] > rts_op & extent <= 1   (bool[T, K])
// as tictoc_observe_plain computes them (src/repro/core/cc/tictoc.py in
// uint32).
//
// Bound on this card: bytes, and far below a launch.  Per op the one-table
// form reads a key, a group and one row of G words and writes one word: at
// T=128, K=64, G=2 about 160 KB, under 0.05 us at 3.35 TB/s.  The TicToc
// form reads a key, a group, an extent and two mask bytes an op, a row of
// each table per distinct live record, and writes a flag byte an op and 8 B
// a lane: about 200 KB.  Launch latency sets the time.
//
// Design.  One-table form: one thread per op, neighbouring threads on
// neighbouring ops so the key/group loads and the output store coalesce;
// the row loads are scattered by nature (one 8-byte row per op).  The TPU
// kernel's scalar-prefetched per-op row DMA becomes a plain load.
// TicToc form: one block per lane, its threads striding over the lane's K
// ops (any K, wider than the block too).  Pass 1 issues each op's wts and
// rts row loads together and keeps the thread's running max of the 32-bit
// term; the lane max is a warp reduction (__reduce_max_sync) and then one
// word per warp in shared memory.  Pass 2 writes ext_need against the lane
// max: the thread's first op's rts and flags stay in registers, a later
// op's are reloaded.  No op waits on another lane, so there is no grid
// barrier: a plain launch.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;  // the TicToc form's block: at most 256 threads

__device__ __forceinline__ unsigned observe(const unsigned* __restrict__ table,
                                            int key, int g, int N, int G,
                                            int fine) {
  unsigned v = 0;
  if (key >= 0 && key < N) {
    const unsigned* row = table + (size_t)key * G;
    if (fine) {
      if (g >= 0 && g < G) v = row[g];
    } else {
      for (int j = 0; j < G; ++j) v = max(v, row[j]);
    }
  }
  return v;
}

__global__ void ts_gather_kernel(const unsigned* __restrict__ table,
                                 const int* __restrict__ keys,
                                 const int* __restrict__ groups,
                                 unsigned* __restrict__ out, int n, int N,
                                 int G, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = observe(table, keys[i], fine ? groups[i] : 0, N, G, fine);
}

struct TicTocArgs {
  const unsigned* wts;
  const unsigned* rts;
  const int* keys;
  const int* groups;
  const bool* rd;
  const bool* wr;
  const int* extent;
  long long* commit_ts;
  bool* ext_need;
  int K, N, G, fine;
};

__global__ void ts_gather_tictoc_kernel(const TicTocArgs a) {
  __shared__ unsigned warp_max[kMaxWarps];
  const size_t base = (size_t)blockIdx.x * a.K;
  const int first = threadIdx.x;
  // 1. the lane's terms; the first op's rts and flags kept.
  unsigned r0 = 0, m = 0;
  bool rd0 = false;
  for (int k = first; k < a.K; k += blockDim.x) {
    const size_t i = base + k;
    const int key = a.keys[i];
    const int g = a.fine ? a.groups[i] : 0;
    const bool rd = a.rd[i], wr = a.wr[i];
    const unsigned w = observe(a.wts, key, g, a.N, a.G, a.fine);
    const unsigned r = observe(a.rts, key, g, a.N, a.G, a.fine);
    m = max(m, wr ? r + 1u : rd ? w : 0u);
    if (k == first) {
      r0 = r;
      rd0 = rd;
    }
  }
  m = __reduce_max_sync(0xFFFFFFFFu, m);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = m;
  __syncthreads();
  unsigned ts = 0;
  for (int j = 0; j < (int)(blockDim.x >> 5); ++j) ts = max(ts, warp_max[j]);
  if (threadIdx.x == 0) a.commit_ts[blockIdx.x] = (long long)ts;
  // 2. the reads that need room to time-travel.
  for (int k = first; k < a.K; k += blockDim.x) {
    const size_t i = base + k;
    bool rd = rd0;
    unsigned r = r0;
    if (k != first) {
      rd = a.rd[i];
      if (rd)
        r = observe(a.rts, a.keys[i], a.fine ? a.groups[i] : 0, a.N, a.G,
                    a.fine);
    }
    a.ext_need[i] = rd && ts > r && a.extent[i] <= 1;
  }
}

}  // namespace

extern "C" int repro_ts_gather(const void* table, const void* keys,
                               const void* groups, void* out, int n, int N,
                               int G, int fine, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    ts_gather_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<unsigned*>(out), n, N,
        G, fine);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_ts_gather_tictoc(const void* wts, const void* rts,
                                      const void* keys, const void* groups,
                                      const void* rd, const void* wr,
                                      const void* extent, void* commit_ts,
                                      void* ext_need, int T, int K, int N,
                                      int G, int fine, void* stream) {
  if (T <= 0 || K <= 0) return (int)cudaGetLastError();
  // Whole warps, at most kMaxWarps of them; wider lanes stride.
  int threads = (K + 31) / 32 * 32;
  if (threads > 32 * kMaxWarps) threads = 32 * kMaxWarps;
  const TicTocArgs a{static_cast<const unsigned*>(wts),
                     static_cast<const unsigned*>(rts),
                     static_cast<const int*>(keys),
                     static_cast<const int*>(groups),
                     static_cast<const bool*>(rd),
                     static_cast<const bool*>(wr),
                     static_cast<const int*>(extent),
                     static_cast<long long*>(commit_ts),
                     static_cast<bool*>(ext_need),
                     K,
                     N,
                     G,
                     fine};
  ts_gather_tictoc_kernel<<<T, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

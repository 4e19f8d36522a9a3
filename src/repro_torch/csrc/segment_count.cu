// segment_count: per op, the number of masked ops of the wave on the same
// (record, group) cell, for Hopper (sm_90a).
//
// Replaces the TPU kernel segment_count_pallas in
// src/repro/kernels/segment_count.py; holds against the JAX oracle
// ref.segment_count and the plain PyTorch version segment_count_plain
// (src/repro_torch/kernels/segment_count.py).  Output is float32, 0 where
// the op is masked.
//
// Bound on this card: bytes.  The function needs each op's key, group and
// mask read once and its count written once, 13 B per op: 106 KB at T=128,
// K=64, about 0.03 us at 3.35 TB/s.  A hash count adds O(n) work, so a
// wave of a few thousand ops costs about a launch.  The all-pairs count
// this replaces did n^2 / 64 compares a thread behind n / 64 barriers, with
// 2 warps an SM in flight: 3,500x the bound at TPC-C.
//
// Design.  Two paths, chosen by n in the wrapper:
//
// - n <= 8,192 (every wave the engines run: TPC-C 128 x 64, YCSB 128 x 16,
//   the sharded 256 x 16): 16 blocks of 1,024 threads, block b counting
//   the cells whose hash has b in its top 4 bits, in an open-addressing
//   hash table in its shared memory.  Every block reads the whole wave
//   (8 ops a thread, all loads in flight) and gathers its part's ops into
//   a list (ballot, one atomicAdd a warp); then, a thread an op, it claims
//   a slot for the op's cell with a 32-bit atomicCAS of the op's list
//   position (multiplicative hash, linear probing; a plain read finds a
//   claimed slot) and adds one to the slot's count; after __syncthreads
//   each op's count is written from its slot.  The table has a power-of-
//   two count of slots, 4 an op (load <= 1/4) up to 16,384 (load <= 1/2
//   when the whole wave falls in one part): 224 KB of shared memory with
//   the list.  A single block of the same design spent its time in its
//   threads' chains of shared-memory atomics; 16 parts shorten each chain
//   16-fold.  Warp aggregation of equal cells (__match_any_sync) cost more
//   than the atomics it saved.
// - n > 8,192: the all-pairs count, spread over a grid of (op blocks of
//   256) x (chunks of 1,024 other ops); each block stages its chunk's
//   cells in shared memory and adds its ops' partial counts to the output
//   with one atomicAdd each (zeroed first).  Partial counts are integers
//   below 2^24, so every float sum is exact in any order.
//
// A count is an order-free integer sum, so either path equals the
// sort-based oracle bit for bit, whatever order the atomics take.
#include <cuda_runtime.h>

namespace {

constexpr int kHashThreads = 1024;
constexpr int kHashMaxOps = 8192;
constexpr int kItems = kHashMaxOps / kHashThreads;  // ops a thread
constexpr int kMinBits = 6;
constexpr int kMaxBits = 14;
constexpr int kPartBits = 4;  // 16 blocks, one part of the cells each
// Cell id of masked ops in the all-pairs count: no key * G + group reaches
// it.
constexpr long long kMasked = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kPairThreads = 256;
constexpr int kPairChunk = 1024;

// The list of a block's ops at its longest, and the table at its largest.
constexpr size_t kHashSmem =
    (size_t)kHashMaxOps * (sizeof(long long) + sizeof(int))
    + (size_t)(1 << kMaxBits) * (sizeof(int) + sizeof(unsigned));

__device__ __forceinline__ long long cell_of(const int* keys,
                                             const int* groups, int i,
                                             int G) {
  return (long long)keys[i] * G + groups[i];
}

__device__ __forceinline__ unsigned long long hash_of(long long cell) {
  return (unsigned long long)cell * 0x9E3779B97F4A7C15ull;
}

__global__ void __launch_bounds__(kHashThreads)
segment_count_hash_kernel(const int* __restrict__ keys,
                          const int* __restrict__ groups,
                          const bool* __restrict__ mask,
                          float* __restrict__ out, int n, int G) {
  // Shared memory: this block's ops (cell, op index) in a list, then the
  // table: 2^bits slots, each the list position of its cell's first op
  // (-1 while empty), and 2^bits counts.
  extern __shared__ long long list_cell[];
  int* list_op = reinterpret_cast<int*>(list_cell + kHashMaxOps);
  int* table = list_op + kHashMaxOps;
  __shared__ int n_mine;
  if (threadIdx.x == 0) n_mine = 0;
  __syncthreads();

  // Gather this block's ops (masked in, cell hashed into the block's
  // part): every load of the thread's ops in flight at once, one atomicAdd
  // a warp for its place in the list.  Masked-out ops get their 0 from
  // block 0.
  const int lane = threadIdx.x % 32;
  unsigned ballot[kItems];
  long long cell[kItems];
  int own = 0, total = 0;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = threadIdx.x + it * kHashThreads;
    bool on = false;
    cell[it] = 0;
    if (i < n) {
      on = mask[i];
      cell[it] = cell_of(keys, groups, i, G);
      if (!on && blockIdx.x == 0) out[i] = 0.0f;
    }
    on = on && (int)(hash_of(cell[it]) >> (64 - kPartBits)) == (int)blockIdx.x;
    ballot[it] = __ballot_sync(0xffffffffu, on);
    own |= (int)on << it;
    total += __popc(ballot[it]);
  }
  int at = 0;
  if (lane == 0 && total) at = atomicAdd(&n_mine, total);
  at = __shfl_sync(0xffffffffu, at, 0);
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if ((own >> it) & 1) {
      const int k = at + __popc(ballot[it] & below);
      list_cell[k] = cell[it];
      list_op[k] = threadIdx.x + it * kHashThreads;
    }
    at += __popc(ballot[it]);
  }
  __syncthreads();

  // A table of at least 4 slots an op (load <= 1/4), at most 2^14 slots
  // (load <= 1/2 when every op falls in this block's part).
  const int m = n_mine;
  int bits = kMinBits;
  while ((1 << bits) < 4 * m && bits < kMaxBits) ++bits;
  const int slots = 1 << bits;
  unsigned* counts = reinterpret_cast<unsigned*>(table + slots);
  for (int s = threadIdx.x; s < slots; s += kHashThreads) {
    table[s] = -1;
    counts[s] = 0;
  }
  __syncthreads();

  // Insert, a thread an op: claim an empty slot with a 32-bit atomicCAS,
  // or find the cell's slot; a plain read finds a claimed slot without an
  // atomic.
  volatile int* vtable = table;
  for (int k = threadIdx.x; k < m; k += kHashThreads) {
    const long long c = list_cell[k];
    int s = (int)((hash_of(c) << kPartBits) >> (64 - bits));
    for (;;) {
      int first = vtable[s];
      if (first < 0) first = atomicCAS(table + s, -1, k);
      if (first < 0 || list_cell[first] == c) break;
      s = (s + 1) & (slots - 1);
    }
    atomicAdd(counts + s, 1u);
    list_op[k] |= s << 14;  // n <= 2^13 ops, 2^14 slots: both fit
  }
  __syncthreads();

  for (int k = threadIdx.x; k < m; k += kHashThreads) {
    const int e = list_op[k];
    out[e & 0x3FFF] = (float)counts[e >> 14];
  }
}

__global__ void __launch_bounds__(kPairThreads)
segment_count_pairs_kernel(const int* __restrict__ keys,
                           const int* __restrict__ groups,
                           const bool* __restrict__ mask,
                           float* __restrict__ out, int n, int G) {
  __shared__ long long tile[kPairThreads];
  const int i = blockIdx.x * kPairThreads + threadIdx.x;
  const bool mine = i < n && mask[i];
  const long long my = mine ? cell_of(keys, groups, i, G) : kMasked;
  const int j0 = blockIdx.y * kPairChunk;
  const int j1 = min(n, j0 + kPairChunk);
  int cnt = 0;
  for (int base = j0; base < j1; base += kPairThreads) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] =
        (j < j1 && mask[j]) ? cell_of(keys, groups, j, G) : kMasked;
    __syncthreads();
    if (mine) {
      const int lim = min(kPairThreads, j1 - base);
      for (int jj = 0; jj < lim; ++jj) cnt += tile[jj] == my;
    }
    __syncthreads();
  }
  if (cnt) atomicAdd(out + i, (float)cnt);
}

}  // namespace

extern "C" int repro_segment_count_hash(const void* keys, const void* groups,
                                        const void* mask, void* out, int n,
                                        int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kHashMaxOps) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  // The largest table, once a device; smaller launches fit under it.
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(segment_count_hash_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kHashSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready[dev] = true;
  }
  // Every op may fall in one part: each block gets the table for all n.
  segment_count_hash_kernel<<<1 << kPartBits, kHashThreads,
                              kHashSmem, s>>>(
      static_cast<const int*>(keys), static_cast<const int*>(groups),
      static_cast<const bool*>(mask), static_cast<float*>(out), n, G);
  return (int)cudaGetLastError();
}

extern "C" int repro_segment_count_pairs(const void* keys,
                                         const void* groups,
                                         const void* mask, void* out, int n,
                                         int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned bx = (unsigned)((n + kPairThreads - 1) / kPairThreads);
  const unsigned by = (unsigned)((n + kPairChunk - 1) / kPairChunk);
  if (by > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n, s);
  if (e != cudaSuccess) return (int)e;
  segment_count_pairs_kernel<<<dim3(bx, by), kPairThreads, 0, s>>>(
      static_cast<const int*>(keys), static_cast<const int*>(groups),
      static_cast<const bool*>(mask), static_cast<float*>(out), n, G);
  return (int)cudaGetLastError();
}

// wave_commit: the probe-family wave (claim install + probe + lane verdicts
// + version bumps) for Hopper (sm_90a).
//
// Replaces the TPU kernel wave_commit_pallas in
// src/repro/kernels/wave_commit.py; holds against the JAX oracle
// ref.wave_commit (src/repro/kernels/ref.py) and its plain PyTorch version
// wave_commit_plain (src/repro_torch/kernels/wave_commit.py).
//
// Bound on this card: bytes, and far below any launch.  At the main path's
// largest wave (T=128 lanes x K=64 slots, G=2 groups) one call reads the
// op vectors (~14 B x 8192 ops), one claim word per op (a row of 8 B when
// coarse) and writes at most one claim word and one conflict byte per op,
// plus one version word read and written per committed write: under
// 200 KB, i.e. well under 0.1 us at 3.35 TB/s.  Launch latency, the
// barrier between install and probe and the dependent loads set the time.
//
// Design.  The Pallas kernel answers every probe from one row fetch plus an
// all-pairs wave term, which relies on the TPU's sequential grid.  Blocks
// on Hopper run in no order, so every probe must wait for every install.
// The wave is one cooperative launch, its grid no larger than what is
// co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, queried
// once per device and block size), and grid.sync() is that barrier.  A
// unit of work is a lane's ops, or for a lane wider than 1,024 ops a chunk
// of kWideBlock of them (the sharded owner's rows of one source shard: up
// to 4 x the fair share, 16,384 ops at one shard with 256 lanes of 16);
// blocks stride over the units, so any T runs, one op a thread a unit.
//   1. install: each thread loads its op (key, group, prio, masks) into
//      registers once and atomicMin's its claim word (inv_wave << 16 |
//      prio16) into claim_w (and claim_r when dual);
//   2. grid.sync();
//   3. probe and verdict from the same registers (a block's later units
//      reload theirs).  claim_w/claim_r were written in this launch, so
//      they are read through L2 (__ldcg), never the non-coherent path.
//      The lane's conflicts are OR-ed with __syncthreads_or;
//   4. a lane of one block (K <= 1,024) writes commit and its committed
//      writers atomicAdd 1 to their wts cell (bump) at once: the bumps
//      touch no table a probe reads, so no second barrier is needed;
//   5. a lane over several blocks keeps its verdict in commit itself: set
//      in phase 1, cleared by any block of the lane that saw a conflict in
//      phase 3, read after a second grid.sync() by the bumps.  The
//      16,384-op row thus spreads over 128 SMs instead of one.
//   6. with a words output (the sharded owner's call: T rows of K ops, one
//      row a source shard) phase 3 also packs the verdicts in the sharded
//      wave's wire format, op k's conflict at bit 2*(k%16) of word k/16 of
//      its row, and writes no conflict bytes.  A unit's op k sits at
//      thread k % blockDim.x, and both block sizes (K rounded up to 32,
//      or 128 a chunk) are whole warps, so a word's 16 ops are one
//      half-warp: four __shfl_xor_sync steps (offsets 8, 4, 2, 1 stay
//      inside the half) OR its fields and the half's first lane stores
//      the word.  Lanes past round16(K) store nothing; ops past K
//      pack 0.  This replaces the owner's conflict cast and its
//      verdict_pack launch.
// Every loop over units is uniform across a block and the barriers are
// reached by every thread.  min and + are commutative, so the result does
// not depend on the order in which blocks or atomics run.  Masked ops (key
// outside [0, N) or group outside [0, G)) install nothing and probe
// NO_PRIO.
#include <cooperative_groups.h>

#include "claim.cuh"
#include "verdict_word.cuh"

namespace {

namespace cg = cooperative_groups;
using claim::kNoPrio;
using claim::live_prio;

constexpr int kMaxBlock = 1024;   // the widest lane one block takes
constexpr int kWideBlock = 128;   // a block's chunk of a wider lane
constexpr int kMaxDevices = 64;

struct Args {
  unsigned* claim_w;
  unsigned* claim_r;
  unsigned* wts;
  const int* keys;
  const int* groups;
  const int* prio;
  const bool* do_w;
  const bool* do_r;
  const bool* check_w;
  const bool* check_w2;
  const bool* check_r;
  const bool* extra;
  bool* conflict;  // nullptr: the verdicts go to words only
  int* words;      // nullptr, or the [T, ceil(K/16)] packed verdicts
  bool* commit;
  const long long* wave;  // the wave number, read in the kernel
  int T, K, N, G;
  int fine, dual, bump;
  int chunks;  // blocks a lane spans; each takes blockDim.x of its ops
};

enum : unsigned { kW = 1, kR = 2, kCw = 4, kCw2 = 8, kCr = 16, kX = 32 };

struct Op {
  size_t i;     // flat op index
  int key, g;
  unsigned p;
  unsigned f;   // kW | kR | ... as loaded
  bool live;    // the thread has an op in this unit
};

__device__ __forceinline__ Op load_op(const Args& a, int unit) {
  Op op{};
  const int t = unit / a.chunks;
  const int k = (unit % a.chunks) * blockDim.x + threadIdx.x;
  op.live = k < a.K;
  if (!op.live) return op;
  op.i = (size_t)t * a.K + k;
  op.key = a.keys[op.i];
  op.g = a.groups[op.i];
  op.p = (unsigned)a.prio[op.i];
  unsigned f = (a.do_w[op.i] ? kW : 0u) | (a.check_w[op.i] ? kCw : 0u);
  if (a.dual && a.do_r[op.i]) f |= kR;
  if (a.check_w2 != nullptr && a.check_w2[op.i]) f |= kCw2;
  if (a.dual && a.check_r != nullptr && a.check_r[op.i]) f |= kCr;
  if (a.extra != nullptr && a.extra[op.i]) f |= kX;
  op.f = f;
  return op;
}

__device__ __forceinline__ void install(const Args& a, const Op& op,
                                        unsigned ivw) {
  if (!op.live || !claim::in_cell(op.key, op.g, a.N, a.G)) return;
  const unsigned word = claim::word(ivw, (int)op.p);
  const size_t cell = (size_t)op.key * a.G + op.g;
  if (op.f & kW) atomicMin(a.claim_w + cell, word);
  if (op.f & kR) atomicMin(a.claim_r + cell, word);
}

// claim::probe through L2: the words were written by this launch.
__device__ __forceinline__ unsigned probe_cg(const unsigned* table,
                                             const Args& a, const Op& op,
                                             unsigned ivw) {
  if (op.key < 0 || op.key >= a.N) return kNoPrio;
  const unsigned* row = table + (size_t)op.key * a.G;
  if (a.fine) {
    if (op.g < 0 || op.g >= a.G) return kNoPrio;
    return live_prio(__ldcg(row + op.g), ivw);
  }
  unsigned best = kNoPrio;
  for (int j = 0; j < a.G; ++j)
    best = min(best, live_prio(__ldcg(row + j), ivw));
  return best;
}

// The op's conflict, written to conflict[i]; false for an idle thread.
__device__ __forceinline__ bool verdict(const Args& a, const Op& op,
                                        unsigned ivw) {
  if (!op.live) return false;
  bool c = false;
  if (op.f & (kCw | kCw2)) {
    const unsigned wp = probe_cg(a.claim_w, a, op, ivw);
    c = (op.f & kCw) && wp < op.p;
    c = c || ((op.f & kCw2) && wp != kNoPrio && wp != op.p);
  }
  if (op.f & kCr) c = c || probe_cg(a.claim_r, a, op, ivw) < op.p;
  c = c || (op.f & kX);
  if (a.conflict != nullptr) a.conflict[op.i] = c;
  return c;
}

// Phase 3's words output: the half-warp of unit u's ops k..k+15 ORs its
// conflict fields and its first lane stores the word.  Every thread of
// the block calls it.
__device__ __forceinline__ void pack_word(const Args& a, int unit, bool c) {
  const int k = (unit % a.chunks) * blockDim.x + threadIdx.x;
  unsigned bits = c ? 1u << verdict::shift_of(k) : 0u;
#pragma unroll
  for (int off = verdict::kOps / 2; off > 0; off >>= 1)
    bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, off);
  const int W = verdict::words_of(a.K);
  if (verdict::shift_of(k) == 0 && verdict::word_of(k) < W)
    a.words[(size_t)(unit / a.chunks) * W + verdict::word_of(k)] =
        (int)bits;
}

__device__ __forceinline__ void bump(const Args& a, const Op& op) {
  if (op.live && (op.f & kW) && claim::in_cell(op.key, op.g, a.N, a.G))
    atomicAdd(a.wts + (size_t)op.key * a.G + op.g, 1u);
}

__global__ void __launch_bounds__(kMaxBlock)
    wave_commit_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  const int units = a.T * a.chunks;
  const bool wide = a.chunks > 1;
  const int first = blockIdx.x;  // < units: the grid is at most units
  // The wave's claim tag, read once a thread before the first barrier.
  const unsigned ivw = claim::inv_wave_at(a.wave);
  // 1. install; the first unit's op stays in registers.
  const Op held = load_op(a, first);
  for (int u = first; u < units; u += gridDim.x) {
    const Op op = u == first ? held : load_op(a, u);
    install(a, op, ivw);
    if (wide && u % a.chunks == 0 && threadIdx.x == 0)
      a.commit[u / a.chunks] = true;
  }
  // 2. every install before any probe.
  grid.sync();
  // 3.-4. probe, verdict, lane reduction; one-block lanes bump here.
  for (int u = first; u < units; u += gridDim.x) {
    const Op op = u == first ? held : load_op(a, u);
    const bool c = verdict(a, op, ivw);
    if (a.words != nullptr) pack_word(a, u, c);
    const bool any = __syncthreads_or(c) != 0;
    const int t = u / a.chunks;
    if (wide) {
      if (any && threadIdx.x == 0) a.commit[t] = false;
    } else {
      if (threadIdx.x == 0) a.commit[t] = !any;
      if (a.bump && !any) bump(a, op);
    }
  }
  if (!wide || !a.bump) return;  // the same for every thread of the grid
  // 5. wide lanes: every block's verdict before any bump.
  grid.sync();
  const unsigned char* commit =
      reinterpret_cast<const unsigned char*>(a.commit);
  for (int u = first; u < units; u += gridDim.x) {
    const Op op = u == first ? held : load_op(a, u);
    if (__ldcg(commit + u / a.chunks)) bump(a, op);
  }
}

// Co-resident blocks of wave_commit_kernel for one block size, per device;
// 0 until queried.
int g_grid[kMaxDevices][kMaxBlock / 32 + 1];

cudaError_t grid_limit(int block, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* slot = dev < kMaxDevices ? &g_grid[dev][block / 32] : nullptr;
  if (slot != nullptr && *slot > 0) {
    *out = *slot;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, wave_commit_kernel, block, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *out = per_sm * sms;
  if (slot != nullptr) *slot = *out;
  return cudaSuccess;
}

}  // namespace

extern "C" int repro_wave_commit(
    void* claim_w, void* claim_r, void* wts, const void* keys,
    const void* groups, const void* prio, const void* do_w, const void* do_r,
    const void* check_w, const void* check_w2, const void* check_r,
    const void* extra, void* conflict, void* words, void* commit,
    const void* wave, int T, int K, int N, int G, int fine, int dual,
    int bump, void* stream) {
  if (wave == nullptr) return (int)cudaErrorInvalidValue;
  if (T <= 0 || K <= 0) return (int)cudaGetLastError();
  Args a{static_cast<unsigned*>(claim_w), static_cast<unsigned*>(claim_r),
         static_cast<unsigned*>(wts), static_cast<const int*>(keys),
         static_cast<const int*>(groups), static_cast<const int*>(prio),
         static_cast<const bool*>(do_w), static_cast<const bool*>(do_r),
         static_cast<const bool*>(check_w),
         static_cast<const bool*>(check_w2),
         static_cast<const bool*>(check_r), static_cast<const bool*>(extra),
         static_cast<bool*>(conflict), static_cast<int*>(words),
         static_cast<bool*>(commit), static_cast<const long long*>(wave), T,
         K, N, G, fine, dual, bump, 1};
  if ((conflict == nullptr) == (words == nullptr))
    return (int)cudaErrorInvalidValue;
  int block = ((K + 31) / 32) * 32;
  if (K > kMaxBlock) {
    block = kWideBlock;
    a.chunks = (K + kWideBlock - 1) / kWideBlock;
  }
  int limit = 0;
  cudaError_t e = grid_limit(block, &limit);
  if (e != cudaSuccess) return (int)e;
  const long long units = (long long)T * a.chunks;
  const int blocks = (int)(units < limit ? units : limit);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(wave_commit_kernel), dim3(blocks), dim3(block),
      params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

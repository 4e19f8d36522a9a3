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
//
// The bump form is a scan wave's phantom pass and its version bumps in one
// launch (the local waves of OCC, 2PL, SwissTM, Adaptive and AutoGran with
// scans).  It takes the wave's point conflicts `point`, the write mask `do`
// and the version table `wts` (as the claim table, [N, G]), writes point |
// phantom per op, and adds 1 to wts[key, group] for every op with `do` set,
// its cell in the table, and no conflict anywhere in its lane: the
// commit_install launch (occ_commit.cu) after this one and the torch OR,
// any, NOT and mask between them, folded in.  Its blocks hold whole lanes
// (256 / K of them, or one lane of more than 256 ops strided over 256
// threads), so a lane's verdict is one flag in shared memory and one
// __syncthreads(); each thread keeps the walk above.  The bumps add a key,
// a group and a mask byte an op to the bytes, and a word read and written
// per distinct bumped cell.
#include "claim.cuh"
#include "verdict_word.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarp = 32;
constexpr int kUnroll = 4;                  // rows a lane loads a batch
constexpr int kBatch = kWarp * kUnroll;     // rows a warp tests at once
constexpr int kBlock = 256;                 // threads of a bump-form block

// The phantom verdict of op i (has: the thread holds an op).  Every
// thread of the warp calls it together, the ones without an op too: the
// ballot and the walks are warp-wide.
__device__ __forceinline__ bool phantom_walk(
    const unsigned* __restrict__ table, const int* __restrict__ keys,
    const int* __restrict__ extents, const int* __restrict__ groups,
    const int* __restrict__ myprio, const bool* __restrict__ check, int i,
    bool has, int N, int G, unsigned ivw, int fine, int B, int span) {
  const int lane = threadIdx.x % kWarp;
  long long start = 0;
  int rows = 0, g = 0;
  unsigned p = 0;
  bool need = false;
  if (has && check[i]) {
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
  return conflict;
}

__global__ void iterate_validate_kernel(
    const unsigned* __restrict__ table, const int* __restrict__ keys,
    const int* __restrict__ extents, const int* __restrict__ groups,
    const int* __restrict__ myprio, const bool* __restrict__ check,
    bool* __restrict__ out, unsigned* __restrict__ words,
    const long long* __restrict__ wave, int n, int N, int G, int fine, int B,
    int span, int row, int W, int bit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned ivw = claim::inv_wave_at(wave);
  // blockDim.x is a multiple of 32: the threads past n walk with no op.
  const bool conflict = phantom_walk(table, keys, extents, groups, myprio,
                                     check, i, i < n, N, G, ivw, fine, B,
                                     span);
  if (i >= n) return;
  if (words == nullptr) {
    out[i] = conflict;
  } else if (conflict) {
    verdict::or_field(words, i, row, W, 1u << bit);
  }
}

// The bump form: a block holds `lanes` whole lanes of K ops (lanes x K <=
// kBlock, or one lane of K > kBlock ops strided over the block).  Pass 1:
// each op's verdict point | phantom, written out and OR-ed into its lane's
// flag in shared memory; pass 2, after one __syncthreads(): each op of a
// lane without a conflict that has `do` set and a cell in the table adds 1
// to wts (atomicAdd: wraps mod 2^32, any order gives occ_commit's table).
// Nothing in the launch reads wts, and a lane's verdict is its own ops',
// so no grid barrier is needed.
__global__ void __launch_bounds__(kBlock) iterate_validate_bump_kernel(
    const unsigned* __restrict__ table, const int* __restrict__ keys,
    const int* __restrict__ extents, const int* __restrict__ groups,
    const int* __restrict__ myprio, const bool* __restrict__ check,
    const bool* __restrict__ point, const bool* __restrict__ do_,
    unsigned* __restrict__ wts, bool* __restrict__ out,
    const long long* __restrict__ wave, int T, int K, int lanes, int N,
    int G, int fine, int B, int span) {
  __shared__ int lost[kBlock];  // a conflict in local lane l
  const unsigned ivw = claim::inv_wave_at(wave);
  const int lane0 = blockIdx.x * lanes;
  const int mine = T - lane0 < lanes ? T - lane0 : lanes;
  const int ops = mine * K;
  const int base = lane0 * K;
  if (threadIdx.x < lanes) lost[threadIdx.x] = 0;
  __syncthreads();
  // The trip count is the block's, so every warp walks in step.
  const int span_ops = lanes * K;
  for (int j0 = 0; j0 < span_ops; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool has = j < ops;
    const int i = base + j;
    bool c = phantom_walk(table, keys, extents, groups, myprio, check, i,
                          has, N, G, ivw, fine, B, span);
    if (has) {
      c = c || point[i];
      out[i] = c;
      if (c) lost[j / K] = 1;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ops; j += blockDim.x) {
    const int i = base + j;
    if (lost[j / K] || !do_[i]) continue;
    const int key = keys[i];
    const int g = groups[i];
    if (claim::in_cell(key, g, N, G)) atomicAdd(wts + (size_t)key * G + g, 1u);
  }
}

}  // namespace

extern "C" int repro_iterate_validate(const void* table, const void* keys,
                                      const void* extents, const void* groups,
                                      const void* myprio, const void* check,
                                      void* out, void* words,
                                      const void* wave, int n, int N, int G,
                                      int fine, int B, int span, int row,
                                      int W, int bit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wave == nullptr || (out == nullptr) == (words == nullptr) ||
      (words != nullptr &&
       (!verdict::valid_rows(n, row, W) || bit < 0 || bit > 1)))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    iterate_validate_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(extents), static_cast<const int*>(groups),
        static_cast<const int*>(myprio), static_cast<const bool*>(check),
        static_cast<bool*>(out), static_cast<unsigned*>(words),
        static_cast<const long long*>(wave), n, N, G, fine, B, span, row, W,
        bit);
  }
  return (int)cudaGetLastError();
}

// The bump form: ops [T, K]; point, do_, wts, out and wave all set.
extern "C" int repro_iterate_validate_bump(
    const void* table, const void* keys, const void* extents,
    const void* groups, const void* myprio, const void* check,
    const void* point, const void* do_, void* wts, void* out,
    const void* wave, int T, int K, int N, int G, int fine, int B, int span,
    void* stream) {
  if (point == nullptr || do_ == nullptr || wts == nullptr ||
      out == nullptr || wave == nullptr || T < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || K == 0) return (int)cudaGetLastError();
  const int lanes = K <= kBlock ? kBlock / K : 1;
  const int ops = lanes * K;
  const int threads = ops < kBlock ? (ops + kWarp - 1) / kWarp * kWarp
                                   : kBlock;
  iterate_validate_bump_kernel<<<(T + lanes - 1) / lanes, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(table), static_cast<const int*>(keys),
      static_cast<const int*>(extents), static_cast<const int*>(groups),
      static_cast<const int*>(myprio), static_cast<const bool*>(check),
      static_cast<const bool*>(point), static_cast<const bool*>(do_),
      static_cast<unsigned*>(wts), static_cast<bool*>(out),
      static_cast<const long long*>(wave), T, K, lanes, N, G, fine, B, span);
  return (int)cudaGetLastError();
}

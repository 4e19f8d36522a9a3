// route_pack: the sharded wave's sort-free, stable per-destination pack,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel route_pack_pallas in
// src/repro/kernels/route_pack.py; holds against the JAX oracle
// ref.route_pack and the plain PyTorch version route_pack_plain
// (src/repro_torch/kernels/route_pack.py).  owner is int32[M], vals
// int32[W, M]; op i with owner d in [0, n_dest) has rank pos[i] = the
// number of ops before it (in flat-op order) bound for d, exactly what a
// stable argsort by owner gives.  If pos[i] < cap the op lands at
// buf[w, d, pos[i]] = vals[w, i] and took[i] is set; otherwise it is
// dropped (took false, pos kept).  Ops with another owner are masked: pos
// 0, took false.  Cells that no op fills hold fills[w].
//
// Bound on this card: bytes, and far below a launch.  At the one-card
// sharded wave (M = 4,096 ops, W = 3, cap = 16,384) it reads 64 KB and
// writes 213 KB (mostly fill cells of the one destination), under 0.1 us
// at 3.35 TB/s.  Launch latency (4.8 us for an empty launch,
// launch/wave_commit_cost.py) and the dependent steps of the rank set the
// time.
//
// Design.  Ranks taken with atomicAdd on a per-destination counter would
// come out in whatever order the threads run, not the stable order, so an
// op's rank is counted, never claimed.  The earlier design gave each
// destination one 1,024-thread block that walked all M ops chunk by chunk
// and then wrote its fill cells alone: at one destination one SM did all
// of it (20.3 us for 147 KB of fill).  Here the grid is tiles of kThreads
// ops, one op a thread, at most as many blocks as the card keeps resident
// (a block takes a chunk of whole tiles), in one cooperative launch:
//   1. each block counts its chunk's ops per destination in shared memory
//      (__match_any_sync groups a warp's lanes by owner, and one leader a
//      group adds the group's size: counting is exact in any order) and
//      publishes the counts; its first tile's owners and payload words
//      stay in registers, so those loads overlap the barrier;
//   2. one grid barrier (grid.sync(), as wave_commit's);
//   3. each block sums the published counts, all loads in flight at once:
//      the earlier blocks' give its stable base per destination, all of
//      them the wave's total;
//   4. the block ranks its ops a tile at a time: __match_any_sync gives an
//      op its rank among its warp's lanes of the same owner, the group
//      leaders store the group sizes in a [warp][destination] table, and
//      one pass over the destinations turns it into exclusive per-warp
//      bases.  The op writes pos, took and its W payload words (one
//      writer a cell);
//   5. a grid-stride loop over all n_dest x cap cells writes fills[w] into
//      the cells past each destination's total; consecutive threads store
//      consecutive words of one channel, so the stores coalesce.
// A direct route in which every block counted every owner before its tile
// itself, with no barrier, was tried and dropped: at every wave size from
// 4,096 to 262,144 ops it was slower than this one on the H100 (the copy
// is not committed: no numbers), since its O(M) count a block cost more
// than the barrier.  Shared memory holds (2 + kWarps) words a
// destination, so n_dest is at most kMaxDest.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxChannels = 8;
constexpr int kThreads = 256;  // ops of a tile, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDest = 1024;
constexpr int kCountLoads = 4;  // published counts a thread loads at once

struct Args {
  const int* owner;
  const int* vals;
  int* buf;
  int* pos;
  bool* took;
  int* counts;  // [gridDim.x, n_dest]: each block's per-destination count
  int M, W, n_dest, cap;
  int chunk;  // ops a block ranks: a multiple of kThreads
  int fills[kMaxChannels];
};

size_t smem_bytes(int n_dest) {
  return sizeof(int) * (size_t)(2 + kWarps) * n_dest;
}

__global__ void __launch_bounds__(kThreads) route_pack_kernel(Args a) {
  extern __shared__ int sm[];
  const int n_dest = a.n_dest;
  int* base = sm;               // [n_dest] ops bound for d before the tile
  int* total = sm + n_dest;     // [n_dest] ops bound for d in the wave
  int* wcnt = sm + 2 * n_dest;  // [kWarps][n_dest] group sizes, then bases
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long c0 = (long long)blockIdx.x * a.chunk;
  const int c1 = (int)min((long long)a.M, c0 + a.chunk);
  for (int k = tid; k < (2 + kWarps) * n_dest; k += kThreads) sm[k] = 0;
  __syncthreads();

  // 1. Count the chunk's ops per destination (wcnt[0] as scratch) and
  //    publish the counts.  The first tile's owners and payload stay in
  //    registers, so their loads overlap the barrier.
  int o0 = -1;
  int v0[kMaxChannels];
  for (int s = (int)c0; s < c1; s += kThreads) {
    const int i = s + tid;
    const int o = i < c1 ? __ldg(&a.owner[i]) : -1;
    if (s == c0) {
      o0 = o;
#pragma unroll
      for (int w = 0; w < kMaxChannels; ++w)
        v0[w] = (w < a.W && o >= 0 && o < n_dest)
                    ? __ldg(&a.vals[(size_t)w * a.M + i])
                    : 0;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    if (o >= 0 && o < n_dest && (peers & below) == 0)
      atomicAdd(&wcnt[o], __popc(peers));
  }
  __syncthreads();
  for (int d = tid; d < n_dest; d += kThreads) {
    a.counts[(size_t)blockIdx.x * n_dest + d] = wcnt[d];
    wcnt[d] = 0;
  }
  // 2. Every block's counts are published.
  cg::this_grid().sync();
  // 3. Bases and totals from the published counts, kCountLoads loads a
  //    thread in flight before any add.
  const int entries = (int)gridDim.x * n_dest;
  for (int k0 = tid; k0 < entries; k0 += kThreads * kCountLoads) {
    int c[kCountLoads];
#pragma unroll
    for (int u = 0; u < kCountLoads; ++u) {
      const int k = k0 + u * kThreads;
      c[u] = k < entries ? __ldcg(&a.counts[k]) : 0;
    }
#pragma unroll
    for (int u = 0; u < kCountLoads; ++u) {
      if (c[u] == 0) continue;
      const int k = k0 + u * kThreads;
      const int d = k % n_dest;
      atomicAdd(&total[d], c[u]);
      if (k / n_dest < (int)blockIdx.x) atomicAdd(&base[d], c[u]);
    }
  }
  __syncthreads();

  // 4. Rank the chunk's ops, a tile at a time.
  for (int s = (int)c0; s < c1; s += kThreads) {
    const int i = s + tid;
    const bool first = s == c0;
    const int o = first ? o0 : i < c1 ? __ldg(&a.owner[i]) : -1;
    const bool live = o >= 0 && o < n_dest;
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    if (live && (peers & below) == 0) wcnt[warp * n_dest + o] = __popc(peers);
    __syncthreads();
    for (int d = tid; d < n_dest; d += kThreads) {
      int run = base[d];
      for (int w = 0; w < kWarps; ++w) {
        const int c = wcnt[w * n_dest + d];
        wcnt[w * n_dest + d] = run;
        run += c;
      }
      base[d] = run;
    }
    __syncthreads();
    if (i < c1) {
      if (live) {
        const int r = wcnt[warp * n_dest + o] + __popc(peers & below);
        a.pos[i] = r;
        a.took[i] = r < a.cap;
        if (r < a.cap) {
#pragma unroll
          for (int w = 0; w < kMaxChannels; ++w) {
            if (w < a.W)
              a.buf[((size_t)w * n_dest + o) * a.cap + r] =
                  first ? v0[w] : __ldg(&a.vals[(size_t)w * a.M + i]);
          }
        }
      } else {
        a.pos[i] = 0;
        a.took[i] = false;
      }
    }
    __syncthreads();
    for (int k = tid; k < kWarps * n_dest; k += kThreads) wcnt[k] = 0;
    __syncthreads();
  }

  // 5. This block's share of the fill cells.  Cell c = d * cap + r; (d, r)
  //    advance by the stride's quotient and remainder, so the loop divides
  //    once.
  if (a.cap == 0) return;
  const long long cells = (long long)n_dest * a.cap;
  const long long stride = (long long)gridDim.x * kThreads;
  long long c = (long long)blockIdx.x * kThreads + tid;
  long long d = c / a.cap;
  int r = (int)(c - d * a.cap);
  const long long step_d = stride / a.cap;
  const int step_r = (int)(stride - step_d * a.cap);
  for (; c < cells; c += stride) {
    if (r >= total[d]) {
#pragma unroll
      for (int w = 0; w < kMaxChannels; ++w) {
        if (w < a.W) a.buf[(size_t)w * cells + c] = a.fills[w];
      }
    }
    d += step_d;
    r += step_r;
    if (r >= a.cap) {
      r -= a.cap;
      ++d;
    }
  }
}

}  // namespace

// Blocks of the launch for M ops and n_dest destinations: no more than the
// card keeps resident (the grid barrier needs every block running), each
// ranking whole tiles.
extern "C" int repro_route_pack_blocks(int M, int n_dest, int* blocks) {
  if (n_dest < 1 || n_dest > kMaxDest) return (int)cudaErrorInvalidValue;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, route_pack_kernel, kThreads, smem_bytes(n_dest));
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = M > 0 ? (M + kThreads - 1) / kThreads : 1;
  const int limit = per_sm * sms;
  if (limit < 1) return (int)cudaErrorInvalidConfiguration;
  const int per = (tiles + limit - 1) / limit;  // tiles a block
  *blocks = (tiles + per - 1) / per;
  return 0;
}

// The pack on `blocks` blocks (repro_route_pack_blocks), with counts
// int32[blocks, n_dest] as scratch.
extern "C" int repro_route_pack(const void* owner, const void* vals,
                                void* buf, void* pos, void* took,
                                void* counts, int M, int W, int n_dest,
                                int cap, const int* fills, int blocks,
                                void* stream) {
  if (W > kMaxChannels || n_dest < 1 || n_dest > kMaxDest || cap < 0 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(owner), static_cast<const int*>(vals),
         static_cast<int*>(buf), static_cast<int*>(pos),
         static_cast<bool*>(took), static_cast<int*>(counts), M, W, n_dest,
         cap, 0, {}};
  for (int w = 0; w < W; ++w) a.fills[w] = fills[w];
  const int tiles = M > 0 ? (M + kThreads - 1) / kThreads : 1;
  a.chunk = (tiles + blocks - 1) / blocks * kThreads;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(route_pack_kernel), dim3(blocks),
      dim3(kThreads), params, smem_bytes(n_dest),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

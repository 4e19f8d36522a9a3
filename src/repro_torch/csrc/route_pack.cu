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
// at 3.35 TB/s.  The block's serial walk over the ops in chunks and launch
// latency set the time.
//
// Design.  Ranks taken with atomicAdd on a per-destination counter would
// come out in whatever order the threads run, not the stable order.  So
// one block owns one destination and walks all M ops in order, in chunks
// of blockDim threads: a warp ballot and popc give each matching op its
// rank inside the warp, a scan of the warp totals in shared memory its
// rank inside the chunk, and a running base (the same in every thread)
// carries the count from chunk to chunk.  Every buffer cell then has at
// most one writer, and the block writes the fill value into the cells past
// its destination's count.  Block 0 also writes pos/took of masked ops, so
// every op's pos and took are written exactly once.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 8;
constexpr int kThreads = 1024;

struct Fills {
  int v[kMaxChannels];
};

__global__ void __launch_bounds__(kThreads)
    route_pack_kernel(const int* __restrict__ owner,
                      const int* __restrict__ vals, int* __restrict__ buf,
                      int* __restrict__ pos, bool* __restrict__ took, int M,
                      int W, int n_dest, int cap, Fills fills) {
  __shared__ int warp_sum[32];
  const int d = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int base = 0;  // ops bound for d in the chunks already walked
  for (int start = 0; start < M; start += blockDim.x) {
    const int i = start + threadIdx.x;
    const int o = i < M ? owner[i] : -1;
    const bool match = i < M && o == d;
    const unsigned ballot = __ballot_sync(0xffffffffu, match);
    if (lane == 0) warp_sum[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int x = lane < n_warps ? warp_sum[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      warp_sum[lane] = x;
    }
    __syncthreads();
    if (match) {
      const int r = base + (warp ? warp_sum[warp - 1] : 0) +
                    __popc(ballot & below);
      pos[i] = r;
      took[i] = r < cap;
      if (r < cap) {
        for (int w = 0; w < W; ++w)
          buf[((size_t)w * n_dest + d) * cap + r] = vals[(size_t)w * M + i];
      }
    } else if (d == 0 && i < M && (o < 0 || o >= n_dest)) {
      pos[i] = 0;
      took[i] = false;
    }
    base += warp_sum[n_warps - 1];
    __syncthreads();  // warp_sum is rewritten by the next chunk
  }
  for (int r = min(base, cap) + threadIdx.x; r < cap; r += blockDim.x) {
    for (int w = 0; w < W; ++w)
      buf[((size_t)w * n_dest + d) * cap + r] = fills.v[w];
  }
}

}  // namespace

extern "C" int repro_route_pack(const void* owner, const void* vals,
                                void* buf, void* pos, void* took, int M,
                                int W, int n_dest, int cap,
                                const int* fills, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W > kMaxChannels) return (int)cudaErrorInvalidValue;
  Fills f = {};
  for (int w = 0; w < W; ++w) f.v[w] = fills[w];
  if (n_dest > 0) {
    route_pack_kernel<<<n_dest, kThreads, 0, s>>>(
        static_cast<const int*>(owner), static_cast<const int*>(vals),
        static_cast<int*>(buf), static_cast<int*>(pos),
        static_cast<bool*>(took), M, W, n_dest, cap, f);
  }
  return (int)cudaGetLastError();
}

// mv_install: one new ring slot per written record per wave, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mv_install_pallas in src/repro/kernels/mv_install.py;
// holds against the JAX oracle ref.mv_install and the plain PyTorch version
// mv_install_plain (src/repro_torch/kernels/mv_install.py).  begin is
// uint32[N, D, G], head int32[N]; for every record that an op with `do` set
// writes (key in [0, N)), against the PRE-wave head:
//   h_new = (head[key] + 1) mod D
//   begin[key, h_new, :] = begin[key, head[key], :]   (carry forward)
//   begin[key, h_new, g] = ts for every such op's group g in [0, G)
//   head[key] = h_new
// A head outside [0, D) carries a zero row forward, as the oracle's fill.
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a key,
// a group and a mask byte (9 B); per distinct written record it reads the
// head and one G-word slot and writes one slot and the head (24 B at G = 2):
// at T=128, K=64 under 100 KB, under 0.03 us at 3.35 TB/s.  The launch
// (4.8 us empty) and the barrier between copy and stamp set the time.
//
// Design.  The TPU kernel walks the ops on its sequential grid and tells a
// record's first op of the wave from a revisit by finding ts already in the
// row.  Blocks here run in no order, so every op resolves against the
// pre-wave head instead.  The two steps ran as two launches, whose boundary
// was the barrier; they are one cooperative launch now, its grid at most
// the co-resident blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs, queried once per device), with grid.sync() between them:
//   1. each masked op reads head[key] (nobody writes it before the
//      barrier), computes h_new and copies slot h_old to slot h_new.  Ops
//      of one record copy the same bytes; no op of this step writes a slot
//      another reads (h_new != h_old unless D = 1, where the copy is onto
//      itself);
//   2. grid.sync();
//   3. each masked op stamps begin[key, h_new, g] = ts and writes
//      head[key] = h_new: ops of one record write identical values.
// Step 3 must not re-read a head that another op has written, so each
// thread keeps its first op's h_new in a register across the barrier; a
// wave of more ops than the grid has threads (repro_mv_install_capacity)
// keeps the later ops' h_new in a scratch vector the wrapper passes, read
// back by the thread that wrote it.  So any number of ops on a record, in
// any order, gives the oracle's result.
//
// With packed commit words (the sharded owner's install: ops in rows of
// `row`, verdict_pack.cu's wire format, W words a row) op i installs only
// where do[i] and its 2-bit field is non-zero (verdict::field in step 1):
// the owner's verdict_unpack launch and the torch compare and mask before
// this launch, folded in.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mv_ring.cuh"
#include "verdict_word.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct Args {
  unsigned* begin;
  int* head;
  const int* keys;
  const int* groups;
  const bool* do_;
  const unsigned* words;  // packed commit words, or null
  int* scratch;  // h_new of the ops past the grid's first pass, or null
  const long long* ts;  // the install stamp, read in the kernel
  int n, N, D, G;
  int row, W;    // ops and words a row of words
};

// Step 1 for op i: its new slot (after copying the old one into it), or -1
// for an op that installs nothing.
__device__ __forceinline__ int copy_slot(const Args& a, int i) {
  const int key = a.keys[i];
  if (!a.do_[i] || key < 0 || key >= a.N) return -1;
  if (a.words != nullptr && verdict::field(a.words, i, a.row, a.W) == 0u)
    return -1;
  const int h_old = a.head[key];
  const int h_new = (((h_old + 1) % a.D) + a.D) % a.D;
  unsigned* row = a.begin + (size_t)key * a.D * a.G;
  const bool h_ok = h_old >= 0 && h_old < a.D;
  for (int j = 0; j < a.G; ++j)
    row[h_new * a.G + j] = h_ok ? row[h_old * a.G + j] : 0u;
  return h_new;
}

__global__ void __launch_bounds__(kThreads) mv_install_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const unsigned ts = mv::stamp_at(a.ts);  // read before the barrier
  int held = -1;
  // 1. copy forward, every op against the pre-wave head.
  for (int i = first; i < a.n; i += stride) {
    const int h_new = copy_slot(a, i);
    if (i == first)
      held = h_new;
    else
      a.scratch[i] = h_new;
  }
  // 2. every copy (and every head read) before any stamp or head write.
  grid.sync();
  // 3. stamp and advance the head.
  for (int i = first; i < a.n; i += stride) {
    const int h_new = i == first ? held : __ldcg(a.scratch + i);
    if (h_new < 0) continue;
    const int key = a.keys[i];
    const int g = a.groups[i];
    if (g >= 0 && g < a.G)
      a.begin[((size_t)key * a.D + h_new) * a.G + g] = ts;
    a.head[key] = h_new;
  }
}

// Co-resident blocks of mv_install_kernel per device; 0 until queried.
int g_grid[kMaxDevices];

cudaError_t grid_limit(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* slot = dev < kMaxDevices ? &g_grid[dev] : nullptr;
  if (slot != nullptr && *slot > 0) {
    *out = *slot;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mv_install_kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (slot != nullptr) *slot = *out;
  return cudaSuccess;
}

}  // namespace

// Ops one launch takes without scratch: the co-resident grid's threads.
extern "C" int repro_mv_install_capacity(int* ops) {
  int limit = 0;
  const cudaError_t e = grid_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  *ops = limit * kThreads;
  return 0;
}

// scratch: int32[n] when n exceeds repro_mv_install_capacity, else may be
// null.  words: null, or int32[n / row, W] packed commit words.  ts: the
// install stamp, an int64 in device memory.
extern "C" int repro_mv_install(void* begin, void* head, const void* keys,
                                const void* groups, const void* do_,
                                const void* words, void* scratch,
                                const void* ts, int n, int N, int D, int G,
                                int row, int W, void* stream) {
  if (ts == nullptr || (words != nullptr && !verdict::valid_rows(n, row, W)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  int limit = 0;
  cudaError_t e = grid_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const int need = (n + kThreads - 1) / kThreads;
  if (need > limit && scratch == nullptr) return (int)cudaErrorInvalidValue;
  Args a{static_cast<unsigned*>(begin), static_cast<int*>(head),
         static_cast<const int*>(keys), static_cast<const int*>(groups),
         static_cast<const bool*>(do_), static_cast<const unsigned*>(words),
         static_cast<int*>(scratch), static_cast<const long long*>(ts), n, N,
         D, G, row, W};
  const int blocks = need < limit ? need : limit;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mv_install_kernel), dim3(blocks),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

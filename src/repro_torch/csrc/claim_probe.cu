// claim_probe: claim install + post-install strongest-claimant probe on one
// claim table or on two, and the probe alone, for Hopper (sm_90a).
//
// repro_claim_probe_coop replaces the TPU kernel claim_probe_fused_pallas in
// src/repro/kernels/claim_probe.py; holds against the JAX oracle
// ref.claim_probe_fused and the plain PyTorch version claim_probe_plain
// (src/repro_torch/kernels/claim_probe.py).  repro_probe replaces the TPU
// kernel claim_probe_pallas in src/repro/kernels/occ_validate.py (the
// backend op probe); it holds against ref.claim_probe and probe_plain
// (src/repro_torch/kernels/wave_commit.py) and launches probe_kernel only.
// claim_probe min-installs the claim word (inv_wave << 16) | prio16 of
// every masked op, then returns for EVERY op the strongest live claimant
// prio16 of the post-install table: the op's own cell (fine) or the min
// over its row (coarse), kNoPrio where the key or the group is masked or
// nobody claims.  With a second table and mask (table_r, mask_r) it does
// the same on both tables, on the same keys, groups and priorities, and
// writes both answers: the sharded multi-version wave's two claim channels
// and the dual unfused wave's writer and reader tables, which were two
// calls of two launches each.
//
// Bound on this card: bytes, and far below one launch.  Per op it reads a
// key, a group, a priority and a mask byte per table (13 B, 14 B with two)
// and writes a 4-byte answer per table; each distinct probed cell (a row
// when coarse) is read once and each distinct installed cell written once:
// at T=128, K=64 under 250 KB a table, under 0.08 us at 3.35 TB/s.  Launch
// latency and the grid barrier set the time.  The probe alone reads 12 B
// an op (key, group, answer) plus each distinct probed cell or row: under
// 200 KB at T=128, K=64, one launch.
//
// Design.  The Pallas kernel answers from one row DMA plus an all-pairs
// in-VMEM wave term, which relies on the TPU's sequential grid and on the
// monotone-tag precondition.  Blocks on Hopper run in no order, so every
// install must land before any probe: the install and the probe ran as two
// launches whose boundary was the barrier.  Now they are one cooperative
// launch, as wave_commit.cu's, its grid at most the co-resident blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, queried once per
// device):
//   1. a grid-stride loop of atomicMin's into one or both tables: min is
//      commutative and idempotent, so any order gives the sequential
//      grid's tables;
//   2. grid.sync();
//   3. a grid-stride loop of probes, read through L2 (claim::probe_l2),
//      since L1 may hold words from before the barrier; with two tables
//      both probes are loaded before either answer is stored, so their
//      loads are in flight together.
// Each thread keeps its first op's key and group in registers across the
// barrier; later ops of a wave larger than the grid reload theirs.  No op
// carries state across the barrier, so the answer is the literal
// install-then-probe for any number of ops and needs no precondition.
//
// With two tables and a version ring (begin uint32[N, D, G], snap_ts) the
// launch also writes ok[i], the snapshot select's visibility flag of every
// op (mv::select, mv_gather's per-op body): the sharded multi-version
// owner's mv_gather launch on the same keys and groups, folded in.  The
// launch does not write the ring, so the reads go in step 1, before the
// barrier, under the installs and the barrier wait.  The ring adds D x G
// words per distinct live record and a flag byte an op to the bytes.
#include <cooperative_groups.h>

#include "claim.cuh"
#include "mv_ring.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct CoopArgs {
  unsigned* table;
  unsigned* table_r;  // nullptr: one table
  const int* keys;
  const int* groups;
  const int* prio;
  const bool* mask;
  const bool* mask_r;
  int* out;
  int* out_r;
  const unsigned* begin;  // nullptr: no ring read
  bool* ok;
  int n, N, G, D;
  unsigned ivw, snap_ts;
  int fine;
};

__global__ void __launch_bounds__(kThreads)
    claim_probe_kernel(const CoopArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const bool two = a.table_r != nullptr;
  int key0 = -1, g0 = 0;
  if (first < a.n) {
    key0 = a.keys[first];
    g0 = a.groups[first];
  }
  // 1. the installs, and the ring reads.
  for (int i = first; i < a.n; i += stride) {
    const bool m = a.mask[i];
    const bool mr = two && a.mask_r[i];
    const bool ring = a.begin != nullptr;
    if (!m && !mr && !ring) continue;
    const int key = i == first ? key0 : a.keys[i];
    const int g = i == first ? g0 : a.groups[i];
    if (ring) {
      int slot;
      a.ok[i] = mv::select(a.begin, key, g, a.N, a.D, a.G, a.fine,
                           a.snap_ts, &slot);
    }
    if ((!m && !mr) || !claim::in_cell(key, g, a.N, a.G)) continue;
    const unsigned word = claim::word(a.ivw, a.prio[i]);
    const size_t cell = (size_t)key * a.G + g;
    if (m) atomicMin(a.table + cell, word);
    if (mr) atomicMin(a.table_r + cell, word);
  }
  // 2. every install before any probe.
  grid.sync();
  // 3. the probes of the installed tables.
  for (int i = first; i < a.n; i += stride) {
    const int key = i == first ? key0 : a.keys[i];
    const int g = i == first ? g0 : a.groups[i];
    const unsigned w =
        claim::probe_l2(a.table, key, g, a.N, a.G, a.ivw, a.fine);
    const unsigned r =
        two ? claim::probe_l2(a.table_r, key, g, a.N, a.G, a.ivw, a.fine)
            : claim::kNoPrio;
    a.out[i] = (int)w;
    if (two) a.out_r[i] = (int)r;
  }
}

// Co-resident blocks of claim_probe_kernel per device; 0 until queried.
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
      &per_sm, claim_probe_kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (slot != nullptr) *slot = *out;
  return cudaSuccess;
}

__global__ void probe_kernel(const unsigned* __restrict__ table,
                             const int* __restrict__ keys,
                             const int* __restrict__ groups,
                             int* __restrict__ out, int n, int N, int G,
                             unsigned ivw, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (int)claim::probe(table, keys[i], groups[i], N, G, ivw, fine);
}

}  // namespace

// table_r, mask_r and out_r: all null (one table) or all set (two); begin
// and ok: both null (no ring read) or both set, with two tables.
extern "C" int repro_claim_probe_coop(void* table, void* table_r,
                                      const void* keys, const void* groups,
                                      const void* prio, const void* mask,
                                      const void* mask_r, void* out,
                                      void* out_r, const void* begin,
                                      void* ok, int n, int N, int G, int D,
                                      int ivw, unsigned snap_ts, int fine,
                                      void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if ((table_r == nullptr) != (mask_r == nullptr) ||
      (table_r == nullptr) != (out_r == nullptr) ||
      (begin == nullptr) != (ok == nullptr) ||
      (begin != nullptr && table_r == nullptr))
    return (int)cudaErrorInvalidValue;
  CoopArgs a{static_cast<unsigned*>(table),
             static_cast<unsigned*>(table_r),
             static_cast<const int*>(keys),
             static_cast<const int*>(groups),
             static_cast<const int*>(prio),
             static_cast<const bool*>(mask),
             static_cast<const bool*>(mask_r),
             static_cast<int*>(out),
             static_cast<int*>(out_r),
             static_cast<const unsigned*>(begin),
             static_cast<bool*>(ok),
             n,
             N,
             G,
             D,
             (unsigned)ivw,
             snap_ts,
             fine};
  int limit = 0;
  cudaError_t e = grid_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const int need = (n + kThreads - 1) / kThreads;
  const int blocks = need < limit ? need : limit;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(claim_probe_kernel), dim3(blocks),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int repro_probe(const void* table, const void* keys,
                           const void* groups, void* out, int n, int N,
                           int G, int ivw, int fine, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0)
    probe_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<int*>(out), n, N, G,
        (unsigned)ivw, fine);
  return (int)cudaGetLastError();
}

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
// writes both answers: the dual unfused wave's writer and reader tables,
// which were two calls of two launches each (the sharded multi-version
// wave's two claim channels take the verdict form below).
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
// The verdict form is the sharded owner's claim step: ops are rows of
// `row` ops (one row a source shard, i = d * row + j), and in place of the
// answers the launch writes the owner's 2-bit verdicts packed in the wire
// format of verdict_word.cuh (op j at bits 2*(j%16), 2*(j%16)+1 of word
// j/16 of row d; W = ceil(row/16) words a row), from the point-read mask
// rp and, with two tables and a version ring (begin uint32[N, D, G],
// snap_ts), the read mask rd and each op's snapshot visibility ok
// (mv::select, mv_gather's per-op body, folded in):
//   one table:  bit 0 = rp & w < p;
//   two tables: bit 0 = (mask_r & w < p) | (mask & !mask_r & r < p)
//                       | (rd & !ok),  bit 1 = rp & w < p.
// row is a multiple of 8, not of 16, so the ops of one word may lie in two
// warps: step 1 zeroes the words, and after the barrier each op with a
// field ORs it in with one atomicOr (commutative, so the order of the
// threads does not matter).  The answers and ok never reach global
// memory.  The launch does not write the ring, so a thread reads its
// first op's ok in step 1, under the installs and the barrier wait, keeps
// it across the barrier and selects later ops' after it.  This replaces
// the owner's compares, casts, mv_gather and verdict_pack launches; the
// words add 4 bytes a 16 ops, the ring D x G words per distinct live
// record, and the answers' 4 (or 8) bytes an op go.
#include <cooperative_groups.h>

#include "claim.cuh"
#include "mv_ring.cuh"
#include "verdict_word.cuh"

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
  int* out;               // nullptr in the verdict form
  int* out_r;
  const unsigned* begin;  // the verdict form's ring (two tables)
  const bool* rd;         // the verdict form's read mask (two tables)
  const bool* rp;         // the verdict form's point-read mask
  unsigned* words;        // nullptr: the answer form
  int n, N, G, D;
  int row, W;             // the verdict form's ops and words a row
  const long long* wave;     // the wave number, read in the kernel
  const long long* snap_ts;  // the ring's snapshot (two tables)
  int fine;
};

__global__ void __launch_bounds__(kThreads)
    claim_probe_kernel(const CoopArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const bool two = a.table_r != nullptr;
  const bool ring = a.begin != nullptr;
  const bool verdict = a.words != nullptr;
  // The wave's claim tag and the snapshot, read once a thread before the
  // barrier.
  const unsigned ivw = claim::inv_wave_at(a.wave);
  const unsigned snap = ring ? mv::stamp_at(a.snap_ts) : 0u;
  int key0 = -1, g0 = 0;
  bool ok0 = true;
  if (first < a.n) {
    key0 = a.keys[first];
    g0 = a.groups[first];
  }
  if (verdict) {
    const int n_words = a.n / a.row * a.W;
    for (int j = first; j < n_words; j += stride) a.words[j] = 0u;
  }
  // 1. the installs, and the ring reads.
  for (int i = first; i < a.n; i += stride) {
    const bool m = a.mask[i];
    const bool mr = two && a.mask_r[i];
    const bool read = ring && i == first;
    if (!m && !mr && !read) continue;
    const int key = i == first ? key0 : a.keys[i];
    const int g = i == first ? g0 : a.groups[i];
    if (read) {
      int slot;
      ok0 = mv::select(a.begin, key, g, a.N, a.D, a.G, a.fine, snap, &slot);
    }
    if ((!m && !mr) || !claim::in_cell(key, g, a.N, a.G)) continue;
    const unsigned word = claim::word(ivw, a.prio[i]);
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
    const unsigned w = claim::probe_l2(a.table, key, g, a.N, a.G, ivw, a.fine);
    const unsigned r =
        two ? claim::probe_l2(a.table_r, key, g, a.N, a.G, ivw, a.fine)
            : claim::kNoPrio;
    if (!verdict) {
      a.out[i] = (int)w;
      if (two) a.out_r[i] = (int)r;
      continue;
    }
    // 3'. the verdict form: the op's field, OR-ed into its word.
    const int p = a.prio[i];
    unsigned v;
    if (!two) {
      v = a.rp[i] && (int)w < p ? 1u : 0u;
    } else {
      bool ok = ok0;
      if (i != first) {
        int slot;
        ok = mv::select(a.begin, key, g, a.N, a.D, a.G, a.fine, snap, &slot);
      }
      const bool m = a.mask[i];
      const bool mr = a.mask_r[i];
      const bool b0 = (mr && (int)w < p) || (m && !mr && (int)r < p) ||
                      (a.rd[i] && !ok);
      const bool b1 = a.rp[i] && (int)w < p;
      v = (b0 ? 1u : 0u) | (b1 ? 2u : 0u);
    }
    if (v != 0u) verdict::or_field(a.words, i, a.row, a.W, v);
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
                             int* __restrict__ out,
                             const long long* __restrict__ wave, int n,
                             int N, int G, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (int)claim::probe(table, keys[i], groups[i], N, G,
                             claim::inv_wave_at(wave), fine);
}

}  // namespace

// The answer form: table_r, mask_r and out_r all null (one table) or all
// set (two); begin, rd, rp, words and snap_ts null.  The verdict form: out
// and out_r null, rp and words set, n a multiple of row > 0; with two
// tables (table_r, mask_r) begin, rd and snap_ts are set too, with one all
// three are null.  wave (int64, device memory) is always set.
extern "C" int repro_claim_probe_coop(
    void* table, void* table_r, const void* keys, const void* groups,
    const void* prio, const void* mask, const void* mask_r, void* out,
    void* out_r, const void* begin, const void* rd, const void* rp,
    void* words, const void* wave, const void* snap_ts, int n, int N, int G,
    int D, int row, int W, int fine, void* stream) {
  if (wave == nullptr || (begin == nullptr) != (snap_ts == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const bool two = table_r != nullptr;
  if (words == nullptr) {
    if (two != (mask_r != nullptr) || two != (out_r != nullptr) ||
        out == nullptr || begin != nullptr || rd != nullptr ||
        rp != nullptr)
      return (int)cudaErrorInvalidValue;
  } else if (two != (mask_r != nullptr) || two != (begin != nullptr) ||
             two != (rd != nullptr) || rp == nullptr || out != nullptr ||
             out_r != nullptr || !verdict::valid_rows(n, row, W)) {
    return (int)cudaErrorInvalidValue;
  }
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
             static_cast<const bool*>(rd),
             static_cast<const bool*>(rp),
             static_cast<unsigned*>(words),
             n,
             N,
             G,
             D,
             row,
             W,
             static_cast<const long long*>(wave),
             static_cast<const long long*>(snap_ts),
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
                           const void* groups, void* out, const void* wave,
                           int n, int N, int G, int fine, void* stream) {
  if (wave == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0)
    probe_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(table), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<int*>(out),
        static_cast<const long long*>(wave), n, N, G, fine);
  return (int)cudaGetLastError();
}

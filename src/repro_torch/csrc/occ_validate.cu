// validate and validate_dual: read-validation verdicts against claim tables,
// at one granularity (on one table, or per op on one or two of a pair) or at
// both from one claim-row read per op, for Hopper (sm_90a).
//
// Replace the TPU kernels occ_validate_pallas and occ_validate_dual_pallas in
// src/repro/kernels/occ_validate.py; hold against the JAX oracles
// ref.occ_validate and ref.occ_validate_dual and the plain PyTorch versions
// validate_plain and validate_dual_plain
// (src/repro_torch/kernels/occ_validate.py).  Per op:
//   fine   = check & (live prio16 of the op's own cell < myprio)
//   coarse = check & (min live prio16 over the record's row < myprio)
// validate writes the one its `fine` flag names, validate_dual both.  A
// masked key reads no row and gives no conflict; an out-of-range group
// gives none on the fine side.  validate's two-channel form (validate_pair)
// writes (check & verdict(claim_w)) | (check_r & verdict(claim_r)).
//
// Bound on this card: bytes, and far below a launch.  Per op they read a
// key, a group, a priority and one or two check bytes (13-14 B) and write
// one or two verdict bytes; each distinct checked row (G words) is read
// once: at T=128, K=64 under 200 KB, under 0.06 us at 3.35 TB/s.  Launch
// latency sets the time: an empty launch takes 4.8 us between its events
// on the H100 (launch/wave_commit_cost.py), the kernel about 5.8.
//
// Design.  The TPU kernels DMA each op's row inside a lane block.  Here one
// thread per op reads the rows its checks name (claim::probe) and decodes
// the verdicts from them; ops whose checks are all false read nothing,
// since their verdicts are then false.  Nothing is written to the tables,
// so thread order does not matter.  Since the launch is most of the time,
// the multi-version waves' two or three validate calls on the same ops
// (the write-write check on claim_w and on claim_r, MV-OCC's read check
// on claim_w) are one launch of validate_pair: the masks come from op
// kinds and are disjoint in the engine, but an op with both checks set
// reads both rows, so the kernel is exact for any masks.  Its two row
// reads do not depend on each other and are in flight together.
//
// validate_install: the multi-version wave's two claim installs and its
// two-channel check as one launch.  The waves scattered their write claims
// into claim_w and their plain-write claims into claim_r (claim_scatter,
// twice) and then ran validate_pair on the same ops: three launches and
// three [T, K] copies of the lane priority.  Here, for T lanes of K ops:
//   1. every op with install_w (install_r) set and its cell in the table
//      atomicMin's (inv_wave << 16) | prio16 into claim_w (claim_r), the
//      lane priority read as prio[i / K]: min is commutative and
//      idempotent, so any order gives the sequential grid's tables;
//   2. one grid barrier (grid.sync(), as wave_commit's): every install
//      before any check;
//   3. validate_pair's verdict per op, the rows read through L2 (__ldcg),
//      since this launch wrote them.
// One cooperative launch, its grid at most the co-resident blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, queried once per
// device); each thread keeps its first op in registers across the
// barrier, and a wave of more ops than the grid has threads strides, a
// later op reloaded after the barrier: no op carries state across it, so
// the kernel is exact for any number of ops.  The bytes are the
// one-channel kernels' (claim_scatter twice, validate_pair once), so the
// bound is theirs; the launch (4.8 us empty) and the barrier (~1.1 us in
// wave_commit) set the time.
//
// With a version ring (begin uint32[N, D, G], snap_ts) validate_install
// also writes ok[i], the snapshot select's visibility flag of every op
// (mv::select, mv_gather's per-op body): the multi-version wave's mv_gather
// launch, folded in.  No part of this launch writes the ring, so its reads
// go in step 1, before the barrier, where their latency hides under the
// installs and the barrier wait; every op loads its key and group for
// them, whatever its install and check flags.  The ring adds D x G words
// per distinct live record and a flag byte an op to the bytes.
//
// validate_dual_install: AutoGran's write-claim install and its dual check
// as one launch.  The wave scattered its write claims into claim_w
// (claim_scatter) and then ran validate_dual on the same ops: two launches
// and two [T, K] copies of the lane priority.  Here, on validate_install's
// plan: every op with `install` set and its cell in the table atomicMin's
// (inv_wave << 16) | prio16 into claim_w, prio[i / K] the lane priority;
// one grid barrier; then validate_dual's two verdicts from one row read
// through L2 (__ldcg): fine at the op's group, coarse as the row minimum.
// The same co-resident grid (its own occupancy query), the same stride
// past it.  The bytes are claim_scatter's and validate_dual's, so the
// bound is theirs.
#include <cooperative_groups.h>

#include "claim.cuh"
#include "mv_ring.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct InstallArgs {
  unsigned* claim_w;
  unsigned* claim_r;
  const int* keys;
  const int* groups;
  const int* prio;  // int32[T], the lane priority
  const bool* install_w;
  const bool* install_r;
  const bool* check;
  const bool* check_r;
  bool* out;
  const unsigned* begin;  // nullptr: no ring read
  bool* ok;
  const long long* wave;     // the wave number, read in the kernel
  const long long* snap_ts;  // the ring's snapshot (with begin)
  int n, K, N, G, D;
  int fine;
};

enum : unsigned { kIw = 1, kIr = 2, kCw = 4, kCr = 8 };

struct Op {
  int key, g;
  unsigned p;
  unsigned f;  // kIw | kIr | kCw | kCr as loaded
};

__device__ __forceinline__ Op load_op(const InstallArgs& a, int i) {
  Op op{};
  op.f = (a.install_w[i] ? kIw : 0u) | (a.install_r[i] ? kIr : 0u) |
         (a.check[i] ? kCw : 0u) | (a.check_r[i] ? kCr : 0u);
  if (op.f == 0 && a.begin == nullptr) return op;  // nothing to do
  op.key = a.keys[i];
  op.g = a.groups[i];
  op.p = (unsigned)a.prio[i / a.K];
  return op;
}

__global__ void __launch_bounds__(kThreads)
    validate_install_kernel(const InstallArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  // The wave's claim tag and the snapshot, read once a thread before the
  // barrier.
  const unsigned ivw = claim::inv_wave_at(a.wave);
  const unsigned snap = a.begin != nullptr ? mv::stamp_at(a.snap_ts) : 0u;
  const Op held = first < a.n ? load_op(a, first) : Op{};
  // 1. both installs, and the ring reads.
  for (int i = first; i < a.n; i += stride) {
    const Op op = i == first ? held : load_op(a, i);
    if (a.begin != nullptr) {
      int slot;
      a.ok[i] = mv::select(a.begin, op.key, op.g, a.N, a.D, a.G, a.fine,
                           snap, &slot);
    }
    if (!(op.f & (kIw | kIr)) || !claim::in_cell(op.key, op.g, a.N, a.G))
      continue;
    const unsigned word = claim::word(ivw, (int)op.p);
    const size_t cell = (size_t)op.key * a.G + op.g;
    if (op.f & kIw) atomicMin(a.claim_w + cell, word);
    if (op.f & kIr) atomicMin(a.claim_r + cell, word);
  }
  // 2. every install before any check.
  grid.sync();
  // 3. the two-channel verdict.
  for (int i = first; i < a.n; i += stride) {
    const Op op = i == first ? held : load_op(a, i);
    bool c = false;
    if (op.f & (kCw | kCr)) {
      const unsigned wp =
          (op.f & kCw) ? claim::probe_l2(a.claim_w, op.key, op.g, a.N, a.G,
                                         ivw, a.fine)
                       : claim::kNoPrio;
      const unsigned rp =
          (op.f & kCr) ? claim::probe_l2(a.claim_r, op.key, op.g, a.N, a.G,
                                         ivw, a.fine)
                       : claim::kNoPrio;
      c = ((op.f & kCw) && wp < op.p) || ((op.f & kCr) && rp < op.p);
    }
    a.out[i] = c;
  }
}

// validate_dual's install form: AutoGran's claim install and its dual
// check as one launch, on validate_install_kernel's plan.
struct DualArgs {
  unsigned* claim_w;
  const int* keys;
  const int* groups;
  const int* prio;  // int32[T], the lane priority
  const bool* install;
  const bool* check;
  bool* fine_out;
  bool* coarse_out;
  const long long* wave;  // the wave number, read in the kernel
  int n, K, N, G;
};

enum : unsigned { kInstall = 1, kCheck = 2 };

__device__ __forceinline__ Op load_dual_op(const DualArgs& a, int i) {
  Op op{};
  op.f = (a.install[i] ? kInstall : 0u) | (a.check[i] ? kCheck : 0u);
  if (op.f == 0) return op;  // nothing to do
  op.key = a.keys[i];
  op.g = a.groups[i];
  op.p = (unsigned)a.prio[i / a.K];
  return op;
}

__global__ void __launch_bounds__(kThreads)
    validate_dual_install_kernel(const DualArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  // The wave's claim tag, read once a thread before the barrier.
  const unsigned ivw = claim::inv_wave_at(a.wave);
  const Op held = first < a.n ? load_dual_op(a, first) : Op{};
  // 1. the install.
  for (int i = first; i < a.n; i += stride) {
    const Op op = i == first ? held : load_dual_op(a, i);
    if ((op.f & kInstall) && claim::in_cell(op.key, op.g, a.N, a.G))
      atomicMin(a.claim_w + (size_t)op.key * a.G + op.g,
                claim::word(ivw, (int)op.p));
  }
  // 2. every install before any check.
  grid.sync();
  // 3. both probe widths from one row read, through L2.
  for (int i = first; i < a.n; i += stride) {
    const Op op = i == first ? held : load_dual_op(a, i);
    const bool c = (op.f & kCheck) != 0;
    unsigned fp = claim::kNoPrio;
    unsigned cp = claim::kNoPrio;
    if (c && op.key >= 0 && op.key < a.N) {
      const unsigned* row = a.claim_w + (size_t)op.key * a.G;
      for (int j = 0; j < a.G; ++j) {
        const unsigned v = claim::live_prio(__ldcg(row + j), ivw);
        cp = min(cp, v);
        if (j == op.g) fp = v;
      }
    }
    a.fine_out[i] = c && fp < op.p;
    a.coarse_out[i] = c && cp < op.p;
  }
}

// Co-resident blocks of a cooperative kernel per device (`cache`, one slot
// a device; 0 until queried).
int g_grid_install[kMaxDevices];
int g_grid_dual[kMaxDevices];

template <typename Kernel>
cudaError_t grid_limit(Kernel kernel, int* cache, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* slot = dev < kMaxDevices ? &cache[dev] : nullptr;
  if (slot != nullptr && *slot > 0) {
    *out = *slot;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  if (slot != nullptr) *slot = *out;
  return cudaSuccess;
}

__global__ void validate_dual_kernel(const unsigned* __restrict__ claim_w,
                                     const int* __restrict__ keys,
                                     const int* __restrict__ groups,
                                     const int* __restrict__ myprio,
                                     const bool* __restrict__ check,
                                     bool* __restrict__ fine_out,
                                     bool* __restrict__ coarse_out,
                                     const long long* __restrict__ wave,
                                     int n, int N, int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned ivw = claim::inv_wave_at(wave);
  const bool c = check[i];
  const int key = keys[i];
  const int g = groups[i];
  unsigned fp = claim::kNoPrio;
  unsigned cp = claim::kNoPrio;
  if (c && key >= 0 && key < N) {
    const unsigned* row = claim_w + (size_t)key * G;
    for (int j = 0; j < G; ++j) {
      const unsigned v = claim::live_prio(row[j], ivw);
      cp = min(cp, v);
      if (j == g) fp = v;
    }
  }
  const unsigned p = (unsigned)myprio[i];
  fine_out[i] = c && fp < p;
  coarse_out[i] = c && cp < p;
}

__global__ void validate_kernel(const unsigned* __restrict__ claim_w,
                                const int* __restrict__ keys,
                                const int* __restrict__ groups,
                                const int* __restrict__ myprio,
                                const bool* __restrict__ check,
                                bool* __restrict__ out,
                                const long long* __restrict__ wave, int n,
                                int N, int G, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool c = check[i];
  const unsigned wprio = c ? claim::probe(claim_w, keys[i], groups[i], N, G,
                                          claim::inv_wave_at(wave), fine)
                           : claim::kNoPrio;
  out[i] = c && wprio < (unsigned)myprio[i];
}

__global__ void validate_pair_kernel(const unsigned* __restrict__ claim_w,
                                     const unsigned* __restrict__ claim_r,
                                     const int* __restrict__ keys,
                                     const int* __restrict__ groups,
                                     const int* __restrict__ myprio,
                                     const bool* __restrict__ check,
                                     const bool* __restrict__ check_r,
                                     bool* __restrict__ out,
                                     const long long* __restrict__ wave,
                                     int n, int N, int G, int fine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool cw = check[i];
  const bool cr = check_r[i];
  if (!cw && !cr) {
    out[i] = false;
    return;
  }
  const unsigned ivw = claim::inv_wave_at(wave);
  const int key = keys[i];
  const int g = groups[i];
  const unsigned wp =
      cw ? claim::probe(claim_w, key, g, N, G, ivw, fine) : claim::kNoPrio;
  const unsigned rp =
      cr ? claim::probe(claim_r, key, g, N, G, ivw, fine) : claim::kNoPrio;
  const unsigned p = (unsigned)myprio[i];
  out[i] = (cw && wp < p) || (cr && rp < p);
}

}  // namespace

extern "C" int repro_validate(const void* claim_w, const void* keys,
                              const void* groups, const void* myprio,
                              const void* check, void* out, const void* wave,
                              int n, int N, int G, int fine, void* stream) {
  if (wave == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    validate_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(claim_w), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const int*>(myprio),
        static_cast<const bool*>(check), static_cast<bool*>(out),
        static_cast<const long long*>(wave), n, N, G, fine);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_validate_dual(const void* claim_w, const void* keys,
                                   const void* groups, const void* myprio,
                                   const void* check, void* fine_out,
                                   void* coarse_out, const void* wave, int n,
                                   int N, int G, void* stream) {
  if (wave == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    validate_dual_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(claim_w), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const int*>(myprio),
        static_cast<const bool*>(check), static_cast<bool*>(fine_out),
        static_cast<bool*>(coarse_out), static_cast<const long long*>(wave),
        n, N, G);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_validate_pair(const void* claim_w, const void* claim_r,
                                   const void* keys, const void* groups,
                                   const void* myprio, const void* check,
                                   const void* check_r, void* out,
                                   const void* wave, int n, int N, int G,
                                   int fine, void* stream) {
  if (wave == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    validate_pair_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const unsigned*>(claim_w),
        static_cast<const unsigned*>(claim_r), static_cast<const int*>(keys),
        static_cast<const int*>(groups), static_cast<const int*>(myprio),
        static_cast<const bool*>(check), static_cast<const bool*>(check_r),
        static_cast<bool*>(out), static_cast<const long long*>(wave), n, N, G,
        fine);
  }
  return (int)cudaGetLastError();
}

// begin, ok and snap_ts: all null (no ring read) or all set; wave set.
extern "C" int repro_validate_install(
    void* claim_w, void* claim_r, const void* keys, const void* groups,
    const void* prio, const void* install_w, const void* install_r,
    const void* check, const void* check_r, void* out, const void* begin,
    void* ok, const void* wave, const void* snap_ts, int T, int K, int N,
    int G, int D, int fine, void* stream) {
  if (wave == nullptr || (begin == nullptr) != (ok == nullptr) ||
      (begin == nullptr) != (snap_ts == nullptr))
    return (int)cudaErrorInvalidValue;
  if (T <= 0 || K <= 0) return (int)cudaGetLastError();
  InstallArgs a{static_cast<unsigned*>(claim_w),
                static_cast<unsigned*>(claim_r),
                static_cast<const int*>(keys),
                static_cast<const int*>(groups),
                static_cast<const int*>(prio),
                static_cast<const bool*>(install_w),
                static_cast<const bool*>(install_r),
                static_cast<const bool*>(check),
                static_cast<const bool*>(check_r),
                static_cast<bool*>(out),
                static_cast<const unsigned*>(begin),
                static_cast<bool*>(ok),
                static_cast<const long long*>(wave),
                static_cast<const long long*>(snap_ts),
                T * K,
                K,
                N,
                G,
                D,
                fine};
  int limit = 0;
  cudaError_t e =
      grid_limit(validate_install_kernel, g_grid_install, &limit);
  if (e != cudaSuccess) return (int)e;
  const int need = (a.n + kThreads - 1) / kThreads;
  const int blocks = need < limit ? need : limit;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(validate_install_kernel), dim3(blocks),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// validate_dual's install form: ops [T, K], prio int32[T].
extern "C" int repro_validate_dual_install(
    void* claim_w, const void* keys, const void* groups, const void* prio,
    const void* install, const void* check, void* fine_out, void* coarse_out,
    const void* wave, int T, int K, int N, int G, void* stream) {
  if (install == nullptr || fine_out == nullptr || coarse_out == nullptr ||
      wave == nullptr || T < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || K == 0) return (int)cudaGetLastError();
  DualArgs a{static_cast<unsigned*>(claim_w),
             static_cast<const int*>(keys),
             static_cast<const int*>(groups),
             static_cast<const int*>(prio),
             static_cast<const bool*>(install),
             static_cast<const bool*>(check),
             static_cast<bool*>(fine_out),
             static_cast<bool*>(coarse_out),
             static_cast<const long long*>(wave),
             T * K,
             K,
             N,
             G};
  int limit = 0;
  cudaError_t e = grid_limit(validate_dual_install_kernel, g_grid_dual,
                             &limit);
  if (e != cudaSuccess) return (int)e;
  const int need = (a.n + kThreads - 1) / kThreads;
  const int blocks = need < limit ? need : limit;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(validate_dual_install_kernel), dim3(blocks),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// apply_values: a wave's committed writes replayed in serial order into the
// record values, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes engine.apply_values
// (src/repro/core/engine.py:95) with a lax.scan over the lanes.  Holds
// against that function and the plain PyTorch version apply_values_plain
// (src/repro_torch/kernels/apply_values.py).  values is float32 [N, C], or
// the version ring [N, D, C] with slot_of int32[N]; op i = lane * K + k of
// a committed lane whose kind is WRITE (2) or ADD (3), key in [0, N), col
// in [0, C) (and slot_of[key] in [0, D)) changes cell
//   cell = (key * D + slot) * C + col          (D = 1, slot = 0 when flat)
// in the serial order: lanes by ascending prio (unsigned, ties by lane),
// a lane's ops by slot k.  A WRITE sets the cell, an ADD adds to it in
// float32 (__fadd_rn: one rounding, as the reference's add).
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a
// key, a column, a kind and a value (16 B) and per lane a commit byte and a
// priority (5 B); each distinct written cell is read and written once
// (8 B).  At T = 128, K = 64 under 150 KB, about 0.05 us at 3.35 TB/s: the
// launches and the sort between them set the time.
//
// Design.  The serial result cannot come from a scatter: on this card
// duplicate indices of a set leave an unspecified winner and atomic adds
// land in no fixed order, so the float sums would differ in their last
// bits.  Two launches around one torch.sort instead:
//   1. keys: one thread an op writes the int64 sort key
//        cell * (T * K) + rank(prio of its lane) * K + k
//      (the rank counted over the T priorities, T at most a few thousand),
//      or INT64_MAX for an op that changes nothing;
//   2. the wrapper sorts the keys (torch.sort, which also returns each
//      key's op index), so each cell's ops lie together in serial order;
//   3. walk: one thread a sorted op; the first op of a cell's run reads the
//      stored value, applies the run's ops in order (set or add) and
//      stores once.  No other thread touches that cell.
// A hot cell (TPC-C's warehouse YTD, one ADD a payment) is one thread's
// walk of a few dozen ops.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWrite = 2;
constexpr int kAdd = 3;

__global__ void keys_kernel(const int* __restrict__ key,
                            const int* __restrict__ col,
                            const int* __restrict__ kind,
                            const bool* __restrict__ commit,
                            const int* __restrict__ prio,
                            const int* __restrict__ slot_of,
                            long long* __restrict__ out, int T, int K, int N,
                            int D, int C) {
  const long long n = (long long)T * K;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lane = (int)(i / K);
  const int k = (int)(i % K);
  const int kd = kind[i];
  const int ky = key[i];
  const int c = col[i];
  bool act = commit[lane] && (kd == kWrite || kd == kAdd) && ky >= 0 &&
             ky < N && c >= 0 && c < C;
  int slot = 0;
  if (act && slot_of != nullptr) {
    slot = slot_of[ky];
    act = slot >= 0 && slot < D;
  }
  if (!act) {
    out[i] = LLONG_MAX;
    return;
  }
  const unsigned p = (unsigned)prio[lane];
  int rank = 0;
  for (int j = 0; j < T; ++j) {
    const unsigned q = (unsigned)__ldg(prio + j);
    rank += (q < p) || (q == p && j < lane);
  }
  const long long cell = ((long long)ky * D + slot) * C + c;
  out[i] = cell * n + (long long)rank * K + k;
}

__global__ void walk_kernel(const long long* __restrict__ sorted,
                            const long long* __restrict__ perm,
                            const int* __restrict__ kind,
                            const float* __restrict__ val,
                            float* __restrict__ values, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long s = sorted[i];
  if (s == LLONG_MAX) return;
  const long long cell = s / n;
  // The sentinel sorts last, so the op before a live op is live.
  if (i > 0 && sorted[i - 1] / n == cell) return;
  float v = values[cell];
  for (int j = i; j < n; ++j) {
    const long long sj = sorted[j];
    if (sj == LLONG_MAX || sj / n != cell) break;
    const long long op = perm[j];
    v = kind[op] == kWrite ? val[op] : __fadd_rn(v, val[op]);
  }
  values[cell] = v;
}

}  // namespace

extern "C" int repro_apply_values_keys(const void* key, const void* col,
                                       const void* kind, const void* commit,
                                       const void* prio, const void* slot_of,
                                       void* out, int T, int K, int N, int D,
                                       int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)T * K;
  if (n > 0) {
    keys_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                  s>>>(
        static_cast<const int*>(key), static_cast<const int*>(col),
        static_cast<const int*>(kind), static_cast<const bool*>(commit),
        static_cast<const int*>(prio), static_cast<const int*>(slot_of),
        static_cast<long long*>(out), T, K, N, D, C);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_apply_values_walk(const void* sorted, const void* perm,
                                       const void* kind, const void* val,
                                       void* values, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    walk_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const long long*>(sorted),
        static_cast<const long long*>(perm), static_cast<const int*>(kind),
        static_cast<const float*>(val), static_cast<float*>(values), n);
  }
  return (int)cudaGetLastError();
}

// ts_install_max: monotone scatter-max timestamp install for TicToc, on one
// table or as TicToc's three installs in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel ts_install_max_pallas in
// src/repro/kernels/ts_install.py; holds against the JAX oracle
// ref.ts_install_max and the plain PyTorch version ts_install_max_plain
// (src/repro_torch/kernels/ts_install.py).  repro_ts_install_max: for every
// masked op with a key in [0, N): table[key, group] = max(table[key, group],
// val), unsigned; with whole_row, every group of the record.
//
// repro_ts_install_tictoc is a TicToc wave's three installs on the same ops
// and values, which were three launches: where mask is set, wts and rts
// take val at the op's cell; where ext is set, rts takes val at the op's
// cell, or every group of the record with ext_whole_row (the coarse
// extension).  Each op's value is its chained install stamp, computed here
// from commit_ts (int64[T]) and n_chain (float32[T, K]) as TicToc's wave
// gives them: (commit_ts[t] + 2 * (max(n_chain, 1) - 1)) mod 2**32
// (chain_stamps in src/repro_torch/kernels/ts_install.py).
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a
// key, a group, a value and one or two mask bytes and read-modify-writes at
// most a row of G words in each table: at T=128, K=64, G=2 under 250 KB,
// under 0.1 us at 3.35 TB/s.  Launch latency sets the time.
//
// Design.  The TPU kernel walks the ops on a sequential grid with the table
// aliased in and out; here one thread per op calls atomicMax, up to 2 + G
// times in the three-install form.  Max is commutative and idempotent, so
// any order of the atomics, across ops and across the three installs, gives
// the sequential grid's tables: the three installs need no barrier between
// them, and fold into one plain launch.
#include <cuda_runtime.h>

namespace {

struct Args {
  unsigned* table;
  unsigned* rts;  // nullptr: the one-table form (vals, whole_row)
  const int* keys;
  const int* groups;
  const unsigned* vals;        // the one-table form's values
  const long long* commit_ts;  // int64[T], with rts
  const float* n_chain;        // float32[T, K], with rts
  const bool* mask;
  const bool* ext;
  int n, K, N, G;
  int whole_row, ext_whole_row;
};

__device__ __forceinline__ void install(unsigned* row, int g, int G,
                                        unsigned v, int whole_row) {
  if (whole_row) {
    for (int j = 0; j < G; ++j) atomicMax(row + j, v);
  } else if (g >= 0 && g < G) {
    atomicMax(row + g, v);
  }
}

__global__ void ts_install_max_kernel(const Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const bool m = a.mask[i];
  const bool e = a.rts != nullptr && a.ext[i];
  if (!m && !e) return;
  const int key = a.keys[i];
  if (key < 0 || key >= a.N) return;
  const int g = a.groups[i];
  const size_t row = (size_t)key * a.G;
  if (a.rts == nullptr) {
    install(a.table + row, g, a.G, a.vals[i], a.whole_row);
    return;
  }
  // (long long) truncates as torch's .to(torch.int64) does.
  const long long chain = (long long)fmaxf(a.n_chain[i], 1.0f);
  const unsigned v = (unsigned)(a.commit_ts[i / a.K] + 2 * (chain - 1));
  if (m) {
    install(a.table + row, g, a.G, v, 0);
    install(a.rts + row, g, a.G, v, 0);
  }
  if (e) install(a.rts + row, g, a.G, v, a.ext_whole_row);
}

int launch(const Args& a, void* stream) {
  if (a.n > 0)
    ts_install_max_kernel<<<(a.n + 255) / 256, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_ts_install_max(void* table, const void* keys,
                                    const void* groups, const void* vals,
                                    const void* mask, int n, int N, int G,
                                    int whole_row, void* stream) {
  return launch(Args{static_cast<unsigned*>(table), nullptr,
                     static_cast<const int*>(keys),
                     static_cast<const int*>(groups),
                     static_cast<const unsigned*>(vals), nullptr, nullptr,
                     static_cast<const bool*>(mask), nullptr, n, 1, N, G,
                     whole_row, 0},
                stream);
}

extern "C" int repro_ts_install_tictoc(void* wts, void* rts,
                                       const void* keys, const void* groups,
                                       const void* commit_ts,
                                       const void* n_chain, const void* mask,
                                       const void* ext, int n, int K, int N,
                                       int G, int ext_whole_row,
                                       void* stream) {
  return launch(Args{static_cast<unsigned*>(wts),
                     static_cast<unsigned*>(rts),
                     static_cast<const int*>(keys),
                     static_cast<const int*>(groups), nullptr,
                     static_cast<const long long*>(commit_ts),
                     static_cast<const float*>(n_chain),
                     static_cast<const bool*>(mask),
                     static_cast<const bool*>(ext), n, K, N, G, 0,
                     ext_whole_row},
                stream);
}

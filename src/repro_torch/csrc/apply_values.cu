// apply_values: a wave's committed writes replayed in serial order into the
// record values, and into the version ring with the ring's copy-forward,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes engine.apply_values
// (src/repro/core/engine.py:95) with a lax.scan over the lanes, and the
// ring's copy-forward in mvstore.install_values (src/repro/core/mvstore.py
// :118) with two index ops.  Holds against those functions and the plain
// PyTorch version apply_values_plain (src/repro_torch/kernels/
// apply_values.py).  values is float32 [N, C], or the version ring
// [N, D, C] with slot_of int32[N] (the new heads).  Op i = lane * K + k
// changes a cell when its lane committed, its kind is WRITE (2) or ADD
// (3), its key lies in [0, N), its column in [-C, C) and, in the ring,
// slot_of[key] in [-D, D); a negative column or slot counts from the end
// once (col + C, slot + D), as the reference's indexing does:
//   cell = (key * D + slot) * C + col          (D = 1, slot = 0 when flat)
// in the serial order: lanes by ascending signed prio, ties by lane, a
// lane's ops by slot k (serial position rank(lane) * K + k).  A WRITE sets
// the cell, an ADD adds to it in float32 (__fadd_rn: one rounding, as the
// reference's add).  With head_old (the ring's heads before the wave's
// install), each committed write (WRITE or ADD, key in [0, N)) first copies
// its record's row from slot head_old[key] to slot slot_of[key], all C
// columns (zeros where head_old[key] lies outside [-D, D); nothing where
// slot_of[key] does), then the replay runs.
//
// Limits (the wrapper checks them): cells N * D * C < 2^31, so a cell is an
// int32 with bit 31 free for the WRITE flag.  The one-launch form takes
// T * K <= 8,192 ops and T <= 1,024 lanes: every wave the engines track
// (TPC-C 128 x 64, YCSB 128 x 16).  A larger wave takes the grid form: a
// rank launch writes each rank's lane to global memory, then the same
// replay kernel walks the serial order in chunks of 8,192.
//
// Bound on this card: bytes, and far below a launch.  Per op it reads a
// key, a column, a kind and a value (16 B) and per lane a commit byte and a
// priority (5 B); each distinct written cell is read and written once
// (8 B); the ring's copy reads and writes each written record's row once.
// At T = 128, K = 64 under 150 KB, about 0.05 us at 3.35 TB/s: the launch
// and the block's barriers set the time.  On an H100 a call of this shape
// takes about 16 us, an empty launch of the same grid about 5 us: the rest
// is the phases below, each one memory round trip or a few barriers.
//
// Design.  The serial result cannot come from a scatter: on this card
// duplicate indices of a set leave an unspecified winner and atomic adds
// land in no fixed order, so the float sums would differ in their last
// bits.  32 blocks of 1,024 threads; block b owns the records whose hash
// has b in its top 5 bits, so no two blocks touch one cell or one ring row,
// and a block needs no grid barrier.  Each block:
//   0. stages the wave's keys in shared memory (one-launch form), their
//      loads in flight while it ranks the lanes once: up to 32 threads a
//      lane count the lanes before it (T <= 1,024), and one stores its lane
//      at its rank;
//   1. (ring) copies the rows of its records' committed writes forward:
//      per 8,192 ops a list of (target row, source row) tasks in shared
//      memory (packed as in 2), then one thread a column of a task, then
//      __syncthreads();
//   2. per chunk of 8,192 serial positions: each thread takes 8, one a row
//      of 1,024, finds their ops through the rank table and their keys in
//      shared memory, and loads the rest (kind, column, value, commit) only
//      for its records' ops, all 8 ops' loads in flight at once; ballots
//      and one warp's scan of the (row, warp) counts pack the ops that
//      change a cell into a list in serial order;
//   3. an open-addressing table in shared memory groups the list by cell
//      (one 32-bit word a slot: count << 16 | first entry, claimed by
//      atomicCAS), and each group gets a range of a second list;
//   4. one warp places the list's entries into their groups' ranges in
//      serial order, 32 entries a step (__match_any_sync; the group's
//      leader advances its cursor), so each group keeps serial order;
//   5. one thread a group reads its cell once, applies the group's ops from
//      shared memory in order (set or add) and stores once.
// A hot cell (TPC-C's warehouse YTD, one ADD a payment) is one thread's
// walk of a few dozen ops from shared memory; a wave whose ops all hit one
// cell is one thread's walk of all of them, slow but right.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 8192;                    // serial positions a pass
constexpr int kItems = kChunk / kThreads;       // positions a thread
constexpr int kPartBits = 5;                    // 32 blocks
constexpr int kMaxLanes = 1024;                 // one-launch form's lanes
constexpr int kMinBits = 6;
constexpr int kMaxBits = 14;                    // table slots <= 2 * chunk
constexpr int kWrite = 2;
constexpr int kAdd = 3;
constexpr unsigned kWriteBit = 0x80000000u;     // in a list entry's cell
constexpr unsigned short kSlotWrite = 0x8000;   // in a list entry's slot
constexpr int kRankThreads = 256;
constexpr int kRankTile = 2048;

// Shared memory: the list (cell | write bit, value, table slot | write
// flag), the grouped list (list positions), the table, the rank table.
constexpr size_t kSmem = (size_t)kChunk * (4 + 4 + 2 + 2)
                         + (size_t)(1 << kMaxBits) * 4 + (size_t)kMaxLanes * 4;

__device__ __forceinline__ unsigned part_of(int key) {
  return ((unsigned)key * 0x9E3779B1u) >> (32 - kPartBits);
}

// (row, column) of position s of a [rows, K] array, then of s + kThreads,
// ...: one division, then a step each.
struct RowCol {
  int r, k, q, rem, K;
  __device__ RowCol(int s, int K_) : K(K_) {
    r = s / K;
    k = s - r * K;
    q = kThreads / K;
    rem = kThreads - q * K;
  }
  __device__ void next() {
    r += q;
    k += rem;
    if (k >= K) {
      k -= K;
      ++r;
    }
  }
};

__device__ __forceinline__ int slot_hash(unsigned cell, int bits) {
  return (int)(((unsigned long long)cell * 0xC2B2AE3D27D4EB4Full)
               >> (64 - bits));
}

// Places in a packed list for the entries a block keeps of kThreads *
// kItems positions laid out by rows (row it holds positions it * kThreads
// + threadIdx.x): rows in order, threads in order within a row.  on[it]:
// this thread keeps its entry of row it; at[it] gets the entry's place.
// counts: kItems * 32 + 1 ints of shared memory.  Returns the entries
// kept.  Two barriers; counts is free again after the next one.
__device__ int pack_rows(const bool (&on)[kItems], int (&at)[kItems],
                         int* counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned b[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    b[it] = __ballot_sync(0xffffffffu, on[it]);
    if (lane == 0) counts[it * 32 + warp] = __popc(b[it]);
  }
  __syncthreads();
  if (warp == 0) {  // each lane kItems consecutive counts, (row, warp) order
    int x[kItems], sum = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      x[j] = counts[lane * kItems + j];
      sum += x[j];
    }
    int inc = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    int run = inc - sum;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      counts[lane * kItems + j] = run;
      run += x[j];
    }
    if (lane == 31) counts[kItems * 32] = inc;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int it = 0; it < kItems; ++it)
    at[it] = counts[it * 32 + warp] + __popc(b[it] & below);
  return counts[kItems * 32];
}

// The lane of each serial rank over the whole grid (the grid form): one
// thread a lane counts the lanes before it in the order (prio signed, then
// lane), from tiles of the priorities in shared memory.
__global__ void __launch_bounds__(kRankThreads)
rank_kernel(const int* __restrict__ prio, int* __restrict__ lane_of_rank,
            int T) {
  __shared__ int tile[kRankTile];
  const int i = blockIdx.x * kRankThreads + threadIdx.x;
  const int p = i < T ? prio[i] : 0;
  int r = 0;
  for (int j0 = 0; j0 < T; j0 += kRankTile) {
    const int len = min(kRankTile, T - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += kRankThreads)
      tile[j] = prio[j0 + j];
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const int q = tile[j];
      r += (q < p) || (q == p && j0 + j < i);
    }
  }
  if (i < T) lane_of_rank[r] = i;
}

__global__ void __launch_bounds__(kThreads)
replay_kernel(const int* __restrict__ key, const int* __restrict__ col,
              const int* __restrict__ kind, const float* __restrict__ val,
              const bool* __restrict__ commit, const int* __restrict__ prio,
              const int* __restrict__ slot_of,
              const int* __restrict__ head_old,
              const int* __restrict__ ranked, float* __restrict__ values,
              int T, int K, int N, int D, int C) {
  extern __shared__ unsigned list_cell[];
  float* list_val = reinterpret_cast<float*>(list_cell + kChunk);
  unsigned short* list_slot =
      reinterpret_cast<unsigned short*>(list_val + kChunk);
  unsigned short* grouped = list_slot + kChunk;
  int* table = reinterpret_cast<int*>(grouped + kChunk);
  int* lanes = table + (1 << kMaxBits);
  __shared__ int counts[kItems * 32 + 1];
  __shared__ int n_alloc;
  const int tid = threadIdx.x;
  const unsigned me = blockIdx.x;
  const int n = T * K;

  // 0. The one-launch form stages the wave's keys (op order) in the
  //    list's memory, their loads in flight while it counts the rank table
  //    from the priorities staged in the table's memory; the grid form is
  //    given the rank table and reads keys from global memory.
  const int* lane_of_rank = ranked;
  const int* keys = key;
  if (ranked == nullptr) {
    int* staged = reinterpret_cast<int*>(list_cell);
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = it * kThreads + tid;
      if (i < n) staged[i] = key[i];
    }
    keys = staged;
    int* p = table;
    for (int i = tid; i < T; i += kThreads) p[i] = prio[i];
    __syncthreads();
    // per threads a lane (a power of two, at most 32), each counting a
    // strided share of the T priorities, summed by shuffles.
    int per = 32;
    while (per > 1 && per * T > kThreads) per >>= 1;
    const int li = tid / per, part = tid % per;
    const int mine = li < T ? p[li] : 0;
    int r = 0;
    if (li < T) {
#pragma unroll 4
      for (int j = part; j < T; j += per) {
        const int q = p[j];
        r += (q < mine) || (q == mine && j < li);
      }
    }
    for (int d = 1; d < per; d <<= 1) r += __shfl_xor_sync(0xffffffffu, r, d);
    if (li < T && part == 0) lanes[r] = li;
    lane_of_rank = lanes;
    __syncthreads();
  }

  // 1. The ring's copy-forward for this block's records, 8,192 ops at a
  //    time in op order: each committed write of a record of this block
  //    adds a task (target row, source row or -1 for zeros) to a list in
  //    the table's memory, then one thread a column of a task copies.
  //    Every task of a record copies the same row, so duplicates agree.
  if (head_old != nullptr) {
    int2* task = reinterpret_cast<int2*>(table);
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      // The keys first; the rest only for this block's records.
      int ky[kItems];
      bool w[kItems];
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int i = c0 + it * kThreads + tid;
        ky[it] = i < n ? keys[i] : -1;
        w[it] = (unsigned)ky[it] < (unsigned)N && part_of(ky[it]) == me;
      }
      int hn[kItems], ho[kItems];
      RowCol at_op(c0 + tid, K);
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int i = c0 + it * kThreads + tid;
        int kd = 0;
        bool cm = false;
        hn[it] = D;
        ho[it] = 0;
        if (w[it]) {
          kd = kind[i];
          cm = commit[at_op.r];
          hn[it] = slot_of[ky[it]];
          ho[it] = head_old[ky[it]];
        }
        w[it] = w[it] && cm && (kd == kWrite || kd == kAdd) &&
                hn[it] >= -D && hn[it] < D;
        at_op.next();
      }
      int at[kItems];
      const int n_task = pack_rows(w, at, counts);
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        if (!w[it]) continue;
        const int to = ((ky[it] * D) + hn[it] + (hn[it] < 0 ? D : 0)) * C;
        const int from = (ho[it] < -D || ho[it] >= D)
            ? -1 : ((ky[it] * D) + ho[it] + (ho[it] < 0 ? D : 0)) * C;
        task[at[it]] = make_int2(to, from);
      }
      __syncthreads();
      for (int x = tid; x < n_task * C; x += kThreads) {
        const int j = x / C, c = x - j * C;
        const int2 tk = task[j];
        values[tk.x + c] = tk.y < 0 ? 0.0f : values[tk.y + c];
      }
      __syncthreads();
    }
  }

  for (int s0 = 0; s0 < n; s0 += kChunk) {
    // 2. This thread's 8 serial positions, one a row of 1,024 (a warp
    //    reads 32 neighbours): the ops that change a cell of this block's
    //    records, as (cell | write bit, value).  Every load of the 8 is
    //    issued before any is used.
    int op[kItems], lane[kItems];
    RowCol at_s(s0 + tid, K);
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      op[it] = -1;
      lane[it] = 0;
      if (s0 + it * kThreads + tid < n) {
        lane[it] = lane_of_rank[at_s.r];
        op[it] = lane[it] * K + at_s.k;
      }
      at_s.next();
    }
    // The keys first; the rest only for this block's records.
    int ky[kItems];
    bool on[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      ky[it] = op[it] >= 0 ? keys[op[it]] : -1;
      on[it] = (unsigned)ky[it] < (unsigned)N && part_of(ky[it]) == me;
    }
    int kd[kItems], cl[kItems];
    bool cm[kItems];
    float v[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      kd[it] = on[it] ? kind[op[it]] : 0;
      cl[it] = on[it] ? col[op[it]] : 0;
      v[it] = on[it] ? val[op[it]] : 0.0f;
      cm[it] = on[it] && commit[lane[it]];
    }
    unsigned e[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      on[it] = on[it] && cm[it] && (kd[it] == kWrite || kd[it] == kAdd) &&
               (unsigned)(cl[it] + C) < (unsigned)(2 * C);
      e[it] = ((unsigned)ky[it] * (unsigned)(D * C)
               + (unsigned)(cl[it] + (cl[it] < 0 ? C : 0)))
              | (kd[it] == kWrite ? kWriteBit : 0u);
    }
    if (slot_of != nullptr) {
      int sl[kItems];
#pragma unroll
      for (int it = 0; it < kItems; ++it)
        sl[it] = on[it] ? slot_of[ky[it]] : 0;
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        on[it] = on[it] && sl[it] >= -D && sl[it] < D;
        e[it] += (unsigned)((sl[it] + (sl[it] < 0 ? D : 0)) * C);
      }
    }
    for (int i = tid; i < (1 << kMaxBits); i += kThreads) table[i] = -1;
    int at[kItems];
    const int m = pack_rows(on, at, counts);
    if (m == 0) continue;  // uniform: m is the block's total
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (on[it]) {
        list_cell[at[it]] = e[it];
        list_val[at[it]] = v[it];
      }
    }
    if (tid == 0) n_alloc = 0;
    __syncthreads();

    // 3. Group by cell: a table of at least 2 slots an entry (load <= 1/2).
    int bits = kMinBits;
    while ((1 << bits) < 2 * m && bits < kMaxBits) ++bits;
    const int slots = 1 << bits;
    volatile int* vtable = table;
    for (int k = tid; k < m; k += kThreads) {
      const unsigned cell = list_cell[k] & ~kWriteBit;
      int sl = slot_hash(cell, bits);
      for (;;) {
        int w = vtable[sl];
        if (w < 0) {
          w = atomicCAS(table + sl, -1, (1 << 16) | k);
          if (w < 0) break;
        }
        if ((list_cell[w & 0xFFFF] & ~kWriteBit) == cell) {
          atomicAdd(table + sl, 1 << 16);
          break;
        }
        sl = (sl + 1) & (slots - 1);
      }
      list_slot[k] = (unsigned short)(
          sl | ((list_cell[k] & kWriteBit) ? kSlotWrite : 0));
    }
    __syncthreads();
    // Each group's range of the grouped list: (start << 16 | count), a
    // warp's ranges taken together (slots is a multiple of 32).
    for (int sl = tid; sl < slots; sl += kThreads) {
      const int w = table[sl];
      const int cnt = w >= 0 ? w >> 16 : 0;
      int inc = cnt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, d);
        if ((tid & 31) >= d) inc += y;
      }
      int base = (tid & 31) == 31 ? atomicAdd(&n_alloc, inc) : 0;
      base = __shfl_sync(0xffffffffu, base, 31);
      if (w >= 0) table[sl] = ((base + inc - cnt) << 16) | cnt;
    }
    __syncthreads();

    // 4. One warp places the entries in serial order; the group's first
    //    lane in a step advances the group's cursor (the table word's high
    //    half) past the step's entries of that group.
    if (tid < 32) {
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int k = j0 + tid;
        const bool on = k < m;
        const int g = on ? (list_slot[k] & (kSlotWrite - 1)) : 0x10000 + tid;
        const unsigned peers = __match_any_sync(0xffffffffu, g);
        const int leader = __ffs(peers) - 1;
        int base = (on && tid == leader) ? (table[g] >> 16) : 0;
        base = __shfl_sync(0xffffffffu, base, leader);
        if (on) {
          grouped[base + __popc(peers & ((1u << tid) - 1))] =
              (unsigned short)k;
          if (tid == leader) table[g] += __popc(peers) << 16;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 5. One thread a group: its cell read once, its ops applied in serial
    //    order from shared memory, one store.
    for (int sl = tid; sl < slots; sl += kThreads) {
      const int w = table[sl];
      if (w < 0) continue;
      const int cnt = w & 0xFFFF, end = w >> 16;
      const unsigned cell = list_cell[grouped[end - cnt]] & ~kWriteBit;
      float x = values[cell];
      for (int p = end - cnt; p < end; ++p) {
        const int k = grouped[p];
        const float y = list_val[k];
        x = (list_slot[k] & kSlotWrite) ? y : __fadd_rn(x, y);
      }
      values[cell] = x;
    }
    __syncthreads();
  }
}

cudaError_t set_smem() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(replay_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
    if (e != cudaSuccess) return e;
    if (dev < 64) ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// The one-launch form: T * K <= 8,192, T <= 1,024.  slot_of and head_old
// may be NULL (the flat form; no copy-forward).
extern "C" int repro_apply_values(const void* key, const void* col,
                                  const void* kind, const void* val,
                                  const void* commit, const void* prio,
                                  const void* slot_of, const void* head_old,
                                  void* values, int T, int K, int N, int D,
                                  int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)T * K > kChunk || T > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  if (T <= 0 || K <= 0) return (int)cudaGetLastError();
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return (int)e;
  replay_kernel<<<1 << kPartBits, kThreads, kSmem, s>>>(
      static_cast<const int*>(key), static_cast<const int*>(col),
      static_cast<const int*>(kind), static_cast<const float*>(val),
      static_cast<const bool*>(commit), static_cast<const int*>(prio),
      static_cast<const int*>(slot_of), static_cast<const int*>(head_old),
      nullptr, static_cast<float*>(values), T, K, N, D, C);
  return (int)cudaGetLastError();
}

// The grid form, for any T * K < 2^31: the rank launch writes each rank's
// lane into lane_of_rank (int32[T], scratch), then the replay walks the
// serial order in chunks of 8,192.
extern "C" int repro_apply_values_grid(const void* key, const void* col,
                                       const void* kind, const void* val,
                                       const void* commit, const void* prio,
                                       const void* slot_of,
                                       const void* head_old, void* values,
                                       void* lane_of_rank, int T, int K,
                                       int N, int D, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || K <= 0) return (int)cudaGetLastError();
  cudaError_t e = set_smem();
  if (e != cudaSuccess) return (int)e;
  rank_kernel<<<(T + kRankThreads - 1) / kRankThreads, kRankThreads, 0, s>>>(
      static_cast<const int*>(prio), static_cast<int*>(lane_of_rank), T);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  replay_kernel<<<1 << kPartBits, kThreads, kSmem, s>>>(
      static_cast<const int*>(key), static_cast<const int*>(col),
      static_cast<const int*>(kind), static_cast<const float*>(val),
      static_cast<const bool*>(commit), static_cast<const int*>(prio),
      static_cast<const int*>(slot_of), static_cast<const int*>(head_old),
      static_cast<const int*>(lane_of_rank), static_cast<float*>(values), T,
      K, N, D, C);
  return (int)cudaGetLastError();
}

// Linear-probing hash tables for the hash breaker engine: GROUP BY insert,
// join build insert and join probe.
//
// Replaces: presto_tpu/ops/pallas_hash.py group_insert
// (_group_insert_kernel), join_insert (_join_insert_kernel) and join_probe
// (_join_probe_kernel). On the TPU each is one serial loop over the rows
// (grid=(1,)) with the table in one VMEM ref; here every row has a thread.
//
// Bound on this card: bytes, and in practice latency. Each row reads its
// K key planes and slot0 once and walks a short probe chain (load factor
// <= 50%) of dependent, uncoalesced 4- and 8-byte loads; there is almost no
// arithmetic. The bound used for reporting is the bytes of inputs read once
// plus outputs written once, over 3.35 TB/s.
//
// Design:
// - group_insert: one thread per live row walks (slot0 + j) & (tcap - 1).
//   A per-slot state word goes EMPTY -> CLAIMING -> READY (or DEAD) by
//   atomicCAS. The claiming thread writes the K key planes, takes a ticket
//   from the group counter, issues __threadfence(), then publishes READY if
//   its ticket is < cap, else DEAD. A thread that meets a CLAIMING slot
//   spins until it is published, then compares keys (L2 loads, after a
//   fence). A row whose key sits in a DEAD slot is unplaced; other keys
//   probe past DEAD slots, and DEAD slots stay out of `occ`. Each distinct
//   key claims exactly one slot (threads with one key walk one sequence),
//   so n_groups = min(distinct, cap) and overflow > 0 <=> more than cap
//   distinct keys: the contract of the serial kernel. Slots, and so group
//   order, differ from the serial kernel's; `table` keeps a DEAD slot's key
//   with occ = 0.
// - join_insert: one thread per live row claims the first slot of its
//   chain whose row is -1 with atomicCAS. Chain order is nondeterministic.
// - join_probe (redesigned for Hopper): one thread per probe row walks its
//   chain; the table (slot_row, then the build keys by row) is small next
//   to the 50 MB L2 and is read again by every probe batch of a query, so
//   it is read through L1 (__ldg measured faster than __ldcg, PERF.md).
//   Walking two or four rows a thread, interleaved, measured no faster:
//   Q3's chains are one or two slots long. A row's first F matches stay in
//   registers (F a power of two up to 16; a wider fanout, also a power of
//   two, stores matches as found) and the kernel writes every entry of
//   every row, dead rows included: matches, then -1 padding (as 16-byte
//   stores for F from 4 to 16), and the exact count. So mm and cnt need
//   no fill; rows with more than F matches are counted per warp by
//   shuffles and added to the one-word overflow counter once per block.
//   Match order within a row follows chain order, so it may differ from
//   the serial kernel's.
//
// The callers allocate every output; group_insert's and join_insert's
// are zeroed or filled by them; of join_probe's only the one-word overflow
// counter needs a fill, which its launcher issues. The kernels allocate
// nothing and do not synchronise.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kEmpty = 0, kClaiming = 1, kReady = 2, kDead = 3;

inline int blocks_for(int n) {
  int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

__global__ void group_insert_kernel(const int* __restrict__ slot0,
                                    const long long* __restrict__ keys,
                                    const bool* __restrict__ live,
                                    int* __restrict__ gid, long long* table,
                                    int* __restrict__ occ, int* state,
                                    int* stat, int n, int K, int cap) {
  const int tcap = 2 * cap;
  const int mask = tcap - 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (!live[i]) {
      gid[i] = tcap;
      continue;
    }
    const int s0 = slot0[i];
    int out = tcap;
    int j = 0;
    while (j < tcap) {
      const int s = (s0 + j) & mask;
      const int st = *(volatile int*)&state[s];
      if (st == kEmpty) {
        if (atomicCAS(&state[s], kEmpty, kClaiming) != kEmpty) continue;
        for (int k = 0; k < K; ++k)
          table[(long long)k * tcap + s] = keys[(long long)k * n + i];
        const int ticket = atomicAdd(&stat[2], 1);
        __threadfence();
        if (ticket < cap) {
          occ[s] = 1;
          atomicAdd(&stat[0], 1);
          out = s;
          atomicExch(&state[s], kReady);
        } else {
          atomicExch(&state[s], kDead);
        }
        break;
      }
      if (st == kClaiming) continue;  // spin until published
      __threadfence();
      bool eq = true;
      for (int k = 0; k < K && eq; ++k)
        eq = __ldcg(&table[(long long)k * tcap + s]) ==
             keys[(long long)k * n + i];
      if (eq) {
        if (st == kReady) out = s;
        break;
      }
      ++j;
    }
    gid[i] = out;
    if (out == tcap) atomicAdd(&stat[1], 1);
  }
}

__global__ void join_insert_kernel(const int* __restrict__ slot0,
                                   const bool* __restrict__ live,
                                   int* slot_row, int n, int tcap) {
  const int mask = tcap - 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (!live[i]) continue;
    const int s0 = slot0[i];
    for (int j = 0; j < tcap; ++j) {
      if (atomicCAS(&slot_row[(s0 + j) & mask], -1, i) == -1) break;
    }
  }
}

constexpr int kProbeThreads = 128;

// A probe row's first matches (or -1) as FT ints; FT is the fanout when it
// is at most 16 (the registers hold the row), 0 for a wider fanout
// (matches are stored as they are found and the rest padded after).
template <int FT>
struct MatchRow {
  int m[FT > 0 ? FT : 1];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int f = 0; f < (FT > 0 ? FT : 1); ++f) m[f] = -1;
  }
  __device__ __forceinline__ void put(int* mm_row, int c, int r) {
    if constexpr (FT > 0) {
#pragma unroll
      for (int f = 0; f < FT; ++f)
        if (f == c) m[f] = r;
    } else {
      mm_row[c] = r;
    }
  }
  __device__ __forceinline__ void store(int* mm_row, int c, int F) const {
    if constexpr (FT >= 4) {
#pragma unroll
      for (int q = 0; q < FT / 4; ++q)
        reinterpret_cast<int4*>(mm_row)[q] =
            make_int4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
    } else if constexpr (FT == 2) {
      *reinterpret_cast<int2*>(mm_row) = make_int2(m[0], m[1]);
    } else if constexpr (FT == 1) {
      mm_row[0] = m[0];
    } else {
      for (int f = c < F ? c : F; f < F; ++f) mm_row[f] = -1;
    }
  }
};

template <int FT>
__global__ void __launch_bounds__(kProbeThreads)
    join_probe_kernel(const int* __restrict__ slot0,
                      const long long* __restrict__ pkeys,
                      const bool* __restrict__ plive,
                      const int* __restrict__ slot_row,
                      const long long* __restrict__ bkeys,
                      int* __restrict__ mm, int* __restrict__ cnt, int* stat,
                      int n, int K, long long cap_b, int tcap, int F) {
  __shared__ int block_ovf;
  if (threadIdx.x == 0) block_ovf = 0;
  __syncthreads();
  const int mask = tcap - 1;
  int ovf = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    int* mm_row = mm + (long long)i * F;
    MatchRow<FT> out;
    out.init();
    int c = 0;
    if (plive[i]) {
      const int s0 = slot0[i];
      const long long key = pkeys[i];
      for (int j = 0; j < tcap; ++j) {
        const int r = __ldg(slot_row + ((s0 + j) & mask));
        if (r < 0) break;
        bool eq = __ldg(bkeys + r) == key;
        for (int k = 1; k < K && eq; ++k)
          eq = __ldg(bkeys + k * cap_b + r) == pkeys[(long long)k * n + i];
        if (eq) {
          if (c < F) out.put(mm_row, c, r);
          ++c;
        }
      }
    }
    out.store(mm_row, c, F);
    cnt[i] = c;
    ovf += c > F;
  }
  // rows over the fanout: counted per warp, added once per block
  const int lane = threadIdx.x & 31;
  int w = ovf;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    w += __shfl_xor_sync(0xffffffffu, w, off);
  if (lane == 0 && w) atomicAdd(&block_ovf, w);
  __syncthreads();
  if (threadIdx.x == 0 && block_ovf) atomicAdd(stat, block_ovf);
}

int sm_count() {
  static int count = 0;
  if (!count) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess || count <= 0)
      count = 132;
  }
  return count;
}

template <int FT>
cudaError_t launch_probe(const int* slot0, const long long* pkeys,
                         const bool* plive, const int* slot_row,
                         const long long* bkeys, int* mm, int* cnt, int* stat,
                         int n, int K, long long cap_b, int tcap, int F,
                         cudaStream_t stream) {
  int blocks = (n + kProbeThreads - 1) / kProbeThreads;
  const int max_blocks = sm_count() * (2048 / kProbeThreads);
  if (blocks > max_blocks) blocks = max_blocks;
  join_probe_kernel<FT><<<blocks, kProbeThreads, 0, stream>>>(
      slot0, pkeys, plive, slot_row, bkeys, mm, cnt, stat, n, K, cap_b, tcap,
      F);
  return cudaGetLastError();
}

}  // namespace

// slot0 int32[n]; keys int64[K, n]; live bool[n] -> gid int32[n];
// table int64[K, 2cap] (zeroed); occ int32[2cap] (zeroed); state int32[2cap]
// (zeroed scratch); stat int32[3] (zeroed: n_groups, overflow, tickets).
extern "C" int group_insert_launch(const void* slot0, const void* keys,
                                   const void* live, void* gid, void* table,
                                   void* occ, void* state, void* stat, int n,
                                   int K, int cap, void* stream) {
  if (n <= 0) return 0;
  group_insert_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)slot0, (const long long*)keys, (const bool*)live,
      (int*)gid, (long long*)table, (int*)occ, (int*)state, (int*)stat, n,
      K, cap);
  return (int)cudaGetLastError();
}

// slot0 int32[n]; live bool[n] -> slot_row int32[tcap] (filled with -1).
extern "C" int join_insert_launch(const void* slot0, const void* live,
                                  void* slot_row, int n, int tcap,
                                  void* stream) {
  if (n <= 0) return 0;
  join_insert_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)slot0, (const bool*)live, (int*)slot_row, n, tcap);
  return (int)cudaGetLastError();
}

// slot0 int32[n]; pkeys int64[K, n]; plive bool[n]; slot_row int32[tcap];
// bkeys int64[K, cap_b] -> mm int32[n, F] and cnt int32[n], every entry
// written (no fill needed; mm 16-byte aligned); F a power of two; stat
// int32[1]: rows with more than F matches, zeroed here first when
// zero_stat is set.
extern "C" int join_probe_launch(const void* slot0, const void* pkeys,
                                 const void* plive, const void* slot_row,
                                 const void* bkeys, void* mm, void* cnt,
                                 void* stat, int zero_stat, int n, int K,
                                 long long cap_b, int tcap, int F,
                                 void* stream) {
  if (K < 1 || F < 1 || (F & (F - 1))) return (int)cudaErrorInvalidValue;
  if (zero_stat) {
    cudaError_t e =
        cudaMemsetAsync(stat, 0, sizeof(int), (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  if (n <= 0) return 0;
  auto go = [&](auto ft) {
    return (int)launch_probe<decltype(ft)::value>(
        (const int*)slot0, (const long long*)pkeys, (const bool*)plive,
        (const int*)slot_row, (const long long*)bkeys, (int*)mm, (int*)cnt,
        (int*)stat, n, K, cap_b, tcap, F, (cudaStream_t)stream);
  };
  switch (F) {
    case 1: return go(std::integral_constant<int, 1>());
    case 2: return go(std::integral_constant<int, 2>());
    case 4: return go(std::integral_constant<int, 4>());
    case 8: return go(std::integral_constant<int, 8>());
    case 16: return go(std::integral_constant<int, 16>());
    default: return go(std::integral_constant<int, 0>());
  }
}

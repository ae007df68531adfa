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
// - join_probe: one thread per probe row walks its chain to the first
//   empty slot, verifies the K planes, writes the first F matches to
//   mm[i, :] (pre-filled with -1 by the caller) and keeps counting past F;
//   rows with count > F add one to the overflow counter. Match order within
//   a row follows chain order, so it may differ from the serial kernel's.
//
// Every output is allocated (and zeroed or filled) by the caller; the
// kernels allocate nothing and do not synchronise.

#include <cuda_runtime.h>

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

__global__ void join_probe_kernel(const int* __restrict__ slot0,
                                  const long long* __restrict__ pkeys,
                                  const bool* __restrict__ plive,
                                  const int* __restrict__ slot_row,
                                  const long long* __restrict__ bkeys,
                                  int* __restrict__ mm, int* __restrict__ cnt,
                                  int* stat, int n, int K, long long cap_b,
                                  int tcap, int F) {
  const int mask = tcap - 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    int c = 0;
    if (plive[i]) {
      const int s0 = slot0[i];
      for (int j = 0; j < tcap; ++j) {
        const int r = slot_row[(s0 + j) & mask];
        if (r < 0) break;
        bool eq = true;
        for (int k = 0; k < K && eq; ++k)
          eq = bkeys[k * cap_b + r] == pkeys[(long long)k * n + i];
        if (eq) {
          if (c < F) mm[(long long)i * F + c] = r;
          ++c;
        }
      }
    }
    cnt[i] = c;
    if (c > F) atomicAdd(&stat[0], 1);
  }
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
// bkeys int64[K, cap_b] -> mm int32[n, F] (filled with -1); cnt int32[n];
// stat int32[1] (zeroed: rows with more than F matches).
extern "C" int join_probe_launch(const void* slot0, const void* pkeys,
                                 const void* plive, const void* slot_row,
                                 const void* bkeys, void* mm, void* cnt,
                                 void* stat, int n, int K, long long cap_b,
                                 int tcap, int F, void* stream) {
  if (n <= 0) return 0;
  join_probe_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)slot0, (const long long*)pkeys, (const bool*)plive,
      (const int*)slot_row, (const long long*)bkeys, (int*)mm, (int*)cnt,
      (int*)stat, n, K, cap_b, tcap, F);
  return (int)cudaGetLastError();
}

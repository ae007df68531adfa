// Linear-probing hash tables for the hash breaker engine: GROUP BY insert,
// join build insert and join probe.
//
// Replaces: presto_tpu/ops/pallas_hash.py group_insert
// (_group_insert_kernel), join_insert (_join_insert_kernel) and join_probe
// (_join_probe_kernel). On the TPU each is one serial loop over the rows
// (grid=(1,)) with the table in one VMEM ref; here rows go in parallel.
//
// Bound on this card: bytes. Each row reads its key planes and slot0 once;
// the inserts write their whole table (gid, table and occ, or slot_row)
// once, and there is almost no arithmetic. The bound used for reporting is
// the bytes of inputs read once plus outputs written once, over 3.35 TB/s.
// What keeps the inserts from it is latency and scattered traffic: probe
// chains are dependent, uncoalesced 4- and 8-byte accesses, a claim is an
// atomic on a random slot, and on the partitioned path each row is stored
// once more, to a random bucket (the scatter is that path's costliest
// pass at the large shapes, PERF.md).
//
// Each insert has two paths; the caller's launch plan (ops/hash_kernels.py)
// asks for one by size, through `shift`, and `range_shift` below says
// whether a table can take that split (the global path where it cannot):
// - global (shift 0): the launch zeroes (or fills with -1) the outputs with
//   one cudaMemsetAsync, then one thread per live row walks (slot0 + j) &
//   (tcap - 1), with the table in the 50 MB L2 when it fits.
// - partitioned by slot range (shift > 0; a range is 2^shift slots): a
//   count pass and a scatter put (row, slot0) of the live rows into one
//   packed bucket per range, then one block per range inserts its bucket
//   in shared memory and writes its range of the table once, coalesced,
//   with no fill. A row whose chain runs past the end of its range goes to
//   a spill list, which the global kernel then inserts into the finished
//   table: ranges only grow, so every chain stays reachable.
//
// - group_insert: `occ` is the slot's state word (0 empty, 1 ready, 2
//   claiming; no separate state array). A row claims an empty slot with
//   atomicCAS, writes its key planes and publishes the slot with a release
//   store; other rows read the state with acquire loads before comparing
//   keys (no fences), and wait on a claiming slot, sleeping between reads:
//   without the sleep, lanes of a warp waiting on a claim by another lane
//   of their warp hung the card. Each new key takes a ticket; a key whose
//   ticket is >= cap is refused: the claimer frees the slot again (no row
//   has walked past a claiming slot, so no chain breaks) and its rows are
//   unplaced. So exactly min(distinct, cap) keys hold a slot, overflow
//   counts the unplaced live rows and is > 0 <=> more than cap distinct
//   keys, and the table is zero wherever occ is 0: the contract of the
//   serial kernel. When no more than cap rows come in, every key fits and
//   no ticket is taken: new keys are counted per block. n_groups =
//   min(tickets, cap), written by the last block to finish; unplaced rows
//   are counted per block. Lanes of a warp with the same key probe once
//   (one leader, found by __match_any_sync), since lineitem lists an
//   order's lines together. On the partitioned path a range block numbers
//   its new keys by a block scan and takes their tickets with one atomic.
//   Slots, and so group order, differ from the serial kernel's.
// - join_insert: one claim (atomicCAS of -1 to the row) at the first free
//   slot of the row's chain, in L2 or in the block's shared range. Chain
//   order is nondeterministic.
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
// The callers allocate every output and scratch buffer; the launches fill
// what needs a fill themselves. The kernels allocate nothing and do not
// synchronise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;
// group_insert slot states, held in occ
constexpr int kEmpty = 0, kReady = 1, kClaiming = 2;
// a range block's shared slot words (group_range_build_kernel): kEmpty,
// kSmClaiming, kSmReady; once numbered, kSmReady + the new key's number
constexpr int kSmClaiming = 1, kSmReady = 2;
// a row waiting on a slot that another row is claiming sleeps this long
// between reads, so that the claimer, maybe a lane of its own warp, runs
constexpr unsigned kWaitNs = 32;
// range kernels: threads a block, rows a count or scatter thread holds in
// registers
constexpr int kRangeThreads = 1024;
constexpr int kRangeRows = 8;
constexpr int kMaxRanges = 8192;
// fewer ranges leave most SMs idle in the range build (32 ranges lost to
// the global path, PERF.md)
constexpr int kMinRanges = 64;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in ceiling on sm_90

inline int blocks_for(int n) {
  int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// counter += (lanes calling together); each caller gets its own old value.
// One atomic per warp: the leader adds the count, then broadcasts.
__device__ __forceinline__ int warp_ticket(int* counter) {
  cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(counter, (int)g.size());
  return g.shfl(base, 0) + (int)g.thread_rank();
}

// Exclusive prefix sum of v over the block (every thread calls it).
__device__ int block_exclusive_scan(int v) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  return (warp ? warp_sums[warp - 1] : 0) + x - v;
}

// The lanes of `act` whose row has the same slot0 and key planes as this
// lane's (every lane of `act` calls it with its own row).
__device__ __forceinline__ unsigned same_key_lanes(unsigned act, int s0,
                                                   const long long* keys,
                                                   long long n, int row,
                                                   int K) {
  unsigned peers = __match_any_sync(act, s0);
  for (int k = 0; k < K; ++k)
    peers &= __match_any_sync(act, keys[k * n + row]);
  return peers;
}

// stat int32[4]: n_groups, overflow (unplaced live rows), tickets (keys
// that claimed a slot), blocks done.
//
// One thread per row (or per entry of a spill list). Lanes of a warp with
// the same key (Q18's lineitem lists an order's lines together) probe
// once: the lowest of them walks the chain and hands the slot to the
// others, so that lanes of one warp do not wait on one another's claim of
// one slot. kTickets: take a ticket per new key and refuse keys past cap;
// without it (no more than cap rows), count new keys per block.
template <bool kTickets>
__global__ void __launch_bounds__(kThreads)
    group_insert_kernel(const int* __restrict__ slot0,
                        const long long* __restrict__ keys,
                        const bool* __restrict__ live,
                        const int2* __restrict__ list,
                        const int* __restrict__ list_n,
                        int* __restrict__ gid, long long* table, int* occ,
                        int* stat, int n, int K, int cap) {
  __shared__ int acc[2];  // new keys, unplaced rows
  if (threadIdx.x < 2) acc[threadIdx.x] = 0;
  __syncthreads();
  const int tcap = 2 * cap;
  const int mask = tcap - 1;
  const int lane = threadIdx.x & 31;
  const int count = list ? *list_n : n;
  int claims = 0, unplaced = 0;
  // a warp's lanes go round this loop together (the trip count is the
  // block's), so that they can match keys
  for (int first = blockIdx.x * blockDim.x; first < count;
       first += gridDim.x * blockDim.x) {
    const int i = first + threadIdx.x;
    int row = -1, s0 = 0;
    if (i < count) {
      if (list) {
        const int2 e = list[i];
        row = e.x;
        s0 = e.y;
      } else if (live[i]) {
        row = i;
        s0 = slot0[i];
      } else {
        gid[i] = tcap;
      }
    }
    const unsigned act = __ballot_sync(kFull, row >= 0);
    if (row < 0) continue;
    const unsigned peers = same_key_lanes(act, s0, keys, n, row, K);
    const int leader = __ffs(peers) - 1;
    int out = tcap;
    if (lane == leader) {
      const long long key0 = K ? keys[row] : 0;
      for (int j = 0; j < tcap;) {
        const int s = (s0 + j) & mask;
        const int st = ld_acquire(occ + s);
        if (st == kEmpty) {
          if (atomicCAS(occ + s, kEmpty, kClaiming) != kEmpty) continue;
          if (kTickets && atomicAdd(stat + 2, 1) >= cap) {
            st_relaxed(occ + s, kEmpty);  // refused: free the slot again
            break;
          }
          if (K) table[s] = key0;
          for (int k = 1; k < K; ++k)
            table[(long long)k * tcap + s] = keys[(long long)k * n + row];
          st_release(occ + s, kReady);
          ++claims;
          out = s;
          break;
        }
        if (st == kClaiming) {  // wait until it is published
          __nanosleep(kWaitNs);
          continue;
        }
        bool eq = !K || table[s] == key0;
        for (int k = 1; k < K && eq; ++k)
          eq = table[(long long)k * tcap + s] == keys[(long long)k * n + row];
        if (eq) {
          out = s;
          break;
        }
        ++j;
      }
    }
    out = __shfl_sync(peers, out, leader);
    gid[row] = out;
    unplaced += out == tcap;
  }
  if (claims) atomicAdd(&acc[0], claims);
  if (unplaced) atomicAdd(&acc[1], unplaced);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!kTickets && acc[0]) atomicAdd(stat + 2, acc[0]);
    if (acc[1]) atomicAdd(stat + 1, acc[1]);
    __threadfence();
    if (atomicAdd(stat + 3, 1) == (int)gridDim.x - 1) {  // the last block
      __threadfence();
      const int t = atomicAdd(stat + 2, 0);
      stat[0] = t < cap ? t : cap;
    }
  }
}

// One thread per live row (or spill-list entry) claims the first free slot
// of its chain. (Two or four rows a thread, their claims in flight
// together, measured slower: PERF.md.)
__global__ void __launch_bounds__(kThreads)
    join_insert_kernel(const int* __restrict__ slot0,
                       const bool* __restrict__ live,
                       const int2* __restrict__ list,
                       const int* __restrict__ list_n, int* slot_row, int n,
                       int tcap) {
  const int mask = tcap - 1;
  const int count = list ? *list_n : n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x) {
    int row, s;
    if (list) {
      const int2 e = list[i];
      row = e.x;
      s = e.y;
    } else {
      if (!live[i]) continue;
      row = i;
      s = slot0[i];
    }
    for (int j = 0; j < tcap && atomicCAS(slot_row + s, -1, row) != -1; ++j)
      s = (s + 1) & mask;
  }
}

// Partitioned path, pass 1: live rows per range, then the last block
// turns the counts into bucket offsets[P + 1] and scatter cursors[P].
// hdr: [0] blocks done, [1] spill count, [2, 2 + P) counts, zeroed by the
// launch. Block 0 zeroes stat (if any) for the passes that follow. A
// thread holds kRangeRows rows at once, their loads in flight together.
__global__ void __launch_bounds__(kRangeThreads)
    range_count_kernel(const int* __restrict__ slot0,
                       const bool* __restrict__ live, int* hdr, int* cursor,
                       int* offsets, int* stat, int n, int shift, int P) {
  extern __shared__ int hist[];
  __shared__ bool last;
  for (int b = threadIdx.x; b < P; b += blockDim.x) hist[b] = 0;
  if (stat && blockIdx.x == 0 && threadIdx.x < 4) stat[threadIdx.x] = 0;
  __syncthreads();
  const int tile = kRangeRows * blockDim.x;
  for (long long t0 = (long long)blockIdx.x * tile; t0 < n;
       t0 += (long long)gridDim.x * tile) {
    int s[kRangeRows];
    bool l[kRangeRows];
#pragma unroll
    for (int q = 0; q < kRangeRows; ++q) {
      const long long i = t0 + q * blockDim.x + threadIdx.x;
      l[q] = i < n && live[i];
      s[q] = i < n ? slot0[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < kRangeRows; ++q)
      if (l[q]) atomicAdd(&hist[s[q] >> shift], 1);
  }
  __syncthreads();
  int* counts = hdr + 2;
  for (int b = threadIdx.x; b < P; b += blockDim.x)
    if (hist[b]) atomicAdd(counts + b, hist[b]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(hdr, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int per = (P + blockDim.x - 1) / blockDim.x;
  const int b0 = min(P, (int)threadIdx.x * per), b1 = min(P, b0 + per);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += __ldcg(counts + b);
  int at = block_exclusive_scan(sum);
  for (int b = b0; b < b1; ++b) {
    offsets[b] = cursor[b] = at;
    at += __ldcg(counts + b);
  }
  if (threadIdx.x == blockDim.x - 1) offsets[P] = at;
}

// Partitioned path, the scatter: each block takes tiles of kRangeRows *
// blockDim rows, counts them per range in shared memory, reserves each
// range's place in its bucket with one atomic on the range's cursor, then
// writes (row, slot0) of every live row there: the buckets lie packed,
// one after another. Dead rows get gid = dead_gid if gid.
__global__ void __launch_bounds__(kRangeThreads)
    range_scatter_kernel(const int* __restrict__ slot0,
                         const bool* __restrict__ live, int* cursor,
                         int2* pairs, int* gid, int dead_gid, int n,
                         int shift, int P) {
  extern __shared__ int sh[];
  int* cnt = sh;
  int* base = sh + P;
  const int tile = kRangeRows * blockDim.x;
  for (long long t0 = (long long)blockIdx.x * tile; t0 < n;
       t0 += (long long)gridDim.x * tile) {
    for (int b = threadIdx.x; b < P; b += blockDim.x) cnt[b] = 0;
    __syncthreads();
    int s[kRangeRows];
    bool l[kRangeRows];
#pragma unroll
    for (int q = 0; q < kRangeRows; ++q) {
      const long long i = t0 + q * blockDim.x + threadIdx.x;
      l[q] = i < n && live[i];
      s[q] = i < n ? slot0[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < kRangeRows; ++q) {
      const long long i = t0 + q * blockDim.x + threadIdx.x;
      if (l[q])
        atomicAdd(&cnt[s[q] >> shift], 1);
      else if (gid && i < n)
        gid[i] = dead_gid;
    }
    __syncthreads();
    for (int b = threadIdx.x; b < P; b += blockDim.x) {
      const int c = cnt[b];
      if (c) {
        base[b] = atomicAdd(cursor + b, c);
        cnt[b] = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRangeRows; ++q) {
      if (!l[q]) continue;
      const int b = s[q] >> shift;
      pairs[base[b] + atomicAdd(&cnt[b], 1)] =
          make_int2((int)(t0 + q * blockDim.x + threadIdx.x), s[q]);
    }
    __syncthreads();
  }
}

// Partitioned group_insert, one block per range of R = 2^shift slots: its
// rows (bucket [offsets[r], offsets[r+1]) of pairs) insert into shared
// memory (key planes, then slot words: kEmpty, kSmClaiming, kSmReady);
// rows whose chain reaches the range end spill. Then the block numbers
// its new keys in slot order (ballots and a block scan, no atomic a
// claim), takes their tickets with one atomic, writes its range of occ and
// table once and each row's gid. A pair's y is overwritten with the row's
// slot in the range (-1: spilled).
__global__ void __launch_bounds__(kRangeThreads)
    group_range_build_kernel(int2* pairs, const int* __restrict__ offsets,
                             const long long* __restrict__ keys,
                             int* __restrict__ gid, long long* table,
                             int* occ, int* stat, int2* spill, int* spill_n,
                             int n, int K, int cap, int shift) {
  extern __shared__ long long tk[];  // K x R key planes, then R slot words
  __shared__ int first_ticket, unplaced_total;
  const int R = 1 << shift;
  const int tcap = 2 * cap;
  const int lane = threadIdx.x & 31;
  int* st = reinterpret_cast<int*>(tk + (long long)K * R);
  volatile long long* vtk = tk;
  volatile int* vst = st;
  for (int t = threadIdx.x; t < R; t += blockDim.x) st[t] = kEmpty;
  if (threadIdx.x == 0) first_ticket = unplaced_total = 0;
  __syncthreads();
  const int r0 = blockIdx.x << shift;
  const int beg = offsets[blockIdx.x], end = offsets[blockIdx.x + 1];
  for (int e = beg + threadIdx.x; e < end; e += blockDim.x) {
    const int2 p = pairs[e];
    const long long key0 = K ? keys[p.x] : 0;
    int found = -1;
    for (int j = p.y & (R - 1); j < R;) {
      const int v = vst[j];
      if (v == kEmpty) {
        if (atomicCAS(st + j, kEmpty, kSmClaiming) != kEmpty) continue;
        if (K) vtk[j] = key0;
        for (int k = 1; k < K; ++k)
          vtk[(long long)k * R + j] = keys[(long long)k * n + p.x];
        __threadfence_block();
        vst[j] = kSmReady;
        found = j;
        break;
      }
      if (v == kSmClaiming) {  // wait until it is published
        __nanosleep(kWaitNs);
        continue;
      }
      __threadfence_block();
      bool eq = !K || vtk[j] == key0;
      for (int k = 1; k < K && eq; ++k)
        eq = vtk[(long long)k * R + j] == keys[(long long)k * n + p.x];
      if (eq) {
        found = j;
        break;
      }
      ++j;
    }
    if (found < 0) spill[atomicAdd(spill_n, 1)] = p;
    reinterpret_cast<int*>(pairs)[2LL * e + 1] = found;
  }
  __syncthreads();
  // number the new keys in slot order (st = kSmReady + number): each warp
  // takes a span of consecutive slots, 32 at a time, counted by ballots
  const int span = R / (blockDim.x >> 5);  // a multiple of 32
  const int w0 = (threadIdx.x >> 5) * span;
  int used = 0;
  for (int t = w0 + lane; t < w0 + span; t += 32)
    used += __popc(__ballot_sync(kFull, st[t] != kEmpty));
  int at = __shfl_sync(kFull, block_exclusive_scan(lane ? 0 : used), 0);
  for (int t = w0 + lane; t < w0 + span; t += 32) {
    const bool mine = st[t] != kEmpty;
    const unsigned ballot = __ballot_sync(kFull, mine);
    if (mine) st[t] = kSmReady + at + __popc(ballot & ((1u << lane) - 1));
    at += __popc(ballot);
  }
  if (threadIdx.x == blockDim.x - 1 && at)  // at: the block's new keys
    first_ticket = atomicAdd(stat + 2, at);
  __syncthreads();
  const int t0 = first_ticket;
  for (int t = threadIdx.x; t < R; t += blockDim.x) {
    const int v = st[t];
    const bool keep = v >= kSmReady && t0 + (v - kSmReady) < cap;
    occ[r0 + t] = keep;
    for (int k = 0; k < K; ++k)
      table[(long long)k * tcap + r0 + t] = keep ? tk[(long long)k * R + t] : 0;
  }
  int unplaced = 0;
  for (int e = beg + threadIdx.x; e < end; e += blockDim.x) {
    const int2 p = pairs[e];  // written above by this block
    if (p.y < 0) continue;    // spilled: the spill pass places it
    const bool keep = t0 + (st[p.y] - kSmReady) < cap;
    gid[p.x] = keep ? r0 + p.y : tcap;
    unplaced += !keep;
  }
  unplaced = __reduce_add_sync(kFull, unplaced);
  if (lane == 0 && unplaced) atomicAdd(&unplaced_total, unplaced);
  __syncthreads();
  if (threadIdx.x == 0 && unplaced_total) atomicAdd(stat + 1, unplaced_total);
}

// Partitioned join_insert, one block per range of R = 2^shift slots: its
// rows (bucket [offsets[r], offsets[r+1]) of pairs) claim slots of the
// range in shared memory; a row whose chain reaches the range end spills.
// Then the range of slot_row, -1 where empty, is written once with
// 16-byte stores.
__global__ void __launch_bounds__(kRangeThreads)
    join_range_build_kernel(const int2* __restrict__ pairs,
                            const int* __restrict__ offsets, int* slot_row,
                            int2* spill, int* spill_n, int shift) {
  extern __shared__ int4 srow4[];
  int* srow = reinterpret_cast<int*>(srow4);
  const int R = 1 << shift;
  for (int q = threadIdx.x; q < R / 4; q += blockDim.x)
    srow4[q] = make_int4(-1, -1, -1, -1);
  __syncthreads();
  const int end = offsets[blockIdx.x + 1];
  for (int e = offsets[blockIdx.x] + threadIdx.x; e < end; e += blockDim.x) {
    const int2 p = pairs[e];
    int j = p.y & (R - 1);
    while (j < R && atomicCAS(srow + j, -1, p.x) != -1) ++j;
    if (j == R) spill[warp_ticket(spill_n)] = p;
  }
  __syncthreads();
  int4* dst = reinterpret_cast<int4*>(slot_row + ((long long)blockIdx.x << shift));
  for (int q = threadIdx.x; q < R / 4; q += blockDim.x) dst[q] = srow4[q];
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

namespace {

// The count and scatter kernels' grid: at least a tile of kRangeRows rows
// a thread a block, at most two blocks an SM.
int range_blocks(int n) {
  const long long most = 2LL * sm_count();
  const long long b = ((long long)n + kRangeRows * kRangeThreads - 1) /
                      (kRangeRows * kRangeThreads);
  return b < 1 ? 1 : (int)(b < most ? b : most);
}

// Scratch of a partitioned insert, carved from one buffer: hdr = [blocks
// done, spill count, counts[P]] (zeroed by the launch), cursor[P],
// offsets[P + 1], then int2 (row, slot0) buckets of the live rows,
// packed, and a spill list: n entries each.
struct RangeScratch {
  int* hdr;
  int* cursor;
  int* offsets;
  int2* pairs;
  int2* spill;
  long long zero_bytes;
  long long bytes;
};

RangeScratch range_scratch(void* base, int n, int P) {
  RangeScratch g;
  const long long head = ((2LL + 3LL * P + 1) * 4 + 15) / 16 * 16;
  g.hdr = static_cast<int*>(base);
  g.cursor = g.hdr + 2 + P;
  g.offsets = g.cursor + P;
  g.pairs = reinterpret_cast<int2*>(static_cast<char*>(base) + head);
  g.spill = g.pairs + n;
  g.zero_bytes = (2LL + P) * 4;
  g.bytes = head + 16LL * n;
  return g;
}

// Count and scatter: (row, slot0) of the live rows into packed buckets,
// one a range; dead rows get gid = dead_gid if gid.
cudaError_t range_partition(const int* s0, const bool* lv, int* gid,
                            int dead_gid, int* stat, const RangeScratch& r,
                            int n, int shift, int P, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(r.hdr, 0, r.zero_bytes, s);
  if (e != cudaSuccess) return e;
  const int blocks = range_blocks(n);
  range_count_kernel<<<blocks, kRangeThreads, 4 * P, s>>>(
      s0, lv, r.hdr, r.cursor, r.offsets, stat, n, shift, P);
  range_scatter_kernel<<<blocks, kRangeThreads, 8 * P, s>>>(
      s0, lv, r.cursor, r.pairs, gid, dead_gid, n, shift, P);
  return cudaSuccess;
}

// Opt a kernel in to as much dynamic shared memory as its static shared
// memory leaves of kMaxSmem; returns that size (0 after an error).
template <typename F>
int allow_max_smem(F* kernel, cudaError_t* err) {
  cudaFuncAttributes a;
  if (*err == cudaSuccess) *err = cudaFuncGetAttributes(&a, kernel);
  if (*err != cudaSuccess) return 0;
  const int most = kMaxSmem - (int)a.sharedSizeBytes;
  *err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  return *err == cudaSuccess ? most : 0;
}

// The range kernels' opt-in, once per process: the dynamic shared memory
// the group and join range builds may take (0 if the opt-in failed).
struct RangeSmem {
  int group = 0, join = 0;
};

const RangeSmem& range_smem() {
  static const RangeSmem smem = [] {
    RangeSmem m;
    cudaError_t e = cudaSuccess;
    allow_max_smem(range_scatter_kernel, &e);
    m.group = allow_max_smem(group_range_build_kernel, &e);
    m.join = allow_max_smem(join_range_build_kernel, &e);
    if (e != cudaSuccess) m = RangeSmem();
    return m;
  }();
  return smem;
}

// The one rule for which split a partitioned insert can take: ranges of
// 2^shift slots (slot_bytes of shared memory a slot) if a range has at
// least a slot a thread of a range block, the table kMinRanges to
// kMaxRanges ranges, and a range's shared table fits in smem bytes; else
// 0, the global path.
int range_shift(int tcap, int shift, long long slot_bytes, int smem) {
  if (shift <= 0 || shift > 30) return 0;
  const long long R = 1LL << shift, P = tcap / R;
  return R >= kRangeThreads && P >= kMinRanges && P <= kMaxRanges &&
                 slot_bytes * R <= smem
             ? shift
             : 0;
}

}  // namespace

// The path of group_insert (K key planes, cap) and of join_insert (tcap
// slots) when the launch plan asks for ranges of 2^shift slots: shift
// where range_shift admits it, else 0 (the global path). A launch refuses
// any other shift.
extern "C" int group_insert_shift(int K, int cap, int shift) {
  if (K < 0 || cap < 1 || cap > (1 << 29)) return 0;
  return range_shift(2 * cap, shift, 8LL * K + 4, range_smem().group);
}

extern "C" int join_insert_shift(int tcap, int shift) {
  return range_shift(tcap, shift, 4, range_smem().join);
}

// Bytes of scratch a partitioned insert of n rows into tcap slots needs
// (0 for the global path).
extern "C" long long insert_scratch_bytes(int n, int tcap, int shift) {
  return shift > 0 ? range_scratch(nullptr, n, tcap >> shift).bytes : 0;
}

// slot0 int32[n]; keys int64[K, n]; live bool[n] -> gid int32[n];
// table int64[K, 2cap]; occ int32[2cap]; stat int32[4] (n_groups,
// overflow, tickets, blocks done). Every output is written here: on the
// global path (shift 0) table, occ and stat must be adjacent in that order
// (one allocation), and one memset zeroes them; on the partitioned path
// (ranges of 2^shift slots) scratch holds insert_scratch_bytes(n, 2cap,
// shift).
extern "C" int group_insert_launch(const void* slot0, const void* keys,
                                   const void* live, void* gid, void* table,
                                   void* occ, void* stat, void* scratch,
                                   int n, int K, int cap, int shift,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tcap = 2 * cap;
  const int* s0 = static_cast<const int*>(slot0);
  const long long* kp = static_cast<const long long*>(keys);
  const bool* lv = static_cast<const bool*>(live);
  int* g = static_cast<int*>(gid);
  long long* tb = static_cast<long long*>(table);
  int* oc = static_cast<int*>(occ);
  int* st = static_cast<int*>(stat);
  if (K < 0 || cap < 1) return (int)cudaErrorInvalidValue;
  if (shift <= 0) {
    if (oc != reinterpret_cast<int*>(tb + (long long)K * tcap) ||
        st != oc + tcap)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemsetAsync(
        table, 0, (8LL * K + 4) * tcap + 16, s);
    if (e != cudaSuccess) return (int)e;
    if (n <= 0) return 0;
    if (n <= cap)  // every key fits: no tickets
      group_insert_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
          s0, kp, lv, nullptr, nullptr, g, tb, oc, st, n, K, cap);
    else
      group_insert_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
          s0, kp, lv, nullptr, nullptr, g, tb, oc, st, n, K, cap);
    return (int)cudaGetLastError();
  }
  if (group_insert_shift(K, cap, shift) != shift || !scratch)
    return (int)cudaErrorInvalidValue;
  const int P = tcap >> shift;
  const RangeScratch r = range_scratch(scratch, n, P);
  cudaError_t e = range_partition(s0, lv, g, tcap, st, r, n, shift, P, s);
  if (e != cudaSuccess) return (int)e;
  group_range_build_kernel<<<P, kRangeThreads, (8LL * K + 4) << shift, s>>>(
      r.pairs, r.offsets, kp, g, tb, oc, st, r.spill, r.hdr + 1, n, K, cap,
      shift);
  group_insert_kernel<true><<<sm_count(), kThreads, 0, s>>>(
      s0, kp, lv, r.spill, r.hdr + 1, g, tb, oc, st, n, K, cap);
  return (int)cudaGetLastError();
}

// slot0 int32[n]; live bool[n] -> slot_row int32[tcap], every slot written
// (-1 where empty). Partitioned (ranges of 2^shift slots) when shift > 0,
// with insert_scratch_bytes(n, tcap, shift) of scratch.
extern "C" int join_insert_launch(const void* slot0, const void* live,
                                  void* slot_row, void* scratch, int n,
                                  int tcap, int shift, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* s0 = static_cast<const int*>(slot0);
  const bool* lv = static_cast<const bool*>(live);
  int* sr = static_cast<int*>(slot_row);
  if (shift <= 0) {
    cudaError_t e = cudaMemsetAsync(slot_row, 0xFF, 4LL * tcap, s);
    if (e != cudaSuccess) return (int)e;
    if (n <= 0) return 0;
    join_insert_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        s0, lv, nullptr, nullptr, sr, n, tcap);
    return (int)cudaGetLastError();
  }
  if (join_insert_shift(tcap, shift) != shift || !scratch)
    return (int)cudaErrorInvalidValue;
  const int P = tcap >> shift;
  const RangeScratch r = range_scratch(scratch, n, P);
  cudaError_t e =
      range_partition(s0, lv, nullptr, 0, nullptr, r, n, shift, P, s);
  if (e != cudaSuccess) return (int)e;
  join_range_build_kernel<<<P, kRangeThreads, 4LL << shift, s>>>(
      r.pairs, r.offsets, sr, r.spill, r.hdr + 1, shift);
  join_insert_kernel<<<sm_count(), kThreads, 0, s>>>(s0, lv, r.spill,
                                                     r.hdr + 1, sr, n, tcap);
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

// Exact grouped int64 sums: out[o, g] = sum over rows i with gid[i] == g of
// state o's value at i (zero where the state's mask is 0), wrapping mod
// 2^64. Rows with gid outside [0, G) are dead.
//
// Replaces: presto_tpu/ops/pallas_groupby.py grouped_sums (kernel _kernel,
// launched by _blocked_call). On the TPU the sums split into four 16-bit
// limbs so that a one-hot f32 matmul on the MXU stays exact; the H100 adds
// 64-bit integers natively, so the trick is not carried over.
//
// Bound on this card: bytes. The kernel reads gid (4 B a row), each state
// at its own width (1, 2, 4 or 8 B a row) and each mask (1 B a row) once,
// and writes 8*S*G bytes; it does n*S additions.
//
// Design. States arrive by pointer, at their own width, in a descriptor
// table passed by value as a kernel parameter (up to kMaxStates a launch):
// the caller neither stacks nor widens them.
// - Small G (G <= 16): a persistent grid of one block per SM; each block
//   owns one contiguous row range. It stages the gids of up to kChunkRows
//   rows in shared memory once, as bytes (0xFF for a dead row), for every
//   state to reuse. A work item is (kItemRows rows, state); the warps take
//   items round-robin, heaviest states first (the caller orders the table
//   by width). A lane streams its rows of the state with 16-byte vector
//   loads, kUnroll of them in flight, evict-first, and adds each value to
//   its column of the warp's histogram in shared memory, at the row's
//   group. No atomics in the row loop. At the end of an item the warp
//   reduces by shuffles and issues one global atomicAdd per (state, group).
//   The accumulators, the block size, the item size and the way the values
//   arrive were chosen by measurement (PERF.md): G int64 registers a lane
//   with a predicated add per group cost G adds a value and held 128
//   registers a thread, so blocks of 512; a per-lane histogram in shared
//   memory costs one read-add-write a value and lets a block run 1024
//   threads. Staging states through shared memory by bulk copy
//   (cp.async.bulk on an mbarrier) measured no faster than the vector
//   loads: each value is read by one lane once.
// - Larger G (<= 512): shared-memory privatization of a tile of states
//   (dynamic shared memory opted in up to 227 KB, so G = 512 fits 56 states
//   and gid is read once). Lanes of a warp that share a group id are
//   combined first (__match_any_sync, then a shuffle reduction among the
//   peers whose steps depend only on the peer mask, so they are computed
//   once a row and reused by every state); one shared atomicAdd per peer
//   group, then one global atomicAdd per non-zero (state, group).
// Integer addition mod 2^64 is order-free, so the result is bit-exact
// whatever order the atomics land in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStates = 64;
constexpr int kLargeThreads = 512;
constexpr int kSmallThreads = 1024;  // threads of a small-G block (G <= 8)
constexpr int kUnroll = 4;           // 16-byte vector loads in flight a lane
constexpr int kItemRows = 1024;      // rows of one work item
constexpr int kChunkRows = 8192;  // gids staged at once (bytes)
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in ceiling on sm_90
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunkRows % kItemRows == 0 && kItemRows % 16 == 0,
              "items start on 16-row bounds");

// threads of a small-G block: at G > 8 half, so the histograms fit
constexpr int small_threads(int gt) {
  return gt > 8 ? kSmallThreads / 2 : kSmallThreads;
}

// shared memory of a small-G block: staged gids, then the histograms
constexpr int small_smem(int gt) {
  return kChunkRows + small_threads(gt) / 32 * 2 * gt * 32 * 8;
}

// element kinds: how a state's bytes widen to int64
enum Kind { kU8 = 0, kI8 = 1, kI16 = 2, kI32 = 3, kI64 = 4 };

struct GsState {
  const void* vals;
  const unsigned char* mask;  // nullptr: every row counts
  int kind;
  int out;  // row of the output this state sums into
};

struct GsTable {
  GsState s[kMaxStates];
};

__host__ __device__ __forceinline__ int kind_bytes(int kind) {
  return kind == kI64 ? 8 : kind == kI32 ? 4 : kind == kI16 ? 2 : 1;
}

// A lane's GT int64 accumulators, GT = G rounded up to a power of two, in
// its column of the warp's two shared-memory histograms [GT][32] (one for
// even and one for odd elements of a vector, so that consecutive
// read-add-writes do not wait on each other): one read-add-write a value,
// whatever GT. A dead row (gid byte 0xFF) adds nothing.
template <int GT>
struct SmemAcc {
  static constexpr int kGroups = GT;
  long long* __restrict__ h0;  // this warp's [GT][32], at this lane
  long long* __restrict__ h1;
  __device__ __forceinline__ void init(long long* warp_hist, int lane) {
    h0 = warp_hist + lane;
    h1 = warp_hist + GT * 32 + lane;
#pragma unroll
    for (int k = 0; k < GT; ++k) h0[k * 32] = h1[k * 32] = 0;
  }
  template <int C>
  __device__ __forceinline__ void add(int g, long long x) {
    if ((unsigned)g < (unsigned)GT) (C ? h1 : h0)[g * 32] += x;
  }
  __device__ __forceinline__ long long take(int k) {
    const long long v = h0[k * 32] + h1[k * 32];
    h0[k * 32] = h1[k * 32] = 0;
    return v;
  }
};

// the register type of a BYTES-byte vector load
template <int BYTES> struct Raw;
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

// `BYTES` bytes at p (aligned to BYTES) into the low bytes of a 16-byte
// register vector: from global memory streamed past L1 (evict-first), or
// from shared memory.
template <int BYTES, bool SMEM>
__device__ __forceinline__ uint4 load_vec(const void* p) {
  using R = typename Raw<BYTES>::T;
  R v;
  if constexpr (SMEM)
    v = *reinterpret_cast<const R*>(p);
  else
    v = __ldcs(reinterpret_cast<const R*>(p));
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (BYTES == 16) {
    r = v;
  } else if constexpr (BYTES == 8) {
    r.x = v.x;
    r.y = v.y;
  } else {
    r.x = v;
  }
  return r;
}

template <int K>
__device__ __forceinline__ unsigned word(const uint4& r) {
  if constexpr (K == 0) return r.x;
  if constexpr (K == 1) return r.y;
  if constexpr (K == 2) return r.z;
  return r.w;
}

// Element E of a 16-byte vector of T, widened to int64 (sign-extended for
// signed kinds, zero-extended for unsigned char).
template <typename T, int E>
__device__ __forceinline__ long long elem(const uint4& r) {
  if constexpr (sizeof(T) == 8) {
    return (long long)(((unsigned long long)word<2 * E + 1>(r) << 32) |
                       word<2 * E>(r));
  } else if constexpr (sizeof(T) == 4) {
    return (long long)(int)word<E>(r);
  } else {
    constexpr int kPer = 4 / sizeof(T);
    const unsigned w = word<E / kPer>(r) >> (8 * sizeof(T) * (E % kPer));
    return (long long)(T)w;
  }
}

// Byte E of a register vector.
template <int E>
__device__ __forceinline__ int byte_of(const uint4& r) {
  return (word<E / 4>(r) >> (8 * (E % 4))) & 0xff;
}

// Elements E.. of one vector: values x, mask bytes m, gid bytes g.
template <typename T, int E, bool MASK, typename Acc>
__device__ __forceinline__ void add_elems(const uint4& x, const uint4& m,
                                          const uint4& g, Acc& acc) {
  if constexpr (E < 16 / (int)sizeof(T)) {
    const long long val = elem<T, E>(x);
    acc.template add<E & 1>(byte_of<E>(g),
                            (!MASK || byte_of<E>(m)) ? val : 0ll);
    add_elems<T, E + 1, MASK>(x, m, g, acc);
  }
}

// One state over the `len` rows of an item into this lane's accumulators:
// v and m point at the item's first value and mask byte, g8 at its first
// staged gid byte. Lane l takes vectors l, l + 32, ...; `aligned` (v and m
// on 16-byte bounds) allows vector loads, else, and for the ragged tail,
// the lane loads one row at a time.
template <typename Acc, typename T, bool MASK>
__device__ __forceinline__ void accumulate(const T* __restrict__ v,
                                           const unsigned char* __restrict__ m,
                                           const unsigned char* g8, int len,
                                           bool aligned, int lane, Acc& acc) {
  constexpr int VEC = 16 / sizeof(T);
  int r = 0;
  if (aligned) {
    const int nv = len / VEC;  // whole vectors in the item
    for (int v0 = 0; v0 < nv; v0 += 32 * kUnroll) {
      uint4 x[kUnroll];
      uint4 mk[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = v0 + u * 32 + lane;
        if (k < nv) {
          x[u] = load_vec<16, false>(v + k * VEC);
          if (MASK) mk[u] = load_vec<VEC, false>(m + k * VEC);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = v0 + u * 32 + lane;
        if (k < nv)
          add_elems<T, 0, MASK>(x[u], mk[u], load_vec<VEC, true>(g8 + k * VEC),
                                acc);
      }
    }
    r = nv * VEC;
  }
  for (int i = r + lane; i < len; i += 32) {  // ragged tail, or unaligned
    const long long val = (long long)v[i];
    acc.template add<0>(g8[i], (!MASK || m[i]) ? val : 0ll);
  }
}

// One item of state st: rows [row0, row0 + len), gids staged at g8.
template <typename Acc>
__device__ __forceinline__ void accumulate_item(const GsState& st,
                                                const unsigned char* g8,
                                                int row0, int len, int lane,
                                                Acc& acc) {
  const int w = kind_bytes(st.kind);
  const void* v = static_cast<const char*>(st.vals) + (long long)row0 * w;
  const unsigned char* m = st.mask ? st.mask + row0 : nullptr;
  const bool aligned = (uintptr_t)v % 16 == 0 && (uintptr_t)m % 16 == 0;
#define GS_CASE(KIND, T)                                                   \
  case KIND:                                                               \
    if (st.mask)                                                           \
      accumulate<Acc, T, true>(static_cast<const T*>(v), m, g8, len,       \
                               aligned, lane, acc);                        \
    else                                                                   \
      accumulate<Acc, T, false>(static_cast<const T*>(v), m, g8, len,      \
                                aligned, lane, acc);                       \
    break;
  switch (st.kind) {
    GS_CASE(kU8, unsigned char)
    GS_CASE(kI8, signed char)
    GS_CASE(kI16, short)
    GS_CASE(kI32, int)
    default:
    GS_CASE(kI64, long long)
  }
#undef GS_CASE
}

// Reduce a warp's accumulators and add them to out[st.out, :G].
template <typename Acc>
__device__ __forceinline__ void flush(Acc& acc, const GsState& st,
                                      unsigned long long* out, int G,
                                      int lane) {
#pragma unroll
  for (int k = 0; k < Acc::kGroups; ++k) {
    long long v = acc.take(k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == k && k < G && v != 0)
      atomicAdd(out + (long long)st.out * G + k, (unsigned long long)v);
  }
}

template <int GT>
__global__ void __launch_bounds__(small_threads(GT), 1)
    grouped_sums_small(const int* __restrict__ gid,
                       __grid_constant__ const GsTable tab, int S,
                       unsigned long long* __restrict__ out, int n, int G,
                       int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* g8 = smem;  // [kChunkRows] staged gid bytes
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  SmemAcc<GT> acc;
  acc.init(reinterpret_cast<long long*>(smem + kChunkRows) +
               warp * 2 * GT * 32, lane);
  const int r0 = blockIdx.x * rows_per_block;  // a multiple of 16
  const int r1 = min(n, r0 + rows_per_block);
  for (int c0 = r0; c0 < r1; c0 += kChunkRows) {
    const int len = min(r1, c0 + kChunkRows) - c0;
    const int items = (len + kItemRows - 1) / kItemRows * S;
    __syncthreads();  // the previous chunk's items are done with g8
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int g = gid[c0 + i];
      g8[i] = (unsigned)g < (unsigned)G ? (unsigned char)g : 0xff;
    }
    __syncthreads();
    for (int item = warp; item < items; item += nwarps) {
      const int i0 = item / S * kItemRows;
      const GsState& st = tab.s[item % S];
      accumulate_item(st, g8 + i0, c0 + i0, min(len - i0, kItemRows), lane,
                      acc);
      flush(acc, st, out, G, lane);
    }
  }
}

__device__ __forceinline__ long long load_state(const GsState& st,
                                                long long i) {
  if (st.mask && !st.mask[i]) return 0;
  switch (st.kind) {
    case kU8: return static_cast<const unsigned char*>(st.vals)[i];
    case kI8: return static_cast<const signed char*>(st.vals)[i];
    case kI16: return static_cast<const short*>(st.vals)[i];
    case kI32: return static_cast<const int*>(st.vals)[i];
    default: return static_cast<const long long*>(st.vals)[i];
  }
}

__global__ void __launch_bounds__(kLargeThreads)
    grouped_sums_large(const int* __restrict__ gid,
                       __grid_constant__ const GsTable tab, int S,
                       unsigned long long* __restrict__ out, int n, int G,
                       int tile) {
  extern __shared__ unsigned long long part[];
  const int s0 = blockIdx.y * tile;
  const int ns = min(tile, S - s0);
  for (int k = threadIdx.x; k < ns * G; k += blockDim.x) part[k] = 0ull;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // every lane of a warp runs the same number of iterations (shuffles)
  for (long long base =
           (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    const int g = i < n ? gid[i] : -1;
    const bool live = (unsigned)g < (unsigned)G;
    const unsigned peers = __match_any_sync(kFull, live ? g : -1 - lane);
    const bool leader = (peers & below) == 0;
    // reduction steps among the peers: each round a lane adds the value of
    // its next remaining peer above it; lanes at odd rank drop out
    unsigned p = peers & (0xfffffffeu << lane);
    int rank = __popc(peers & below);
    int nxt[5];
    int steps = 0;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      nxt[t] = 0;
      if (__any_sync(kFull, p != 0)) {
        nxt[t] = __ffs(p);
        p &= ~__ballot_sync(kFull, rank & 1);
        rank >>= 1;
        steps = t + 1;
      }
    }
    for (int s = 0; s < ns; ++s) {
      long long x = live ? load_state(tab.s[s0 + s], i) : 0ll;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        if (t < steps) {
          const long long y = __shfl_sync(kFull, x, (nxt[t] - 1) & 31);
          if (nxt[t]) x += y;
        }
      }
      if (live && leader && x != 0)
        atomicAdd(&part[s * G + g], (unsigned long long)x);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ns * G; k += blockDim.x) {
    const unsigned long long v = part[k];
    if (v) atomicAdd(&out[(long long)tab.s[s0 + k / G].out * G + k % G], v);
  }
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

template <int GT>
cudaError_t launch_small(const int* gid, const GsTable& tab, int S,
                         unsigned long long* out, int n, int G,
                         cudaStream_t stream) {
  constexpr int smem = small_smem(GT);
  static bool opted_in = false;
  if (smem > 48 * 1024 && !opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_sums_small<GT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  int blocks = sm_count();
  const int min_rows = 256;
  if (blocks > (n + min_rows - 1) / min_rows)
    blocks = (n + min_rows - 1) / min_rows;
  if (blocks < 1) blocks = 1;
  int rows = (n + blocks - 1) / blocks;
  rows = (rows + 15) / 16 * 16;  // items start on 16-row (16-byte) bounds
  grouped_sums_small<GT><<<blocks, small_threads(GT), smem, stream>>>(
      gid, tab, S, out, n, G, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Host-side descriptor, as the caller lays it out (24 bytes).
struct GsStateHost {
  const void* vals;
  const void* mask;
  int kind;
  int out;
};

// gid int32[n]; states: `count` descriptors in host memory (count <=
// kMaxStates), each a device pointer to n elements of its kind, an
// optional bool mask[n] and its output row; out int64[rows, G]: its first
// zero_rows rows are zeroed here first (the caller passes the output's
// row count on the first launch of a call, 0 on later ones).
// The caller's launch plan picks the path: groups_tile in {2, 4, 8, 16}
// (>= G) takes the small-G (histogram) path; groups_tile 0 takes the
// larger-G (shared privatization) path with states_tile states a tile.
int grouped_sums_launch(const void* gid, const void* states, int count,
                        void* out, int zero_rows, int n, int G,
                        int groups_tile, int states_tile, void* stream) {
  if (zero_rows > 0 && G > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)zero_rows * G * 8,
                                    static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return (int)e;
  }
  if (n <= 0 || count <= 0 || G <= 0) return 0;
  if (count > kMaxStates || G > 512) return (int)cudaErrorInvalidValue;
  GsTable tab;
  const GsStateHost* h = static_cast<const GsStateHost*>(states);
  for (int s = 0; s < count; ++s) {
    if (h[s].kind < kU8 || h[s].kind > kI64) return (int)cudaErrorInvalidValue;
    tab.s[s].vals = h[s].vals;
    tab.s[s].mask = static_cast<const unsigned char*>(h[s].mask);
    tab.s[s].kind = h[s].kind;
    tab.s[s].out = h[s].out;
  }
  const int* g = static_cast<const int*>(gid);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups_tile > 0 && groups_tile < G) return (int)cudaErrorInvalidValue;
  switch (groups_tile) {
    case 0: break;
    case 2: return (int)launch_small<2>(g, tab, count, o, n, G, st);
    case 4: return (int)launch_small<4>(g, tab, count, o, n, G, st);
    case 8: return (int)launch_small<8>(g, tab, count, o, n, G, st);
    case 16: return (int)launch_small<16>(g, tab, count, o, n, G, st);
    default: return (int)cudaErrorInvalidValue;
  }

  const int tile = states_tile;
  if (tile < 1 || tile > count || (size_t)tile * G * 8 > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_sums_large, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int ytiles = (count + tile - 1) / tile;
  const size_t smem = (size_t)tile * G * 8;
  int per_sm = (int)(kMaxSmem / smem);
  if (per_sm > 4) per_sm = 4;
  int bx = (sm_count() * per_sm + ytiles - 1) / ytiles;
  const int need = (n + kLargeThreads - 1) / kLargeThreads;
  if (bx > need) bx = need;
  if (bx < 1) bx = 1;
  grouped_sums_large<<<dim3(bx, ytiles), kLargeThreads, smem, st>>>(
      g, tab, count, o, n, G, tile);
  return (int)cudaGetLastError();
}

}  // extern "C"

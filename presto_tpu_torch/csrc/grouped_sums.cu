// Exact grouped int64 sums: out[s, g] = sum of vals[s, i] over rows i with
// gid[i] == g, wrapping mod 2^64. Rows with gid outside [0, G) are dead.
//
// Replaces: presto_tpu/ops/pallas_groupby.py grouped_sums (kernel _kernel,
// launched by _blocked_call). On the TPU the sums split into four 16-bit
// limbs so that a one-hot f32 matmul on the MXU stays exact; the H100 adds
// 64-bit integers natively, so the trick is not carried over.
//
// Bound on this card: bytes. The kernel reads n*(4 + 8*S) bytes and writes
// 8*S*G; it does n*S additions, far below any compute ceiling.
//
// Design: a grid-stride loop over rows. Each block accumulates its rows'
// partials for a tile of (state, group) pairs in shared memory with 64-bit
// atomicAdd, then flushes the non-zero partials to the global [S, G] output
// with atomicAdd. States are tiled along grid.y so a tile never needs more
// than 48 KB of shared memory (G = 512 fits 12 states; G = 128 fits 48).
// Integer addition mod 2^64 is order-free, so the result is bit-exact
// whatever order the atomics land in. The output must be zeroed by the
// caller. Contention on few groups (TPC-H Q1 has four) serializes the
// shared atomics; that is the first thing a faster version would remove.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // two waves of 132 SMs
constexpr int kTileBytes = 48 * 1024;

__global__ void grouped_sums_kernel(const int* __restrict__ gid,
                                    const long long* __restrict__ vals,
                                    unsigned long long* __restrict__ out,
                                    int n, int S, int G, int tile) {
  extern __shared__ unsigned long long part[];
  const int s0 = blockIdx.y * tile;
  const int ns = min(tile, S - s0);
  for (int k = threadIdx.x; k < ns * G; k += blockDim.x) part[k] = 0ull;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int g = gid[i];
    if ((unsigned)g >= (unsigned)G) continue;
    for (int s = 0; s < ns; ++s) {
      const unsigned long long v =
          (unsigned long long)vals[(long long)(s0 + s) * n + i];
      if (v) atomicAdd(&part[s * G + g], v);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < ns * G; k += blockDim.x) {
    const unsigned long long v = part[k];
    if (v) atomicAdd(&out[(long long)s0 * G + k], v);
  }
}

}  // namespace

// gid int32[n]; vals int64[S, n] row-major; out int64[S, G], zeroed.
extern "C" int grouped_sums_launch(const void* gid, const void* vals,
                                   void* out, int n, int S, int G,
                                   void* stream) {
  if (n <= 0 || S <= 0 || G <= 0) return 0;
  int tile = kTileBytes / (G * 8);
  if (tile < 1) return (int)cudaErrorInvalidValue;  // G > 6144
  if (tile > S) tile = S;
  const int ytiles = (S + tile - 1) / tile;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dim3 grid(blocks, ytiles);
  grouped_sums_kernel<<<grid, kThreads, (size_t)tile * G * 8,
                        (cudaStream_t)stream>>>(
      (const int*)gid, (const long long*)vals, (unsigned long long*)out, n,
      S, G, tile);
  return (int)cudaGetLastError();
}

// Embedding backward in a fixed order (K10), for Hopper (sm_90a).
//
// dW[v] = sum of the output gradients g[e] of every entry e whose index is
// v. torch's CUDA embedding backward gives no order by contract, and over
// the token types' table of two rows (every entry index 0) it did not
// repeat its bits on the card; any difference, bf16 carries on through
// training. JAX on the TPU transposes its gather into XLA's scatter-add.
// Here every index's entries are added in ascending entry order, with no
// float atomics:
//   (a) count: count[v] = entries of index v (integer atomics: exact);
//       the caller turns the counts into run starts (an integer cumsum);
//   (b) rank: each entry's rank among the earlier entries of its index; a
//       block compares one tile of 256 entries against one tile of 256
//       earlier ids from shared memory (the tiles below the diagonal, all in
//       parallel) and adds its counts to the entries' ranks (integer atomics:
//       exact); then place: sorted[start[v] + rank] = e, the entries sorted
//       by (index, position), each slot written once;
//   (c) chunks: the sorted entries in chunks of kChunk, a block a chunk and
//       a thread a few columns; the block reads every entry's index and run
//       bounds at once, then walks the entries in order, kAhead rows loaded
//       at a time, and sums each run of one index inside the chunk; a run
//       that lies inside the chunk is written to its row of dW, the piece
//       of a run that crosses the chunk's start or end to one of the
//       chunk's two partial rows;
//   (d) combine: the chunk where a crossing run begins adds its pieces in
//       chunk order and writes the row.
// The rows of absent indices stay as the caller zeroed them. Every launch
// has a fixed shape, so a CUDA graph captures the whole backward.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // sorted entries a block of (c) sums
constexpr int kAhead = 8;   // (c): rows of g a thread loads before it adds
constexpr int kMaxColsPerThread = 4;
constexpr int kMaxD = kThreads * kMaxColsPerThread;

__global__ void __launch_bounds__(kThreads)
    emb_bwd_count_kernel(const long long* __restrict__ ids, int n, int V,
                         int* __restrict__ count) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e < n) {
    const long long v = ids[e];
    if (v >= 0 && v < V) atomicAdd(count + v, 1);
  }
}

// (b) rank: block (x, y) adds, for each entry e of tile x, the entries of
// tile y <= x before e with e's index.
__global__ void __launch_bounds__(kThreads)
    emb_bwd_rank_kernel(const long long* __restrict__ ids, int n,
                        int* __restrict__ rank) {
  if (blockIdx.y > blockIdx.x) return;
  __shared__ long long tile[kThreads];
  const int t = blockIdx.y * kThreads + threadIdx.x;
  tile[threadIdx.x] = t < n ? ids[t] : -1;
  __syncthreads();
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const long long v = ids[e];
  const int below = min(kThreads, e - (int)blockIdx.y * kThreads);
  int count = 0;
#pragma unroll 8
  for (int i = 0; i < below; ++i) count += tile[i] == v;
  if (count) atomicAdd(rank + e, count);
}

// (b) place: sorted[start[v] + rank[e]] = e.
__global__ void __launch_bounds__(kThreads)
    emb_bwd_place_kernel(const long long* __restrict__ ids, int n,
                         const int* __restrict__ start,
                         const int* __restrict__ rank,
                         int* __restrict__ sorted) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e < n) sorted[start[ids[e]] + rank[e]] = e;
}

// (c): a block a chunk of kChunk sorted entries.
__global__ void __launch_bounds__(kThreads)
    emb_bwd_chunk_kernel(const long long* __restrict__ ids,
                         const int* __restrict__ sorted,
                         const int* __restrict__ start,
                         const int* __restrict__ count,
                         const float* __restrict__ g, int total, int D,
                         float* __restrict__ dW, float* __restrict__ part) {
  __shared__ int s_e[kChunk], s_v[kChunk], s_rs[kChunk], s_re[kChunk];
  const int c = blockIdx.x;
  const int cs = c * kChunk, m = min(total, cs + kChunk) - cs;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const int e = sorted[cs + j];
    const int v = (int)ids[e];
    s_e[j] = e;
    s_v[j] = v;
    s_rs[j] = start[v];
    s_re[j] = start[v] + count[v];
  }
  __syncthreads();
  float acc[kMaxColsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxColsPerThread; ++k) acc[k] = 0.f;
  for (int j0 = 0; j0 < m; j0 += kAhead) {
    float x[kAhead][kMaxColsPerThread];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const float* gr = g + (size_t)s_e[min(j0 + q, m - 1)] * D;
#pragma unroll
      for (int k = 0; k < kMaxColsPerThread; ++k) {
        const int d = threadIdx.x + k * kThreads;
        x[q][k] = j0 + q < m && d < D ? gr[d] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int j = j0 + q;
      if (j >= m) break;
#pragma unroll
      for (int k = 0; k < kMaxColsPerThread; ++k) acc[k] += x[q][k];
      if (j + 1 < m && s_v[j + 1] == s_v[j]) continue;
      // the piece ends at j: to its row, or to a partial row
      const int v = s_v[j], rs = s_rs[j], re = s_re[j];
      float* dst = rs >= cs && re <= cs + m ? dW + (size_t)v * D
                   : rs < cs                ? part + (size_t)(2 * c) * D
                                            : part + (size_t)(2 * c + 1) * D;
#pragma unroll
      for (int k = 0; k < kMaxColsPerThread; ++k) {
        const int d = threadIdx.x + k * kThreads;
        if (d < D) dst[d] = acc[k];
        acc[k] = 0.f;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    emb_bwd_combine_kernel(const long long* __restrict__ ids,
                           const int* __restrict__ sorted,
                           const int* __restrict__ start,
                           const int* __restrict__ count, int total, int D,
                           const float* __restrict__ part,
                           float* __restrict__ dW) {
  const int c = blockIdx.x;
  const int cs = c * kChunk, ce = cs + kChunk;
  if (ce >= total) return;
  const int v = (int)ids[sorted[ce - 1]];
  const int rs = start[v], re = rs + count[v];
  if (re <= ce || rs < cs) return;  // no run goes on, or another owns it
  const int last = (re - 1) / kChunk;
  for (int k = 0; k < kMaxColsPerThread; ++k) {
    const int d = threadIdx.x + k * kThreads;
    if (d >= D) break;
    float acc = part[(size_t)(2 * c + 1) * D + d];
#pragma unroll 4
    for (int c2 = c + 1; c2 <= last; ++c2)
      acc += part[(size_t)(2 * c2) * D + d];
    dW[(size_t)v * D + d] = acc;
  }
}

}  // namespace

extern "C" {

int carel_emb_max_dim() { return kMaxD; }

// Bytes of scratch K10 needs for n entries of width D: the sorted entries
// and two partial rows a chunk.
long long carel_emb_bwd_scratch(int n, int D) {
  const long long chunks = (n + kChunk - 1) / kChunk;
  return (long long)n * sizeof(int) + chunks * 2 * D * sizeof(float);
}

// K10 (a) and the ranks of (b): count [V] and rank [n] (both zeroed by the
// caller) get the entries of each index and each entry's rank among the
// earlier entries of its index. Every id must lie in [0, V).
int carel_emb_count(const long long* ids, int n, int V, int* count,
                    int* rank, void* stream) {
  if (n < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  emb_bwd_count_kernel<<<blocks, kThreads, 0, s>>>(ids, n, V, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  emb_bwd_rank_kernel<<<dim3(blocks, blocks), kThreads, 0, s>>>(ids, n,
                                                                 rank);
  return (int)cudaGetLastError();
}

// K10, the rest of (b), (c) and (d): dW [V, D] (zeroed by the caller) gets,
// for each index v, the sum of g [n, D] over its entries in ascending entry
// order; start [V] the exclusive prefix sums of the counts, rank [n] the
// ranks, both from carel_emb_count. scratch: carel_emb_bwd_scratch(n, D)
// bytes.
int carel_emb_bwd(const long long* ids, const float* g, int n, int D, int V,
                  const int* count, const int* start, const int* rank,
                  void* scratch, float* dW, void* stream) {
  if (n < 1 || V < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  int* sorted = (int*)scratch;
  float* part = (float*)((char*)scratch + (size_t)n * sizeof(int));
  const int blocks = (n + kThreads - 1) / kThreads;
  const int chunks = (n + kChunk - 1) / kChunk;
  cudaStream_t s = (cudaStream_t)stream;
  emb_bwd_place_kernel<<<blocks, kThreads, 0, s>>>(ids, n, start, rank,
                                                   sorted);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  emb_bwd_chunk_kernel<<<chunks, kThreads, 0, s>>>(ids, sorted, start,
                                                   count, g, n, D, dW, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  emb_bwd_combine_kernel<<<chunks, kThreads, 0, s>>>(ids, sorted, start,
                                                     count, n, D, part, dW);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Embedding backward in a fixed order (K10), for Hopper (sm_90a): the
// encoder's word, position and token-type tables in one call a step.
//
// dW_t[v] = sum of the output gradients g[e] of every entry e whose index in
// table t is v. The encoder adds its three lookups into one output, so every
// table takes the same g [n, D]. torch's CUDA embedding backward gives no
// order by contract, and over the token types' table of two rows (every
// entry index 0) it did not repeat its bits on the card; any difference,
// bf16 carries on through training. JAX on the TPU transposes its gather
// into XLA's scatter-add; no Pallas kernel is replaced.
//
// What bounds it on this card: bytes. Every row of every dW written once
// (an absent index's row is 0), g and the ids read once: at 64 x 96 ids
// over the zh tables (21,128 + 512 + 2 rows of 768) 85.5 MB, 25.5 us at
// 3.35 TB/s, of which the word table's zero rows are most.
//
// Every index's entries are added in ascending entry order, with no float
// atomics, in one grouping: each table's entries sorted by (index, entry)
// and cut into chunks of kChunk; a run of one index inside a chunk is summed
// there in order; a run across chunks is summed as its pieces, each in
// order, then the pieces added in chunk order. Three launches for all the
// tables:
//   (1) sort and zeros. Block t < T sorts table t's entries by index, a
//       stable LSD radix sort of 8-bit digits in shared memory: each warp
//       owns a contiguous segment of the entries; a (digit, warp) count
//       table (integer shared-memory adds) and its exclusive scan give the
//       places; the warp walks its segment 32 at a time, and one ballot a
//       digit bit gives each entry its rank among the equal digits of its
//       round, so no atomic decides a place and the sort is linear in the
//       entries. A key packs index << ebits | entry into 32 bits (where
//       they do not fit, the key is the entry and the index is read from
//       the ids). The other blocks, one an SM, each own a contiguous range
//       of the rows of all tables: they mark the indices present in their
//       range from the ids (a bit each, an integer OR) and write 0 to the
//       rows of the absent ones. So the zeros, most of the bytes, are
//       written while T SMs sort.
//   (2) chunks: a block a chunk of kChunk sorted entries of a table (and a
//       strip of at most kSumThreads units of the columns, a unit a float4
//       where D is a multiple of 4 and g lies on 16 bytes, else a float),
//       the tables' chunks in one grid; a thread a unit, 16 rows of g loaded
//       before it adds them in order. A run that lies inside the chunk is
//       written to its row of dW; the piece of a run that crosses the
//       chunk's start or end to one of the chunk's two partial rows.
//   (3) combine: the sort lists each table's runs across chunks; the
//       blocks walk (run, strip), a thread a unit, copy kPieces of the
//       run's pieces into shared memory at once and add them in chunk
//       order into its row.
// Every launch has a fixed shape for fixed n, D, tables and card, so a CUDA
// graph captures the whole backward; carel_emb_bwd_scratch sizes its
// scratch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTables = 3;
constexpr int kChunk = 64;  // sorted entries a block of (2) sums
constexpr int kSumThreads = 256;  // (2): units of a row a block adds, at most
constexpr int kStrip = 32;    // (3): units of a row a block, a warp, adds
constexpr int kPieces = 64;   // (3): pieces copied into shared memory at once
constexpr int kAhead = 8;     // (3): pieces read from shared memory at once
constexpr int kSortThreads = 1024;
constexpr int kIdsAhead = 8;  // (1): ids a thread loads before it uses them
constexpr int kWarps = kSortThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kBins = 1 << kDigitBits;
constexpr int kHistStride = kWarps + 1;  // (digit, warp) counts, padded
constexpr int kHistInts = kBins * kHistStride;
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const long long* ids[kMaxTables];
  float* dW[kMaxTables];
  int V[kMaxTables];
  long long row0[kMaxTables + 1];  // a table's first row among all tables'
  int T, n, D, chunks;
  int ebits;         // keys: index << ebits | entry; -1: the entry alone
  int keys_in_smem;  // else in `keys`
  long long rows_a_block;  // rows each zeroing block of (1) owns
  const float* g;
  int* sorted_e;  // [T, n] entries sorted by (index, entry)
  int* sorted_v;  // [T, n] their indices
  unsigned* keys;  // [T, 2, n]
  float* part;     // [T, chunks, 2, D] partial rows
  int* runs;       // [T, chunks, 3] crossing runs: first and last chunk, index
  int* run_count;  // [T]
};

// the bits an unsigned value needs
__host__ __device__ inline int bits_of(unsigned x) {
  int b = 0;
  for (; x; x >>= 1) ++b;
  return b;
}

__device__ __forceinline__ unsigned index_of(const Args& a,
                                             const long long* ids,
                                             unsigned key) {
  return a.ebits >= 0 ? key >> a.ebits : (unsigned)ids[key];
}

// In place: the (digit, warp) counts of (1), in digit-major order, become
// their exclusive prefix sums. A thread takes 8 consecutive counts.
__device__ void exclusive_scan(int* hist, int* warp_sums) {
  static_assert(kBins * kWarps == 8 * kSortThreads, "8 counts a thread");
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int* h = hist + (tid >> 2) * kHistStride + (tid & 3) * 8;
  int v[8], sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = h[k];
    sum += v[k];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int own = warp_sums[lane];
    int s = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kAll, s, o);
      if (lane >= o) s += x;
    }
    __syncwarp();
    warp_sums[lane] = s - own;
  }
  __syncthreads();
  int run = warp_sums[w] + incl - sum;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    h[k] = run;
    run += v[k];
  }
  __syncthreads();
}

// f(i, ids[i]) for i = first, first + stride, ... below n, kIdsAhead
// loads in flight at a time.
template <typename F>
__device__ __forceinline__ void for_ids(const long long* ids, int first,
                                        int n, int stride, F f) {
  for (int i0 = first; i0 < n; i0 += kIdsAhead * stride) {
    long long v[kIdsAhead];
#pragma unroll
    for (int k = 0; k < kIdsAhead; ++k) {
      const int i = i0 + k * stride;
      v[k] = i < n ? __ldg(ids + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < kIdsAhead; ++k)
      if (i0 + k * stride < n) f(i0 + k * stride, v[k]);
  }
}

// (1), block t: table t's entries sorted by index, ties in entry order.
__device__ void sort_table(const Args& a, int t, unsigned* smem_keys,
                           int* hist, int* warp_sums, int* listed) {
  const int n = a.n, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long* ids = a.ids[t];
  unsigned* in = a.keys_in_smem ? smem_keys : a.keys + (size_t)t * 2 * n;
  unsigned* out = in + n;
  for_ids(ids, tid, n, kSortThreads, [&](int i, long long v) {
    in[i] = a.ebits >= 0 ? ((unsigned)v << a.ebits) | (unsigned)i
                         : (unsigned)i;
  });
  __syncthreads();
  const int seg = (n + kWarps - 1) / kWarps;
  const int lo = min(n, w * seg), hi = min(n, lo + seg);
  const unsigned below = (1u << lane) - 1;
  const int bits = bits_of((unsigned)(a.V[t] - 1));
  for (int shift = 0; shift < bits; shift += kDigitBits) {
    const int dbits = min(kDigitBits, bits - shift);
    const unsigned mask = (1u << dbits) - 1;
    for (int k = tid; k < kHistInts; k += kSortThreads) hist[k] = 0;
    __syncthreads();
    // count each digit in the warp's segment (integer adds: exact)
    for (int i = lo + lane; i < hi; i += 32)
      atomicAdd(hist + ((index_of(a, ids, in[i]) >> shift) & mask) *
                           kHistStride + w, 1);
    __syncthreads();
    exclusive_scan(hist, warp_sums);
    // each key to its digit's next places, in segment order: the lanes of
    // a round with its digit, from one ballot a bit
    for (int base = lo; base < hi; base += 32) {
      const int i = base + lane;
      const bool valid = i < hi;
      const unsigned key = valid ? in[i] : 0u;
      const unsigned d = (index_of(a, ids, key) >> shift) & mask;
      unsigned peers = __ballot_sync(kAll, valid);
      for (int b = 0; b < dbits; ++b) {
        const unsigned set = __ballot_sync(kAll, (d >> b) & 1u);
        peers &= (d >> b) & 1u ? set : ~set;
      }
      int at = 0;
      if (valid) {
        at = hist[d * kHistStride + w];
        out[at + __popc(peers & below)] = key;
      }
      __syncwarp();
      if (valid && (peers & below) == 0)  // the first lane of its digit
        hist[d * kHistStride + w] = at + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    unsigned* tmp = in;
    in = out;
    out = tmp;
  }
  int* se = a.sorted_e + (size_t)t * n;
  int* sv = a.sorted_v + (size_t)t * n;
  const unsigned emask = a.ebits >= 0 ? (1u << a.ebits) - 1 : kAll;
  for (int i = tid; i < n; i += kSortThreads) {
    const unsigned key = in[i];
    se[i] = (int)(key & emask);
    sv[i] = (int)index_of(a, ids, key);
  }
  // the runs across a chunk's end, each listed by the chunk where it begins
  // (the list's order does not touch the sums)
  if (tid == 0) *listed = 0;
  __syncthreads();
  int* runs = a.runs + (size_t)t * a.chunks * 3;
  for (int c = tid; c + 1 < a.chunks; c += kSortThreads) {
    const int cs = c * kChunk, ce = cs + kChunk;
    const unsigned v = index_of(a, ids, in[ce - 1]);
    if (index_of(a, ids, in[ce]) != v ||
        (cs > 0 && index_of(a, ids, in[cs - 1]) == v))
      continue;
    int lo = ce, hi = n;  // the run's last entry: lo, with in[hi] past it
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (index_of(a, ids, in[mid]) == v)
        lo = mid;
      else
        hi = mid;
    }
    const int k = atomicAdd(listed, 1);
    runs[3 * k] = c;
    runs[3 * k + 1] = lo / kChunk;
    runs[3 * k + 2] = (int)v;
  }
  __syncthreads();
  if (tid == 0) a.run_count[t] = *listed;
}

// (1), zeroing block z: the rows of absent indices in its range of rows.
__device__ void zero_rows(const Args& a, int z, unsigned* present) {
  const long long first = (long long)z * a.rows_a_block;
  const long long last = min(a.row0[a.T], first + a.rows_a_block);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int t = 0; t < a.T; ++t) {
    const long long lo = max(first, a.row0[t]) - a.row0[t];
    const long long hi = min(last, a.row0[t + 1]) - a.row0[t];
    if (lo >= hi) continue;
    const int rows = (int)(hi - lo);
    for (int k = tid; k < (rows + 31) / 32; k += kSortThreads) present[k] = 0;
    __syncthreads();
    for_ids(a.ids[t], tid, a.n, kSortThreads, [&](int, long long v) {
      const long long r = v - lo;
      if (r >= 0 && r < rows) atomicOr(present + (r >> 5), 1u << (r & 31));
    });
    __syncthreads();
    float* dW = a.dW[t] + (size_t)lo * a.D;
    for (int r = w; r < rows; r += kWarps) {
      if ((present[r >> 5] >> (r & 31)) & 1u) continue;
      float* row = dW + (size_t)r * a.D;
      if ((a.D & 3) == 0) {
        float4* row4 = reinterpret_cast<float4*>(row);
        for (int c = lane; c < a.D / 4; c += 32)
          __stcs(row4 + c, make_float4(0.f, 0.f, 0.f, 0.f));
      } else {
        for (int c = lane; c < a.D; c += 32) __stcs(row + c, 0.f);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSortThreads)
    emb_bwd_sort_kernel(const Args a) {
  extern __shared__ unsigned smem_keys[];
  __shared__ int hist[kHistInts];
  __shared__ int warp_sums[kWarps];
  __shared__ int listed;
  if ((int)blockIdx.x < a.T)
    sort_table(a, blockIdx.x, smem_keys, hist, warp_sums, &listed);
  else
    zero_rows(a, blockIdx.x - a.T, reinterpret_cast<unsigned*>(hist));
}

// (3) copies a batch of pieces into shared memory at once (cp.async of a
// unit: 16 bytes or 4), so that it waits for memory once a batch.
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async(float4* dst, const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void add_to(float& acc, float x) { acc += x; }

__device__ __forceinline__ void add_to(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// (2): block b adds strip b % strips (a unit a thread) of chunk c of table
// t, (c, t) = (b / strips) / T, % T: it walks the chunk's rows of g in
// order, kRows of them loaded before they are added.
template <typename U, int kRows>
__global__ void __launch_bounds__(kSumThreads)
    emb_bwd_chunk_kernel(const Args a) {
  __shared__ int s_e[kChunk], s_v[kChunk];
  const int units = a.D / (int)(sizeof(U) / sizeof(float));
  const int strips = (units + blockDim.x - 1) / blockDim.x;
  const int tc = blockIdx.x / strips, t = tc % a.T, c = tc / a.T;
  const int u = (blockIdx.x % strips) * blockDim.x + threadIdx.x;
  const int n = a.n;
  const int* se = a.sorted_e + (size_t)t * n;
  const int* sv = a.sorted_v + (size_t)t * n;
  const int cs = c * kChunk, m = min(n, cs + kChunk) - cs;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    s_e[j] = se[cs + j];
    s_v[j] = sv[cs + j];
  }
  __syncthreads();
  if (u >= units) return;
  // the first entry's run began in an earlier chunk; the last one's goes on
  const bool from_before = cs > 0 && sv[cs - 1] == s_v[0];
  const bool goes_on = cs + m < n && sv[cs + m] == s_v[m - 1];
  const U* g = reinterpret_cast<const U*>(a.g) + u;
  U* part = reinterpret_cast<U*>(a.part) +
            ((size_t)t * a.chunks + c) * 2 * units + u;
  U* dW = reinterpret_cast<U*>(a.dW[t]) + u;
  const U none = {};
  U acc = none;
  int piece = 0;  // where the current piece began
  for (int j0 = 0; j0 < m; j0 += kRows) {
    U x[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q)  // past m: the last row, not added
      x[q] = g[(size_t)s_e[min(j0 + q, m - 1)] * units];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int j = j0 + q;
      if (j >= m) break;
      add_to(acc, x[q]);
      if (j + 1 < m && s_v[j + 1] == s_v[j]) continue;
      // the piece ends at j: to its row, or to a partial row
      U* dst = piece == 0 && from_before ? part
               : j == m - 1 && goes_on   ? part + units
                                         : dW + (size_t)s_v[j] * units;
      *dst = acc;
      piece = j + 1;
      acc = none;
    }
  }
}

// (3): the blocks walk the items (crossing run, strip) of all tables, the
// last table's first (the token types' runs are the longest); a thread adds
// its unit's pieces in chunk order, kPieces copied into shared memory at
// once, and writes the row.
template <typename U>
__global__ void __launch_bounds__(kStrip)
    emb_bwd_combine_kernel(const Args a) {
  __shared__ U pieces[kPieces][kStrip];
  const int units = a.D / (int)(sizeof(U) / sizeof(float));
  const int strips = (units + kStrip - 1) / kStrip;
  int runs[kMaxTables], items = 0;
  for (int t = 0; t < a.T; ++t) {
    runs[t] = a.run_count[t];
    items += runs[t] * strips;
  }
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int t = a.T - 1, r = item;
    while (r >= runs[t] * strips) r -= runs[t--] * strips;
    const int* run = a.runs + ((size_t)t * a.chunks + r / strips) * 3;
    const int c = run[0], last = run[1], v = run[2];
    const int u = (r % strips) * kStrip + threadIdx.x;
    if (u >= units) continue;
    const U* part = reinterpret_cast<const U*>(a.part) +
                    (size_t)t * a.chunks * 2 * units + u;
    U acc = part[(size_t)(2 * c + 1) * units];
    for (int c0 = c + 1; c0 <= last; c0 += kPieces) {
      const int m = min(kPieces, last + 1 - c0);
      for (int k = 0; k < m; ++k)
        cp_async(&pieces[k][threadIdx.x],
                 part + (size_t)(2 * (c0 + k)) * units);
      cp_async_wait_all();
      for (int k0 = 0; k0 < m; k0 += kAhead) {
        U x[kAhead];
#pragma unroll
        for (int q = 0; q < kAhead; ++q)
          x[q] = pieces[min(k0 + q, m - 1)][threadIdx.x];
#pragma unroll
        for (int q = 0; q < kAhead; ++q)
          if (k0 + q < m) add_to(acc, x[q]);
      }
    }
    reinterpret_cast<U*>(a.dW[t])[(size_t)v * units + u] = acc;
  }
}

// scratch: the partial rows, the sorted entries and indices, the keys, the
// crossing runs and their counts
struct Layout {
  size_t sorted_e, sorted_v, keys, runs, run_count, total;
};

Layout layout(int n, int D, int T) {
  const size_t chunks = (n + kChunk - 1) / kChunk;
  const size_t part = (size_t)T * chunks * 2 * D * sizeof(float);
  const size_t ints = (size_t)T * n * sizeof(int);
  const size_t runs = part + 4 * ints;
  const size_t count = runs + (size_t)T * chunks * 3 * sizeof(int);
  return {part, part + ints, part + 2 * ints, runs, count,
          count + T * sizeof(int)};
}

}  // namespace

extern "C" {

int carel_emb_max_tables() { return kMaxTables; }

// Bytes of scratch K10 needs for T tables of n entries of width D.
long long carel_emb_bwd_scratch(int n, int D, int T) {
  if (n < 1 || D < 1 || T < 1 || T > kMaxTables) return -1;
  return (long long)layout(n, D, T).total;
}

// K10: for each table t < T, dW_t [V_t, D] gets, for each index v, the sum
// of g [n, D] over the entries whose id in ids_t [n] is v, in ascending
// entry order (0 where there is none). Every id must lie in [0, V_t); the
// pointers of tables past T are not read. scratch:
// carel_emb_bwd_scratch(n, D, T) bytes.
int carel_emb_bwd(const long long* ids0, const long long* ids1,
                  const long long* ids2, int V0, int V1, int V2, int T,
                  const float* g, int n, int D, void* scratch, float* dW0,
                  float* dW1, float* dW2, void* stream) {
  if (n < 1 || D < 1 || T < 1 || T > kMaxTables)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  const long long* ids[kMaxTables] = {ids0, ids1, ids2};
  float* dW[kMaxTables] = {dW0, dW1, dW2};
  const int V[kMaxTables] = {V0, V1, V2};
  int index_bits = 0;
  for (int t = 0; t < T; ++t) {
    if (V[t] < 1 || ids[t] == nullptr || dW[t] == nullptr)
      return (int)cudaErrorInvalidValue;
    a.ids[t] = ids[t];
    a.dW[t] = dW[t];
    a.V[t] = V[t];
    a.row0[t + 1] = a.row0[t] + V[t];
    const int b = bits_of((unsigned)(V[t] - 1));
    if (b > index_bits) index_bits = b;
  }
  a.T = T;
  a.n = n;
  a.D = D;
  a.chunks = (n + kChunk - 1) / kChunk;
  const int ebits = bits_of((unsigned)(n - 1));
  a.ebits = ebits + index_bits <= 32 ? ebits : -1;
  a.g = g;
  const Layout l = layout(n, D, T);
  a.part = (float*)scratch;
  a.sorted_e = (int*)((char*)scratch + l.sorted_e);
  a.sorted_v = (int*)((char*)scratch + l.sorted_v);
  a.keys = (unsigned*)((char*)scratch + l.keys);
  a.runs = (int*)((char*)scratch + l.runs);
  a.run_count = (int*)((char*)scratch + l.run_count);

  int dev = 0, sms = 0, smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t key_bytes = (size_t)2 * n * sizeof(unsigned);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, (const void*)emb_bwd_sort_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t static_bytes = attr.sharedSizeBytes;
  a.keys_in_smem = static_bytes + key_bytes <= (size_t)smem;
  const size_t dyn = a.keys_in_smem ? key_bytes : 0;
  const int zero_blocks = sms > T ? sms - T : 1;
  a.rows_a_block = (a.row0[T] + zero_blocks - 1) / zero_blocks;
  if (a.rows_a_block > (long long)kHistInts * 32)  // the presence bits
    return (int)cudaErrorInvalidValue;
  // always the same most, whatever n a call has
  err = cudaFuncSetAttribute((const void*)emb_bwd_sort_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem - (int)static_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  emb_bwd_sort_kernel<<<T + zero_blocks, kSortThreads, dyn, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // rows of g, dW and the pieces in float4s where D and g allow
  const bool vec = D % 4 == 0 && (size_t)g % 16 == 0;
  const int units = vec ? D / 4 : D;
  const int threads = units < kSumThreads ? (units + 31) / 32 * 32
                                          : kSumThreads;
  const int sums = T * a.chunks * ((units + threads - 1) / threads);
  const int walkers = 6 * sms;
  if (vec)
    emb_bwd_chunk_kernel<float4, 16><<<sums, threads, 0, s>>>(a);
  else
    emb_bwd_chunk_kernel<float, 16><<<sums, threads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (vec)
    emb_bwd_combine_kernel<float4><<<walkers, kStrip, 0, s>>>(a);
  else
    emb_bwd_combine_kernel<float><<<walkers, kStrip, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Fused BoW decoder loss: decoder product z = h W^T + b, softmax and
// label-smoothed BCE against the sparse bag of words, without storing the
// [B, V] logits. Forward (K3) and analytic backward (K4), for Hopper (sm_90a).
//
// Replaces carel_tpu/ops/pallas_bow.py: _sweep1_kernel and _sweep2_kernel
// (forward, via _run_sweeps) and _bwd_kernel (backward, via _fused_bwd).
//
// Per row the loss needs four dense sums over the vocabulary V (see
// carel_tpu_torch/ops/cuda_bow.py): lse and S_z = sum z (sweep 1), then
// S_log1mp = sum log(1-p) and Qp = sum p/(1-p) with p = exp(z - lse)
// (sweep 2). The TPU kernel sums Q = sum 1/(1-p) = V + Qp instead; at
// V ~ 24k an fp32 Q keeps only ~2e-3 of its O(1) part, and the backward's
// A = V - (1-c) Q + ... cancels down to that part, so the port carries Qp.
// The sparse part (z at the <= T bag-of-words indices) and the scatter
// corrections of the backward stay in plain torch.
//
// What bounds it on this card: operations. At the training shape (B = 64,
// D = 48, V = 23,808) one evaluation of z is 2*B*D*V ~ 146 MFLOP of fp32
// on CUDA cores (TF32 is off for this arithmetic), against ~4.6 MB of W,
// which the memory moves in ~1.4 us. The TPU walked the V tiles in order
// with a running max; here the V chunks spread over the SMs instead:
//   K3  one cooperative launch of one block an SM. V is cut into chunks of
//       ceil(V / SMs) columns (181 at the training shape on 132 SMs; 64 at
//       least, 256 at most); a block loads its chunk of W and b once and
//       evaluates its [B, cols] piece of z once, as 4 x 4 register tiles
//       (8 16-byte shared-memory reads for 64 FMAs), into shared memory,
//       where the piece stays between the sweeps. Sweep 1 writes the
//       chunk's (max, sumexp, sum z) per row; a grid-wide barrier; every
//       block merges all chunks' partials of a row in the same fixed order,
//       in double, and so holds lse; sweep 2 runs over the kept z and writes
//       (sum log1p(-p), sum p/(1-p)); a second barrier; the blocks merge
//       those, each for its share of the rows. A piece that does not fit in
//       shared memory (a large B), or a V of more chunks than SMs (a block
//       then owns several), is evaluated again in sweep 2, inside the same
//       launch.
//   K4  each block owns kBwdChunks chunks of kBwdCols columns, rebuilds z and
//       G = dL/dz for them, writes dW and db of its own columns exactly, and
//       accumulates a partial dh [B, D] of its own; a last pass adds the
//       partial dh of all blocks in a fixed order.
// No float atomics anywhere, so every output repeats bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // K4
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // batch rows per pass over a chunk
constexpr int kFwdThreads = 512;  // K3
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdMinCols = 64;   // V columns per K3 chunk, at least
constexpr int kFwdMaxCols = 256;  // and at most
constexpr int kColGroup = 64;  // columns one pass of K3's register tiles covers
constexpr int kSmemPad = 4;    // floats of row padding in K3's shared memory
constexpr int kBwdCols = 64;   // V columns per K4 chunk
constexpr int kBwdChunks = 2;  // K4 chunks per block
constexpr int kMaxD = 64;
constexpr float kNeg = -1e30f;
constexpr float kPMax = 1.f - 1e-7f;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows v0 .. v0+cols of W [V, D] into Ws[k * (cols+1) + c]; zero past V.
__device__ void load_w_chunk(const float* __restrict__ W,
                             const float* __restrict__ b, int D, int V, int v0,
                             int cols, float* Ws, float* bs) {
  const int ld = cols + 1;
  for (int e = threadIdx.x; e < cols * D; e += blockDim.x) {
    const int c = e / D;
    const int k = e - c * D;
    Ws[k * ld + c] = (v0 + c < V) ? W[(size_t)v0 * D + e] : 0.f;
  }
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    bs[c] = (v0 + c < V) ? b[v0 + c] : 0.f;
}

// z for row r of hs at the columns lane + 32 q of the chunk.
template <int Q>
__device__ __forceinline__ void row_logits(const float* hs, const float* Ws,
                                           const float* bs, int D, int ld,
                                           int r, int lane, float (&z)[Q]) {
#pragma unroll
  for (int q = 0; q < Q; ++q) z[q] = 0.f;
  for (int k = 0; k < D; ++k) {
    const float hk = hs[r * D + k];
#pragma unroll
    for (int q = 0; q < Q; ++q) z[q] = fmaf(hk, Ws[k * ld + lane + 32 * q], z[q]);
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) z[q] += bs[lane + 32 * q];
}

// Sum or max over the kPerRow neighbouring lanes that share a row in K3.
constexpr int kPerRow = kFwdThreads / kRows;
static_assert(kPerRow * kRows == kFwdThreads && kPerRow <= 32 &&
                  (kPerRow & (kPerRow - 1)) == 0,
              "a power of two of lanes per row");

template <typename T>
__device__ __forceinline__ T row_sum(T v) {
  for (int o = kPerRow / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
  for (int o = kPerRow / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ constexpr int round_up(int x, int to) {
  return (x + to - 1) / to * to;
}

// How K3 cuts the work: chunks of `cols` columns of V, `grid` blocks that
// own the chunks blockIdx.x, blockIdx.x + grid, ...; keep: the block's one
// piece of z stays in shared memory between the sweeps.
struct FwdPlan {
  int cols, chunks, grid, keep;
};

// Shared memory of K3 in floats: W's chunk [cols_pad][ld], kRows rows of h
// [kRows][ld], b's chunk, the rows' lse, and z [B or kRows][ldz].
__host__ __device__ constexpr size_t fwd_smem_floats(int B, int D, int cols,
                                                     int keep) {
  const int ld = round_up(D, 4) + kSmemPad;
  const int cols_pad = round_up(cols, kColGroup);
  return (size_t)cols_pad * ld + (size_t)kRows * ld + cols_pad + kRows +
         (size_t)(keep ? B : kRows) * (cols_pad + kSmemPad);
}

// 16 bytes from device to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows 0 .. total of a row-major [valid, D] block at src into dst[row][ld]
// (ld >= d4 = D rounded up to 4); zeros past `valid` rows and past D. With
// `vec` (D a multiple of 4 and src on 16 bytes) as asynchronous 16-byte
// copies, which cp_async_wait_all and a barrier complete.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int D, int d4, int valid, int total,
                                          bool vec) {
  if (vec) {
    const int c4 = d4 / 4;
    for (int e = threadIdx.x; e < total * c4; e += kFwdThreads) {
      const int r = e / c4, k = (e - r * c4) * 4;
      cp_async16(dst + r * ld + k, src + (size_t)(r < valid ? r : 0) * D + k,
                 r < valid);
    }
  } else {
    for (int e = threadIdx.x; e < total * d4; e += kFwdThreads) {
      const int r = e / d4, k = e - r * d4;
      dst[r * ld + k] = (r < valid && k < D) ? src[(size_t)r * D + k] : 0.f;
    }
  }
}

// z of rows r0 .. r0 + rows at the chunk's columns into zbuf[row][ldz]: a
// thread holds 4 rows x 4 columns (tx + 16 j of a group of kColGroup) and
// walks k in fours, h and W both as [row][ld] tiles, k ascending.
__device__ __forceinline__ void chunk_logits(const float* hs, const float* Ws,
                                             const float* bs, int d4, int ld,
                                             int cols_pad, int rows,
                                             float* zbuf, int ldz) {
  const int tx = threadIdx.x & 15, ty = (threadIdx.x >> 4) & 15;
  for (int c0 = (threadIdx.x >> 8) * kColGroup; c0 < cols_pad;
       c0 += (kFwdThreads >> 8) * kColGroup) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < d4; k += 4) {
      float4 a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(hs + (ty * 4 + i) * ld + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const float4*>(Ws + (c0 + tx + 16 * j) * ld +
                                                k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float z = acc[i][j];
          z = fmaf(a[i].x, w[j].x, z);
          z = fmaf(a[i].y, w[j].y, z);
          z = fmaf(a[i].z, w[j].z, z);
          z = fmaf(a[i].w, w[j].w, z);
          acc[i][j] = z;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 16 * j;
          zbuf[(size_t)r * ldz + c] = acc[i][j] + bs[c];
        }
      }
    }
  }
}

// The arguments of K3 that both sweeps read.
struct FwdArgs {
  const float* h;
  const float* W;
  const float* b;
  int B, D, V, cols, chunks, keep;
  float* part1;  // [B][chunks][3]: max, sumexp, sum z of a row over a chunk
  float* part2;  // [B][chunks][2]: sum log1p(-p), sum p/(1-p)
  float* out;    // [4][B]: lse, S_z, S_log1mp, Qp
};

// One sweep of the block's chunks. PASS 1 evaluates z and writes part1.
// PASS 2 merges part1 into the rows' lse (every block, in the same order; the
// row's owner block also writes lse and S_z to out), takes z from shared
// memory where it was kept and evaluates it again where not, and writes part2.
template <int PASS>
__device__ __forceinline__ void fwd_sweep(const FwdArgs& a, float* smem) {
  const int d4 = round_up(a.D, 4), ld = d4 + kSmemPad;
  const int cols_pad = round_up(a.cols, kColGroup), ldz = cols_pad + kSmemPad;
  float* Ws = smem;                  // [cols_pad][ld]
  float* hs = Ws + cols_pad * ld;    // [kRows][ld]
  float* bs = hs + kRows * ld;       // [cols_pad]
  float* lses = bs + cols_pad;       // [kRows]
  float* zs = lses + kRows;          // [keep ? B : kRows][ldz]
  const bool evaluate = PASS == 1 || !a.keep;
  const bool vec = a.D % 4 == 0 && ((size_t)a.W | (size_t)a.h) % 16 == 0;
  // the sums over a row are shared by kPerRow neighbouring lanes, all rows at
  // once: lane j takes the entries j, j + kPerRow, ..., then the row's lanes
  // add up in a fixed tree
  const int r = threadIdx.x / kPerRow, j = threadIdx.x % kPerRow;

  for (int chunk = blockIdx.x; chunk < a.chunks; chunk += gridDim.x) {
    const int v0 = chunk * a.cols;
    const int ncols = min(a.cols, a.V - v0);
    if (evaluate) {
      __syncthreads();  // the chunk before is done with
      // W's rows v0 .. as they lie, zeros past the chunk
      load_rows(Ws, ld, a.W + (size_t)v0 * a.D, a.D, d4, ncols, cols_pad, vec);
      for (int c = threadIdx.x; c < cols_pad; c += kFwdThreads)
        bs[c] = c < ncols ? a.b[v0 + c] : 0.f;
    }
    for (int r0 = 0; r0 < a.B; r0 += kRows) {
      const int rows = min(kRows, a.B - r0);
      float* zbuf = a.keep ? zs + (size_t)r0 * ldz : zs;
      __syncthreads();  // the rows before are done with hs, lses and zs
      if (evaluate)
        load_rows(hs, ld, a.h + (size_t)r0 * a.D, a.D, d4, rows, kRows, vec);
      const bool in = r < rows;
      if (PASS == 2) {
        const float* p = a.part1 + (size_t)(r0 + (in ? r : 0)) * a.chunks * 3;
        float m = kNeg;
        if (in)
          for (int c = j; c < a.chunks; c += kPerRow) m = fmaxf(m, p[c * 3]);
        m = row_max(m);
        double l = 0.0, sz = 0.0;
        if (in)
          for (int c = j; c < a.chunks; c += kPerRow) {
            l += (double)p[c * 3 + 1] * exp((double)p[c * 3] - (double)m);
            sz += p[c * 3 + 2];
          }
        l = row_sum(l);
        sz = row_sum(sz);
        if (in && j == 0) {
          const float lse = m + (float)log(l);
          lses[r] = lse;
          if (chunk == blockIdx.x && (r0 + r) % gridDim.x == blockIdx.x) {
            a.out[r0 + r] = lse;
            a.out[a.B + r0 + r] = (float)sz;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (evaluate) {
        chunk_logits(hs, Ws, bs, d4, ld, cols_pad, rows, zbuf, ldz);
        __syncthreads();
      }
      const float* z = zbuf + (size_t)(in ? r : 0) * ldz;
      if (PASS == 1) {
        float m = kNeg;
        if (in)
          for (int c = j; c < ncols; c += kPerRow) m = fmaxf(m, z[c]);
        m = row_max(m);
        float se = 0.f, sz = 0.f;
        if (in)
          for (int c = j; c < ncols; c += kPerRow) {
            se += expf(z[c] - m);
            sz += z[c];
          }
        se = row_sum(se);
        sz = row_sum(sz);
        if (in && j == 0) {
          float* p = a.part1 + ((size_t)(r0 + r) * a.chunks + chunk) * 3;
          p[0] = m;
          p[1] = se;
          p[2] = sz;
        }
      } else {
        const float lse = lses[in ? r : 0];
        float s1 = 0.f, s2 = 0.f;
        if (in)
          for (int c = j; c < ncols; c += kPerRow) {
            const float p = fminf(expf(z[c] - lse), kPMax);
            s1 += log1pf(-p);
            s2 += p / (1.f - p);
          }
        s1 = row_sum(s1);
        s2 = row_sum(s2);
        if (in && j == 0) {
          float* p = a.part2 + ((size_t)(r0 + r) * a.chunks + chunk) * 2;
          p[0] = s1;
          p[1] = s2;
        }
      }
    }
  }
}

// K3, launched cooperatively: every block is resident, so the grid-wide
// barriers between the sweeps and before the last merge cannot hang.
__global__ void __launch_bounds__(kFwdThreads) bow_fwd_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  fwd_sweep<1>(a, smem);
  grid.sync();
  fwd_sweep<2>(a, smem);
  grid.sync();
  // S_log1mp and Qp of the rows this block owns, a warp a row, in double
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = blockIdx.x + gridDim.x * warp; r < a.B;
       r += gridDim.x * kFwdWarps) {
    const float* p = a.part2 + (size_t)r * a.chunks * 2;
    double s1 = 0.0, s2 = 0.0;
    for (int c = lane; c < a.chunks; c += 32) {
      s1 += p[c * 2];
      s2 += p[c * 2 + 1];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      a.out[2 * a.B + r] = (float)s1;
      a.out[3 * a.B + r] = (float)s2;
    }
  }
}

// rowp is [5, B]: lse, A, (1-c)*gscale, c*gscale, gscale.
// dh_partial is [gridDim.x, B, D], one slice per block.
__global__ void __launch_bounds__(kThreads)
    bow_bwd(const float* __restrict__ h, const float* __restrict__ W,
            const float* __restrict__ b, int B, int D, int V,
            const float* __restrict__ rowp, float* __restrict__ dW,
            float* __restrict__ db, float* __restrict__ dh_partial) {
  extern __shared__ float smem[];
  constexpr int TV = kBwdCols;
  constexpr int Q = TV / 32;
  constexpr int KQ = kThreads / TV;  // k stride of a thread's dW columns
  constexpr int RQ = kThreads / kRows;  // k stride of a thread's dh entries
  const int ld = TV + 1;
  float* Ws = smem;               // [D][ld]
  float* hs = Ws + D * ld;        // [kRows][D]
  float* Gs = hs + kRows * D;     // [kRows][ld]
  float* bs = Gs + kRows * ld;    // [TV]
  float* rp = bs + TV;            // [5][kRows]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nchunk = (V + TV - 1) / TV;
  float* dhp = dh_partial + (size_t)blockIdx.x * B * D;

  for (int ci = 0; ci < kBwdChunks; ++ci) {
    const int chunk = blockIdx.x * kBwdChunks + ci;
    if (chunk >= nchunk) break;
    const int v0 = chunk * TV;
    __syncthreads();
    load_w_chunk(W, b, D, V, v0, TV, Ws, bs);

    // this thread's dW entries: column wc, k = wk, wk + KQ, ...
    const int wc = threadIdx.x % TV;
    const int wk = threadIdx.x / TV;
    float dw[kMaxD / KQ];
#pragma unroll
    for (int j = 0; j < kMaxD / KQ; ++j) dw[j] = 0.f;
    float dbacc = 0.f;

    for (int r0 = 0; r0 < B; r0 += kRows) {
      const int rows = min(kRows, B - r0);
      __syncthreads();
      for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
        hs[e] = h[(size_t)r0 * D + e];
      for (int e = threadIdx.x; e < 5 * kRows; e += blockDim.x) {
        const int f = e / kRows;
        const int r = e - f * kRows;
        rp[e] = (r < rows) ? rowp[(size_t)f * B + r0 + r] : 0.f;
      }
      __syncthreads();

      // G tile; zero past the last row and past V
      for (int r = warp; r < kRows; r += kWarps) {
        float z[Q];
        if (r < rows) row_logits<Q>(hs, Ws, bs, D, ld, r, lane, z);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int c = lane + 32 * q;
          float g = 0.f;
          if (r < rows && v0 + c < V) {
            const float p = fminf(expf(z[q] - rp[r]), kPMax);
            g = -rp[3 * kRows + r] + rp[4 * kRows + r] * rp[kRows + r] * p +
                rp[2 * kRows + r] * p / (1.f - p);
          }
          Gs[r * ld + c] = g;
        }
      }
      __syncthreads();

      // dW[c, k] += sum_r G[r, c] h[r, k];  db[c] += sum_r G[r, c]
      for (int r = 0; r < rows; ++r) {
        const float g = Gs[r * ld + wc];
#pragma unroll
        for (int j = 0; j < kMaxD / KQ; ++j) {
          const int k = wk + KQ * j;
          if (k < D) dw[j] = fmaf(g, hs[r * D + k], dw[j]);
        }
        dbacc += g;
      }

      // dh[r, k] += sum_c G[r, c] W[c, k]
      {
        const int r = threadIdx.x % kRows;
        if (r < rows) {
          for (int k = threadIdx.x / kRows; k < D; k += RQ) {
            float s = 0.f;
            for (int c = 0; c < TV; ++c) s = fmaf(Gs[r * ld + c], Ws[k * ld + c], s);
            const size_t idx = (size_t)(r0 + r) * D + k;
            dhp[idx] = (ci == 0) ? s : dhp[idx] + s;
          }
        }
      }
    }

    // stage dW through shared memory (Gs is free now) for coalesced stores
    __syncthreads();
    float* stage = Gs;  // TV * D <= kRows * ld floats
#pragma unroll
    for (int j = 0; j < kMaxD / KQ; ++j) {
      const int k = wk + KQ * j;
      if (k < D) stage[wc * D + k] = dw[j];
    }
    if (wk == 0 && v0 + wc < V) db[v0 + wc] = dbacc;
    __syncthreads();
    const int valid_cols = min(TV, V - v0);
    for (int e = threadIdx.x; e < valid_cols * D; e += blockDim.x)
      dW[(size_t)v0 * D + e] = stage[e];
  }
}

__global__ void bow_dh_combine(const float* __restrict__ dh_partial,
                               int blocks, int n, float* __restrict__ dh) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int blk = 0; blk < blocks; ++blk) s += dh_partial[(size_t)blk * n + i];
  dh[i] = s;
}

size_t bwd_smem(int D) {
  return sizeof(float) * ((size_t)D * (kBwdCols + 1) + kRows * D +
                          kRows * (kBwdCols + 1) + kBwdCols + 5 * kRows);
}

// The card this thread is on: its SM count and the most shared memory a
// block may ask for.
struct Card {
  int sms, smem;
};

cudaError_t card(Card* c) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&c->smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// One chunk a block where V allows (chunks of ceil(V / SMs) columns within
// kFwdMinCols .. kFwdMaxCols), and z kept where the block's piece fits.
FwdPlan fwd_plan(int B, int D, int V, const Card& c) {
  FwdPlan p;
  p.cols = (V + c.sms - 1) / c.sms;
  p.cols = p.cols < kFwdMinCols ? kFwdMinCols : p.cols;
  p.cols = p.cols > kFwdMaxCols ? kFwdMaxCols : p.cols;
  p.chunks = (V + p.cols - 1) / p.cols;
  p.grid = p.chunks < c.sms ? p.chunks : c.sms;
  p.keep = p.chunks <= p.grid &&
           fwd_smem_floats(B, D, p.cols, 1) * sizeof(float) <= (size_t)c.smem;
  return p;
}

bool bad_shape(int B, int D, int V) {
  return B < 1 || D < 1 || D > kMaxD || V < 1;
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

int carel_bow_max_dim() { return kMaxD; }

// Floats of scratch K3 needs for chunks of `cols` columns: the partials of
// both sweeps, 5 per row and chunk. cols = 0: the chunks carel_bow_fwd cuts.
long long carel_bow_fwd_scratch(int B, int D, int V, int cols) {
  if (cols < 1) {
    Card c;
    if (bad_shape(B, D, V) || card(&c) != cudaSuccess) return -1;
    cols = fwd_plan(B, D, V, c).cols;
  }
  return 5LL * B * ((V + cols - 1) / cols);
}

// Floats of scratch K4 needs: one partial dh [B, D] per block.
long long carel_bow_bwd_scratch(int B, int D, int V) {
  const int nchunk = (V + kBwdCols - 1) / kBwdCols;
  const int blocks = (nchunk + kBwdChunks - 1) / kBwdChunks;
  return (long long)blocks * B * D;
}

// K3 with its plan given: chunks of `cols` columns, `grid` blocks, z kept in
// shared memory between the sweeps or not. One cooperative launch; an error,
// and no launch, if the grid cannot be resident or the shared memory is not
// to be had. scratch: carel_bow_fwd_scratch(B, D, V, cols) floats.
int carel_bow_fwd_planned(const float* h, const float* W, const float* b,
                          int B, int D, int V, int cols, int grid, int keep,
                          float* scratch, float* out, void* stream) {
  if (bad_shape(B, D, V) || cols < 1 || cols > kFwdMaxCols || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int chunks = (V + cols - 1) / cols;
  // every block owns a chunk; a kept piece is the block's only one
  if (grid > chunks || (keep && chunks > grid))
    return (int)cudaErrorInvalidValue;
  Card c;
  cudaError_t err = card(&c);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fwd_smem_floats(B, D, cols, keep) * sizeof(float);
  if (smem > (size_t)c.smem) return (int)cudaErrorInvalidValue;
  err = allow_smem((const void*)bow_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, bow_fwd_kernel, kFwdThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)resident * c.sms < grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  FwdArgs a = {h,      W,       b,
               B,      D,       V,
               cols,   chunks,  keep,
               scratch, scratch + (size_t)3 * B * chunks, out};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)bow_fwd_kernel,
                                          dim3(grid), dim3(kFwdThreads), args,
                                          smem, (cudaStream_t)stream);
}

// K3: out [4, B] = lse, S_z, S_log1mp, Qp per row. scratch:
// carel_bow_fwd_scratch(B, D, V, 0) floats.
int carel_bow_fwd(const float* h, const float* W, const float* b, int B, int D,
                  int V, float* scratch, float* out, void* stream) {
  if (bad_shape(B, D, V)) return (int)cudaErrorInvalidValue;
  Card c;
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return (int)err;
  const FwdPlan p = fwd_plan(B, D, V, c);
  return carel_bow_fwd_planned(h, W, b, B, D, V, p.cols, p.grid, p.keep,
                               scratch, out, stream);
}

// K4: dW [V, D], db [V], dh [B, D] of the dense part of the loss.
int carel_bow_bwd(const float* h, const float* W, const float* b, int B, int D,
                  int V, const float* rowp, float* dW, float* db, float* dh,
                  float* scratch, void* stream) {
  if (bad_shape(B, D, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nchunk = (V + kBwdCols - 1) / kBwdCols;
  const int blocks = (nchunk + kBwdChunks - 1) / kBwdChunks;
  const size_t smem = bwd_smem(D);
  cudaError_t err = allow_smem((const void*)bow_bwd, smem);
  if (err != cudaSuccess) return (int)err;
  bow_bwd<<<blocks, kThreads, smem, s>>>(h, W, b, B, D, V, rowp, dW, db,
                                         scratch);
  const int n = B * D;
  bow_dh_combine<<<(n + 255) / 256, 256, 0, s>>>(scratch, blocks, n, dh);
  return (int)cudaGetLastError();
}

}  // extern "C"

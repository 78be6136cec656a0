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
// The sparse part of the forward (z at the <= T bag-of-words indices) stays
// in plain torch; K4 adds the backward's corrections at those indices to G
// itself, in a fixed order (below).
//
// What bounds it on this card: operations. At the training shape (B = 64,
// D = 48, V = 23,808) one evaluation of z is 2*B*D*V ~ 146 MFLOP of fp32
// on CUDA cores (TF32 is off for this arithmetic), against ~4.6 MB of W,
// which the memory moves in ~1.4 us. The TPU walked the V tiles in order
// with a running max; here the V chunks spread over the SMs instead:
//   K3  one cooperative launch of one block an SM. V is cut into chunks of
//       ceil(V / SMs) columns (181 at the training shape on 132 SMs; 64 at
//       least, 256 at most); a block loads its chunk of W and b once and
//       evaluates its [B, cols] piece of z once, as 4 x J register tiles
//       (J = cols / 32 rounded up to 2, 4, 6 or 8: 4 + J 16-byte
//       shared-memory reads for 16 J FMAs, every thread busy), into shared
//       memory, where the piece stays between the sweeps. Sweep 1 writes the
//       chunk's (max, sumexp, sum z) per row; a grid-wide barrier; every
//       block merges all chunks' partials of a row in the same fixed order,
//       in double, and so holds lse; sweep 2 runs over the kept z and writes
//       (sum log1p(-p), sum p/(1-p)); a second barrier; the blocks merge
//       those, each for its share of the rows. A piece that does not fit in
//       shared memory (a large B), or a V of more chunks than SMs (a block
//       then owns several), is evaluated again in sweep 2, inside the same
//       launch.
//   K4  the same launch shape and cut of V as K3: one cooperative launch of
//       one block an SM, a chunk of ceil(V / SMs) columns a block. The block
//       loads its chunk of W (16-byte cp.async, in two halves of k so that
//       z starts on the first) and, per group of kRows rows of h, evaluates
//       its [rows, cols] piece of z once in K3's register tiles, turning it
//       into G = dL/dz as it leaves the registers, into shared memory. Two
//       products follow from there, in 4 x 4 register tiles fed by 16-byte
//       shared-memory reads: dW = G^T h and db (the block's own columns,
//       written from the registers, where neighbouring lanes hold
//       neighbouring 16 bytes of a row; a later row group adds to them), and
//       its partial dh = G W (two half-warps split the columns and add with a
//       shuffle). The first warps take dh, so the last take the dW tiles
//       past one a thread and db. The partials of dh [B, D] go to scratch;
//       after a grid-wide barrier every block adds up its share of the B*D
//       outputs over all blocks' partials in one fixed order, in double.
//       Operations bound the function: 3 * 2*B*D*V ~ 440 MFLOP of fp32 FMAs,
//       ~6.6 us on the CUDA cores, one product ~2.3 us at an SM's 128 FMAs a
//       cycle; the loads of W, the barrier and the merge come on top.
//       The corrections at the bag-of-words indices, corr[r, t] at
//       column idx[r, t] of G (B*T of them: the TPU adds their products
//       with XLA's scatter-add; float atomics would add them in the order
//       they land, and two runs would differ in their last bits, which bf16
//       carries on through training), are added to the block's piece of G
//       in shared memory before the products: a warp a row, 32 entries a
//       load, and the entries of the row that fall in the chunk (about one
//       in 130) added one at a time in ascending t, so a column that holds
//       an index twice adds in that order; a correction of 0 (an empty
//       slot) is passed over. dW, db and dh then carry them
//       with the dense part, and no atomics, no sort and no second launch
//       are needed.
// No float atomics anywhere, so every output repeats bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // batch rows per pass over a chunk
constexpr int kFwdThreads = 512;  // K3 and K4
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdMinCols = 64;   // V columns per K3 chunk, at least
constexpr int kFwdMaxCols = 256;  // and at most
constexpr int kColGroup = 64;  // columns one pass of K3's register tiles covers
constexpr int kSmemPad = 4;    // floats of row padding in K3's shared memory
constexpr int kMaxD = 64;
constexpr int kBwdTiles = 2;   // K4: 4 x 4 tiles of dW a thread holds
static_assert((kRows / 4) * (kMaxD / 4) * 2 <= kFwdThreads,
              "a dh tile for every two lanes");
static_assert((kFwdMaxCols / 4) * (kMaxD / 4) <= kBwdTiles * kFwdThreads,
              "the chunk's dW in the threads' register tiles");
constexpr float kNeg = -1e30f;
constexpr float kPMax = 1.f - 1e-7f;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the group committed last
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Columns k0 .. k1 (multiples of 4) of the rows 0 .. total of a row-major
// [valid, D] block at src into dst[row][ld], as asynchronous 16-byte copies
// (zeros past `valid` rows), which cp_async_wait_all and a barrier complete.
__device__ __forceinline__ void load_cols(float* dst, int ld, const float* src,
                                          int D, int k0, int k1, int valid,
                                          int total) {
  const int c4 = (k1 - k0) / 4;
  for (int e = threadIdx.x; e < total * c4; e += kFwdThreads) {
    const int r = e / c4, k = k0 + (e - r * c4) * 4;
    cp_async16(dst + r * ld + k, src + (size_t)(r < valid ? r : 0) * D + k,
               r < valid);
  }
}

// Rows 0 .. total of a row-major [valid, D] block at src into dst[row][ld]
// (ld >= d4 = D rounded up to 4); zeros past `valid` rows and past D. With
// `vec` (D a multiple of 4 and src on 16 bytes) as load_cols does.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int D, int d4, int valid, int total,
                                          bool vec) {
  if (vec) {
    load_cols(dst, ld, src, D, 0, d4, valid, total);
  } else {
    for (int e = threadIdx.x; e < total * d4; e += kFwdThreads) {
      const int r = e / d4, k = e - r * d4;
      dst[r * ld + k] = (r < valid && k < D) ? src[(size_t)r * D + k] : 0.f;
    }
  }
}

// z of the rows 0 .. rows of hs at the chunk's columns, through
// epi(row, column, z without b) into zbuf[row][ldz]. A thread holds 4 rows
// (ty + 16 i) x J columns (tx + 32 j), J = cols_pad / 32, and walks k in
// fours, h and W both as [row][ld] tiles, k ascending: one fmaf chain per z,
// whatever J. A warp covers 4 neighbouring rows and 8 neighbouring columns,
// so that its 16-byte reads of h and of W each fall in distinct banks. At
// k = ksplit (< d4) the block first waits for its copies still in flight.
template <int J, typename Epi>
__device__ __forceinline__ void chunk_logits_j(const float* hs, const float* Ws,
                                               int d4, int ksplit, int ld,
                                               int rows, float* zbuf, int ldz,
                                               const Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = (warp & 3) * 8 + (lane & 7);   // 0 .. 31
  const int ty = (warp >> 2) * 4 + (lane >> 3);  // 0 .. 15
  static_assert(kFwdThreads == 512, "16 x 32 threads");
  float acc[4][J];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < d4; k += 4) {
    if (k == ksplit) {
      cp_async_wait_all();
      __syncthreads();
    }
    float4 a[4], w[J];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(hs + (ty + 16 * i) * ld + k);
#pragma unroll
    for (int j = 0; j < J; ++j)
      w[j] = *reinterpret_cast<const float4*>(Ws + (tx + 32 * j) * ld + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float z = acc[i][j];
        z = fmaf(a[i].x, w[j].x, z);
        z = fmaf(a[i].y, w[j].y, z);
        z = fmaf(a[i].z, w[j].z, z);
        z = fmaf(a[i].w, w[j].w, z);
        acc[i][j] = z;
      }
  }
  // every value first, then the stores: no store between two calls of epi,
  // so that the loads of a row's constants are shared
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j)
      acc[i][j] = epi(ty + 16 * i, tx + 32 * j, acc[i][j]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < J; ++j)
        zbuf[(size_t)r * ldz + tx + 32 * j] = acc[i][j];
    }
  }
}

template <typename Epi>
__device__ __forceinline__ void chunk_logits(const float* hs, const float* Ws,
                                             int d4, int ksplit, int ld,
                                             int cols_pad, int rows,
                                             float* zbuf, int ldz,
                                             const Epi& epi) {
  static_assert(kColGroup == 64 && kFwdMaxCols == 256, "J of 2, 4, 6, 8");
  switch (cols_pad / 32) {
    case 2:
      chunk_logits_j<2>(hs, Ws, d4, ksplit, ld, rows, zbuf, ldz, epi);
      break;
    case 4:
      chunk_logits_j<4>(hs, Ws, d4, ksplit, ld, rows, zbuf, ldz, epi);
      break;
    case 6:
      chunk_logits_j<6>(hs, Ws, d4, ksplit, ld, rows, zbuf, ldz, epi);
      break;
    default:
      chunk_logits_j<8>(hs, Ws, d4, ksplit, ld, rows, zbuf, ldz, epi);
      break;
  }
}

// K3 keeps z itself.
struct Logit {
  const float* bs;
  __device__ float operator()(int, int c, float acc) const {
    return acc + bs[c];
  }
};

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
        chunk_logits(hs, Ws, d4, d4, ld, cols_pad, rows, zbuf, ldz,
                     Logit{bs});
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

// Shared memory of K4 in floats: W's chunk [cols_pad][ld], kRows rows of h
// [kRows][ld], b's chunk, the rows' rowp [5][kRows], and G [kRows][ldz]
// (also the merge of dh at the end).
__host__ __device__ constexpr size_t bwd_smem_floats(int D, int cols) {
  const int ld = round_up(D, 4) + kSmemPad;
  const int cols_pad = round_up(cols, kColGroup);
  return (size_t)cols_pad * ld + (size_t)kRows * ld + cols_pad + 5 * kRows +
         (size_t)kRows * (cols_pad + kSmemPad);
}

// K4 turns z into G = dL/dz as it leaves the registers: rp is the rows'
// rowp [5][kRows]; zero past V. exp and p / (1 - p) by the fast intrinsics:
// 1 - p >= 1e-7 is far inside the division's range, and for z - lse >= -88
// __expf's error is a few 1e-7 relative, far inside the gradients' 1e-4.
struct GradOfLogit {
  const float* bs;
  const float* rp;
  int ncols;
  __device__ float operator()(int r, int c, float acc) const {
    const float p = fminf(__expf(acc + bs[c] - rp[r]), kPMax);
    const float g = -rp[3 * kRows + r] + rp[4 * kRows + r] * rp[kRows + r] * p +
                    rp[2 * kRows + r] * __fdividef(p, 1.f - p);
    return c < ncols ? g : 0.f;
  }
};

// The arguments of K4.
struct BwdArgs {
  const float* h;
  const float* W;
  const float* b;
  const float* rowp;  // [5][B]: lse, A, (1-c)*gscale, c*gscale, gscale
  int B, D, V, cols, chunks;
  float* dW;    // [V][D]
  float* db;    // [V]
  float* dh;    // [B][D]
  float* part;  // [gridDim.x][B][D]: each block's partial dh
  const long long* idx;  // [B][T]: the BoW indices (any column outside V
                         // adds nothing)
  const float* corr;     // [B][T]: the corrections to G at them (0: none)
  int T;
};

// K4, launched cooperatively like K3: the barrier before the merge of dh
// cannot hang.
__global__ void __launch_bounds__(kFwdThreads) bow_bwd_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int d4 = round_up(a.D, 4), ld = d4 + kSmemPad;
  const int cols_pad = round_up(a.cols, kColGroup), ldz = cols_pad + kSmemPad;
  float* Ws = smem;                // [cols_pad][ld]
  float* hs = Ws + cols_pad * ld;  // [kRows][ld]
  float* bs = hs + kRows * ld;     // [cols_pad]
  float* rp = bs + cols_pad;       // [5][kRows]
  float* Gs = rp + 5 * kRows;      // [kRows][ldz]
  const bool vec = a.D % 4 == 0 &&
                   ((size_t)a.W | (size_t)a.h | (size_t)a.dW) % 16 == 0;
  const int tid = threadIdx.x;
  // dW tiles: 4 columns x 4 k, the k tile fastest, so that a warp reads few
  // G vectors (broadcast) and neighbouring h vectors
  const int nkt = d4 / 4;
  // dh tiles: 4 rows (rt + 16 i) x 4 k (hk ..). A warp takes 4 rt two rows
  // apart, 4 neighbouring k tiles and, in its upper half-warp, the odd
  // column quads: its 16-byte reads of G and of W each fall in distinct
  // banks (ldz = 4 mod 32; ld = 16 mod 32 when d4 / 4 is even). Warps
  // 0 .. 4 * ceil(nkt / 4) - 1 take part; lanes past nkt compute k tile 0
  // and write nothing.
  const int warp = tid / 32, lane = tid % 32;
  const bool hwarp = warp < 4 * ((nkt + 3) / 4);
  const int hsplit = lane >> 4;
  const int rt = (warp & 1) + 8 * ((warp >> 1) & 1) + 2 * ((lane >> 2) & 3);
  const int kt = (warp >> 2) * 4 + (lane & 3);
  const bool hvalid = hwarp && kt < nkt;
  const int hk = hvalid ? kt * 4 : 0;
  float* part = a.part + (size_t)blockIdx.x * a.B * a.D;

  for (int chunk = blockIdx.x; chunk < a.chunks; chunk += gridDim.x) {
    const int v0 = chunk * a.cols;
    const int ncols = min(a.cols, a.V - v0);
    const bool first = chunk == blockIdx.x;
    // the columns of the chunk that carry V, in quads (dW) and octets (dh)
    const int ndw = (ncols + 3) / 4 * nkt, ncols8 = round_up(ncols, 8);
    __syncthreads();  // the chunk before is done with Ws, bs and Gs
    for (int r0 = 0; r0 < a.B; r0 += kRows) {
      const int rows = min(kRows, a.B - r0);
      __syncthreads();  // the rows before are done with hs, rp and Gs
      load_rows(hs, ld, a.h + (size_t)r0 * a.D, a.D, d4, rows, kRows, vec);
      // with the first rows, W's chunk: its first half of k in a group of
      // copies of its own, so that z starts before the second half is in
      int ksplit = d4;
      if (r0 == 0) {
        const float* Wc = a.W + (size_t)v0 * a.D;
        if (vec) {
          ksplit = d4 / 8 * 4;
          cp_async_commit();
          load_cols(Ws, ld, Wc, a.D, 0, ksplit, ncols, cols_pad);
          cp_async_commit();
          load_cols(Ws, ld, Wc, a.D, ksplit, d4, ncols, cols_pad);
          cp_async_commit();
        } else {
          load_rows(Ws, ld, Wc, a.D, d4, ncols, cols_pad, false);
        }
      }
      // b and rowp by plain loads, while the copies are in flight
      if (r0 == 0)
        for (int c = tid; c < cols_pad; c += kFwdThreads)
          bs[c] = c < ncols ? a.b[v0 + c] : 0.f;
      for (int e = tid; e < 5 * kRows; e += kFwdThreads) {
        const int f = e / kRows, r = e - f * kRows;
        rp[e] = r < rows ? a.rowp[(size_t)f * a.B + r0 + r] : 0.f;
      }
      if (ksplit < d4)
        cp_async_wait_but_one();
      else
        cp_async_wait_all();
      __syncthreads();
      // G of the rows < rows; the rows past them are not read
      chunk_logits(hs, Ws, d4, ksplit, ld, cols_pad, rows, Gs, ldz,
                   GradOfLogit{bs, rp, ncols});
      __syncthreads();
      // the corrections of these rows that fall in the chunk: a warp a
      // row, and in a row one entry at a time, t ascending. A warp asks
      // for four loads of 32 entries before it looks at them. An entry
      // whose correction is 0 (an empty slot, index 0) adds nothing and
      // is passed over: otherwise the block of column 0 would take every
      // empty slot of every row, one at a time.
      for (int r = warp; r < rows; r += kFwdWarps) {
        const long long* ir = a.idx + (size_t)(r0 + r) * a.T;
        const float* cr = a.corr + (size_t)(r0 + r) * a.T;
        for (int t0 = 0; t0 < a.T; t0 += 4 * 32) {
          long long c[4];
          float x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int t = t0 + 32 * q + lane;
            c[q] = t < a.T ? ir[t] - v0 : -1;
            x[q] = t < a.T ? cr[t] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool in = c[q] >= 0 && c[q] < ncols && x[q] != 0.f;
            for (unsigned m = __ballot_sync(0xffffffffu, in); m;
                 m &= m - 1) {
              if (lane == __ffs(m) - 1) Gs[r * ldz + (int)c[q]] += x[q];
              __syncwarp();
            }
          }
        }
      }
      __syncthreads();

      // dW[c, k] of these rows = sum_r G[r, c] h[r, k], r ascending. A
      // thread's second tile, and db, go to the last warps first: the first
      // warps also take dh.
      float dw[kBwdTiles][4][4];
#pragma unroll
      for (int t = 0; t < kBwdTiles; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dw[t][i][j] = 0.f;
#pragma unroll
      for (int t = 0; t < kBwdTiles; ++t) {
        const int tile = t == 0 ? tid : 2 * kFwdThreads - 1 - tid;
        if (tile < ndw) {
          const int c0 = tile / nkt * 4, k0 = tile % nkt * 4;
          for (int r = 0; r < rows; ++r) {
            const float4 g =
                *reinterpret_cast<const float4*>(Gs + r * ldz + c0);
            const float4 x =
                *reinterpret_cast<const float4*>(hs + r * ld + k0);
            const float gv[4] = {g.x, g.y, g.z, g.w};
            const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                dw[t][i][j] = fmaf(gv[i], xv[j], dw[t][i][j]);
          }
        }
      }
      // db[c] of these rows, column c in thread kFwdThreads - 1 - c
      const int dbc = kFwdThreads - 1 - tid;
      float dbacc = 0.f;
      if (dbc < ncols)
        for (int r = 0; r < rows; ++r) dbacc += Gs[r * ldz + dbc];

      // dW and db of these rows, written from the registers: the k tile is
      // the fastest, so neighbouring lanes write neighbouring 16 bytes of a
      // row of dW. A later group of rows adds to them.
      float* dst = a.dW + (size_t)v0 * a.D;
#pragma unroll
      for (int t = 0; t < kBwdTiles; ++t) {
        const int tile = t == 0 ? tid : 2 * kFwdThreads - 1 - tid;
        if (tile < ndw) {
          const int c0 = tile / nkt * 4, k0 = tile % nkt * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (c0 + i >= ncols) break;
            float* row = dst + (size_t)(c0 + i) * a.D + k0;
            if (vec) {
              float4 v = make_float4(dw[t][i][0], dw[t][i][1], dw[t][i][2],
                                     dw[t][i][3]);
              if (r0 > 0) {
                const float4 u = *reinterpret_cast<const float4*>(row);
                v = make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
              }
              *reinterpret_cast<float4*>(row) = v;
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (k0 + j < a.D)
                  row[j] = r0 == 0 ? dw[t][i][j] : row[j] + dw[t][i][j];
            }
          }
        }
      }
      if (dbc < ncols)
        a.db[v0 + dbc] = r0 == 0 ? dbacc : a.db[v0 + dbc] + dbacc;

      // this block's dh[r, k] += sum_c G[r, c] W[c, k], c ascending in each
      // half-warp, then the two halves' sums added
      if (hwarp) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int c = 4 * hsplit; c < ncols8; c += 8) {
          float4 g[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            g[i] = *reinterpret_cast<const float4*>(Gs + (rt + 16 * i) * ldz +
                                                    c);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            w[q] = *reinterpret_cast<const float4*>(Ws + (c + q) * ld + hk);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float gv[4] = {g[i].x, g[i].y, g[i].z, g[i].w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[i][0] = fmaf(gv[q], w[q].x, acc[i][0]);
              acc[i][1] = fmaf(gv[q], w[q].y, acc[i][1]);
              acc[i][2] = fmaf(gv[q], w[q].z, acc[i][2]);
              acc[i][3] = fmaf(gv[q], w[q].w, acc[i][3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
        if (hvalid && hsplit == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = rt + 16 * i;
            if (r >= rows) break;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (hk + j >= a.D) break;
              const size_t idx = (size_t)(r0 + r) * a.D + hk + j;
              part[idx] = first ? acc[i][j] : part[idx] + acc[i][j];
            }
          }
        }
      }
    }
  }

  grid.sync();
  // dh: a block takes 32 neighbouring outputs at a time; warp w adds the
  // partials of blocks w, w + kFwdWarps, ... in double, then warp 0 adds the
  // warps' sums in order
  double* red = reinterpret_cast<double*>(Gs);  // [kFwdWarps][32]
  const int n = a.B * a.D;
  constexpr int kLoads = 16;  // partials a lane asks for before it adds
  for (int o0 = blockIdx.x * 32; o0 < n; o0 += gridDim.x * 32) {
    const int o = o0 + lane;
    double s = 0.0;
    if (o < n)
      for (int blk0 = warp; blk0 < (int)gridDim.x; blk0 += kFwdWarps * kLoads) {
        float v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int blk = blk0 + u * kFwdWarps;
          v[u] = blk < (int)gridDim.x ? a.part[(size_t)blk * n + o] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) s += v[u];
      }
    __syncthreads();  // the outputs before are done with red
    red[warp * 32 + lane] = s;
    __syncthreads();
    if (warp == 0 && o < n) {
      double t = 0.0;
      for (int w = 0; w < kFwdWarps; ++w) t += red[w * 32 + lane];
      a.dh[o] = (float)t;
    }
  }
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

// Floats of scratch K4 needs for a grid of `grid` blocks: one partial dh
// [B, D] a block. grid = 0: the grid carel_bow_bwd launches.
long long carel_bow_bwd_scratch(int B, int D, int V, int grid) {
  if (grid < 1) {
    Card c;
    if (bad_shape(B, D, V) || card(&c) != cudaSuccess) return -1;
    grid = fwd_plan(B, D, V, c).grid;
  }
  return (long long)grid * B * D;
}

// K4 with its plan given: chunks of `cols` columns, `grid` blocks. One
// cooperative launch; an error, and no launch, if the grid cannot be
// resident or the shared memory is not to be had. scratch:
// carel_bow_bwd_scratch(B, D, V, grid) floats.
int carel_bow_bwd_planned(const float* h, const float* W, const float* b,
                          int B, int D, int V, int cols, int grid,
                          const float* rowp, const long long* idx,
                          const float* corr, int T, float* dW, float* db,
                          float* dh, float* scratch, void* stream) {
  if (bad_shape(B, D, V) || cols < 1 || cols > kFwdMaxCols || grid < 1 ||
      T < 1 || idx == nullptr || corr == nullptr)
    return (int)cudaErrorInvalidValue;
  const int chunks = (V + cols - 1) / cols;
  if (grid > chunks) return (int)cudaErrorInvalidValue;
  Card c;
  cudaError_t err = card(&c);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bwd_smem_floats(D, cols) * sizeof(float);
  if (smem > (size_t)c.smem) return (int)cudaErrorInvalidValue;
  err = allow_smem((const void*)bow_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, bow_bwd_kernel, kFwdThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)resident * c.sms < grid)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  BwdArgs a = {h,  W,  b,  rowp,    B,   D,    V, cols, chunks,
               dW, db, dh, scratch, idx, corr, T};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)bow_bwd_kernel,
                                          dim3(grid), dim3(kFwdThreads), args,
                                          smem, (cudaStream_t)stream);
}

// K4: dW [V, D], db [V], dh [B, D] of the loss, in K3's cut of V: the
// dense part, and the corrections corr [B, T] at the BoW indices idx
// [B, T]. scratch: carel_bow_bwd_scratch(B, D, V, 0) floats.
int carel_bow_bwd(const float* h, const float* W, const float* b, int B, int D,
                  int V, const float* rowp, const long long* idx,
                  const float* corr, int T, float* dW, float* db, float* dh,
                  float* scratch, void* stream) {
  if (bad_shape(B, D, V)) return (int)cudaErrorInvalidValue;
  Card c;
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return (int)err;
  const FwdPlan p = fwd_plan(B, D, V, c);
  return carel_bow_bwd_planned(h, W, b, B, D, V, p.cols, p.grid, rowp, idx,
                               corr, T, dW, db, dh, scratch, stream);
}

}  // extern "C"

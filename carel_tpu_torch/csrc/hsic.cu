// HSIC between two latent samples: forward (K5) and analytic backward (K6),
// for Hopper (sm_90a).
//
// Replaces carel_tpu/ops/pallas_pairwise.py: _hsic_fwd_kernel (forward, via
// _hsic_call_fwd) and _hsic_bwd_kernel (backward, via _hsic_core_bwd).
//
//   K = exp(-d2(x, x) / s_x) o m m^T,  L = exp(-d2(y, y) / s_y) o m m^T,
//   center(A) = A - m colsum(A)^T / n - rowsum(A) m^T / n + m m^T sum(A) / n^2
//   value = sum(center(K) o center(L)) / (n - 1)^2,   n = sum(m).
//
// What bounds it on this card: launch latency. At the training shape
// (B = 64 rows, d = 24) the statistic is a few 10^5 operations over ~12 KB of
// input, far below a microsecond at either the compute or the memory rate.
// What the design is about instead is precision: when the latents lie close
// together, K and L are nearly all ones and the centred entries are small
// differences of O(1) numbers, which fp32 loses (the plain fp32 version is off
// by ~3e-4 relative there). So every Gram entry, centring and sum is formed
// in double, from the fp32 inputs, and the centring is explicit (each centred
// entry is formed before the product), never the expanded
// sum(K o L) - 2/n sum(rK rL) + ... form that cancels O(n^2) terms.
//   K5  one cooperative launch of blocks of 8 warps, a warp a row of both
//       Grams (B = 64: 8 blocks). Phase 1: each lane
//       evaluates the entries (i, j), j = lane, lane + 32, ... of K and L
//       once and keeps them in registers (B <= 32 kKeep, one row a warp),
//       and the warp adds them into rK_i, rL_i. A grid-wide barrier. Phase
//       2: every block forms n and the totals from the row sums in the same
//       fixed order, and each warp sums its row of center(K) o center(L) from
//       the kept entries into a partial of that row. A second barrier; block
//       0 adds the B partials in a fixed order. Everything in double; no
//       atomics, so the value repeats bit for bit. A B too large to keep the
//       entries, or with more rows than the grid has warps, evaluates them
//       again in phase 2, inside the same launch. One launch and not two:
//       at the training shape the grid is 8 blocks, always resident, and a
//       barrier costs less than a second launch.
//   K6  one launch, a warp an output row (rows of dx, then of dy; B = 64:
//       128 warps in 32 blocks of 4, one warp to a scheduler of an SM).
//       With the residuals of K5 (row sums, n, totals) a warp rebuilds its
//       row of the centred other Gram on the fly: dx_i = sum_j W_ij
//       (x_i - x_j) with W = center(L) o K, times -4 g / (s_x (n - 1)^2)
//       at the end, and dy likewise. Row i of both samples is read once, in
//       double; x and y go through shared memory in chunks of kChunk rows,
//       converted to double once each, beside the chunk's row sums times
//       1 / n. The lanes stride over j; a lane forms both squared distances
//       of (i, j) in one pass and adds W_ij (z_i - z_j) into its d
//       accumulators in double. The warp merges its lanes by recursive
//       halving, 31 shuffles for 32 values, so that lane k ends with
//       coordinate k: no shared-memory tree and no barrier after the loop.
//       No [B, B] buffer, no atomics: the gradients repeat bit for bit, and
//       the order of every sum depends on B alone, not on the grid. Rows
//       whose mask is 0 get exactly 0. What is left at the training shape
//       is latency, so the design shortens the chain a warp runs: g, n and
//       the row's constants are read before the loop, not after it, and
//       the divisions by n are one reciprocal. A warp for each side
//       measured faster than one warp for both dx_i and dy_i (which
//       evaluates each Gram entry half as often but holds 2 d accumulators
//       a lane and spills), than two entries a lane side by side, than
//       blocks of 2 or 8 warps and than reading the rows straight from
//       global memory.
// d2 is sum_k (a_k - b_k)^2 in double: symmetric bit for bit, exactly 0 on
// the diagonal, and free of the cancellation of |a|^2 + |b|^2 - 2 a.b.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "warp_merge.cuh"

namespace {

constexpr int kMaxDim = 32;
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kKeep = 4;  // Gram entries of a row a K5 lane keeps
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kChunk = 64;  // rows of x and of y K6 stages at a time
// doubles a staged row: odd, so that the lanes, each reading its own row,
// meet no bank conflict
constexpr int kRowStride = kMaxDim + 1;
constexpr int kMaxRows = 1 << 15;

// residual layout (doubles): rK[B], rL[B], n, sum(K), sum(L)
constexpr int kResExtra = 3;
static_assert(kChunk % 32 == 0,
              "a K6 lane must take the same j in every chunk");

__device__ __forceinline__ double gram(const float* a, const float* b, int d,
                                       double inv_s) {
  double s = 0.0;
#pragma unroll 8
  for (int k = 0; k < d; ++k) {
    const double t = (double)a[k] - (double)b[k];
    s = fma(t, t, s);
  }
  return exp(-s * inv_s);
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fixed-order block reduction of one double per thread; the result is valid
// in red[0] after the call. blockDim.x must be a power of two.
__device__ double block_sum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const double out = red[0];
  __syncthreads();
  return out;
}

// centred entry (i, j) of a masked Gram whose entry is g (already times
// m_i m_j), given its row sums r, total tot and n
__device__ __forceinline__ double centred(double g, double mi, double mj,
                                          double ri, double rj, double tot,
                                          double n) {
  return g - (mi * rj) / n - (ri * mj) / n + (mi * mj) * (tot / (n * n));
}

// The arguments of K5.
struct FwdArgs {
  const float* x;
  const float* y;
  const float* mask;
  int B, d;
  double inv_sx, inv_sy;
  double* res;   // rK[B], rL[B], n, sum(K), sum(L)
  double* part;  // [B]: the row sums of center(K) o center(L)
  float* out;
};

// Entry (i, j) of the masked K and of the masked L, with row i of x and of y
// given as xi, yi (in shared memory) and mi = mask[i].
__device__ __forceinline__ void gram_pair(const FwdArgs& a, const float* xi,
                                          const float* yi, double mi, int j,
                                          double* k, double* l) {
  const double mm = mi * (double)a.mask[j];
  *k = 0.0;
  *l = 0.0;
  if (mm != 0.0) {
    *k = gram(xi, a.x + (size_t)j * a.d, a.d, a.inv_sx) * mm;
    *l = gram(yi, a.y + (size_t)j * a.d, a.d, a.inv_sy) * mm;
  }
}

// K5, launched cooperatively: every block is resident, so the two
// grid-wide barriers cannot hang.
__global__ void __launch_bounds__(kFwdThreads) hsic_fwd_kernel(FwdArgs a) {
  __shared__ double red[kFwdThreads];
  __shared__ float own[kFwdWarps][2][kMaxDim];  // x_i, y_i of a warp's row
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int B = a.B, d = a.d;
  const int first = blockIdx.x * kFwdWarps + warp;
  const int stride = gridDim.x * kFwdWarps;
  // kept: one row a warp, at most kKeep entries of it a lane
  const bool keep = B <= 32 * kKeep && stride >= B;
  double* rK = a.res;
  double* rL = a.res + B;
  double kk[kKeep], ll[kKeep];

  // 1. row sums of the masked Grams, j ascending per lane, then the warp
  for (int i = first; i < B; i += stride) {
    if (lane < d) {
      own[warp][0][lane] = a.x[(size_t)i * d + lane];
      own[warp][1][lane] = a.y[(size_t)i * d + lane];
    }
    __syncwarp();
    const double mi = a.mask[i];
    double sk = 0.0, sl = 0.0;
    if (keep) {
#pragma unroll
      for (int q = 0; q < kKeep; ++q) {
        const int j = lane + 32 * q;
        kk[q] = ll[q] = 0.0;
        if (j < B) gram_pair(a, own[warp][0], own[warp][1], mi, j, &kk[q],
                             &ll[q]);
        sk += kk[q];
        sl += ll[q];
      }
    } else {
      for (int j = lane; j < B; j += 32) {
        double k, l;
        gram_pair(a, own[warp][0], own[warp][1], mi, j, &k, &l);
        sk += k;
        sl += l;
      }
    }
    sk = warp_sum(sk);
    sl = warp_sum(sl);
    if (lane == 0) {
      rK[i] = sk;
      rL[i] = sl;
    }
    __syncwarp();  // the next row may overwrite own
  }
  grid.sync();

  // 2. n and the totals, the same fixed-order block sums in every block
  double pn = 0.0, pk = 0.0, pl = 0.0;
  for (int i = threadIdx.x; i < B; i += kFwdThreads) {
    pn += a.mask[i];
    pk += rK[i];
    pl += rL[i];
  }
  const double n = block_sum(pn, red);
  const double totK = block_sum(pk, red);
  const double totL = block_sum(pl, red);

  // the row's sum of the explicitly centred entries' products
  for (int i = first; i < B; i += stride) {
    if (!keep) {
      if (lane < d) {
        own[warp][0][lane] = a.x[(size_t)i * d + lane];
        own[warp][1][lane] = a.y[(size_t)i * d + lane];
      }
      __syncwarp();
    }
    const double mi = a.mask[i], rKi = rK[i], rLi = rL[i];
    double acc = 0.0;
    if (keep) {
#pragma unroll
      for (int q = 0; q < kKeep; ++q) {
        const int j = lane + 32 * q;
        if (j < B) {
          const double mj = a.mask[j];
          acc += centred(kk[q], mi, mj, rKi, rK[j], totK, n) *
                 centred(ll[q], mi, mj, rLi, rL[j], totL, n);
        }
      }
    } else {
      for (int j = lane; j < B; j += 32) {
        double k, l;
        gram_pair(a, own[warp][0], own[warp][1], mi, j, &k, &l);
        const double mj = a.mask[j];
        acc += centred(k, mi, mj, rKi, rK[j], totK, n) *
               centred(l, mi, mj, rLi, rL[j], totL, n);
      }
      __syncwarp();  // the next row may overwrite own
    }
    acc = warp_sum(acc);
    if (lane == 0) a.part[i] = acc;
  }
  grid.sync();

  // 3. the rows' partials in a fixed order, in block 0
  if (blockIdx.x != 0) return;
  double pt = 0.0;
  for (int i = threadIdx.x; i < B; i += kFwdThreads) pt += a.part[i];
  const double total = block_sum(pt, red);
  if (threadIdx.x == 0) {
    a.res[2 * B] = n;
    a.res[2 * B + 1] = totK;
    a.res[2 * B + 2] = totL;
    a.out[0] = (float)(total / ((n - 1.0) * (n - 1.0)));
  }
}

// The arguments of K6.
struct BwdArgs {
  const float* x;
  const float* y;
  const float* mask;
  int B, d;
  double inv_sx, inv_sy;
  const double* res;  // K5's: rK[B], rL[B], n, sum(K), sum(L)
  const float* g;
  float* dx;
  float* dy;
};

// K6 with rows of DP coordinates (d rounded up to 8; the rows are zero past
// d, which leaves every sum bit for bit as over d).
template <int DP>
__global__ void __launch_bounds__(kBwdThreads) hsic_bwd_kernel(BwdArgs a) {
  __shared__ double rows_s[2][kChunk][kRowStride];  // x, y rows of a chunk
  __shared__ double rsum_n[2][kChunk];  // rK_j, rL_j times 1 / n
  __shared__ double mask_s[kChunk];
  const int B = a.B, d = a.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x * kBwdWarps + warp;  // output row, of 2B
  const bool active = q < 2 * B;
  const int side = q >= B ? 1 : 0;  // 0: row i of dx, 1: row i of dy
  const int i = active ? q - side * B : 0;
  const float* self = side ? a.y : a.x;
  const float* other = side ? a.x : a.y;
  const double inv_self = side ? a.inv_sy : a.inv_sx;
  const double inv_other = side ? a.inv_sx : a.inv_sy;
  // the row sums and total of the OTHER Gram centre it:
  // center(O)_ij = O_ij - m_i r_j / n - r_i / n m_j + m_i m_j tot / n^2,
  // each over n as a product with 1 / n, formed once
  const double n = a.res[2 * B];
  const double inv_n = 1.0 / n;
  const double tot_n2 = a.res[2 * B + (side ? 1 : 2)] * inv_n * inv_n;
  const double ri_n = a.res[(side ? 0 : B) + i] * inv_n;
  const double mi = a.mask[i];
  const bool work = active && mi != 0.0;  // a masked row's gradient is 0
  // read with the rest here, and not after the loop, where the load would
  // be one more trip to memory on the way out
  const double scale =
      -4.0 * inv_self * (double)(*a.g) / ((n - 1.0) * (n - 1.0));

  double zi[DP], oi[DP];  // row i of this sample and of the other one
#pragma unroll
  for (int k = 0; k < DP; ++k) {
    zi[k] = k < d ? (double)self[(size_t)i * d + k] : 0.0;
    oi[k] = k < d ? (double)other[(size_t)i * d + k] : 0.0;
  }
  double acc[DP];
#pragma unroll
  for (int k = 0; k < DP; ++k) acc[k] = 0.0;

  for (int c0 = 0; c0 < B; c0 += kChunk) {
    const int rows = min(kChunk, B - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < rows * DP; e += kBwdThreads) {
      const int j = e / DP, k = e % DP;
      const size_t at = (size_t)(c0 + j) * d + k;
      rows_s[0][j][k] = k < d ? (double)a.x[at] : 0.0;
      rows_s[1][j][k] = k < d ? (double)a.y[at] : 0.0;
    }
    for (int j = threadIdx.x; j < rows; j += kBwdThreads) {
      rsum_n[0][j] = a.res[c0 + j] * inv_n;
      rsum_n[1][j] = a.res[B + c0 + j] * inv_n;
      mask_s[j] = a.mask[c0 + j];
    }
    __syncthreads();
    if (!work) continue;
    const double(*zs)[kRowStride] = rows_s[side];
    const double(*os)[kRowStride] = rows_s[1 - side];
    const double* rj_n = rsum_n[1 - side];
    // lane l takes j = l, l + 32, ... in order (kChunk is a multiple of 32)
    for (int j = lane; j < rows; j += 32) {
      const double mj = mask_s[j];
      if (mj == 0.0) continue;
      // both squared distances as gram() forms them
      double s_self = 0.0, s_other = 0.0;
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        const double t = zi[k] - zs[j][k];
        s_self = fma(t, t, s_self);
        const double u = oi[k] - os[j][k];
        s_other = fma(u, u, s_other);
      }
      const double mm = mi * mj;
      const double kij = exp(-s_self * inv_self) * mm;
      const double oij = exp(-s_other * inv_other) * mm;
      // the centred entry, formed explicitly, times this Gram's entry
      const double w = (oij - mi * rj_n[j] - ri_n * mj + mm * tot_n2) * kij;
#pragma unroll
      for (int k = 0; k < DP; ++k) acc[k] = fma(w, zi[k] - zs[j][k], acc[k]);
    }
  }
  if (!active) return;
  // R accumulators, a power of two, zero past DP
  constexpr int R = kMergedValues<DP>;
  double v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = k < DP ? acc[k] : 0.0;
  warp_reduce_scatter<R>(v, lane);
  // lane l holds the sum of coordinate e(l); the lanes 32 / R apart hold
  // each coordinate once
  constexpr int spread = 32 / R;
  const int e = lane / spread;
  if (lane % spread != 0 || e >= d) return;
  float* out = side ? a.dy : a.dx;
  out[(size_t)i * d + e] = work ? (float)(v[0] * scale) : 0.f;
}

bool bad_shape(int B, int d, float s_x, float s_y) {
  return B < 2 || B > kMaxRows || d < 1 || d > kMaxDim || !(s_x > 0.f) ||
         !(s_y > 0.f);
}

}  // namespace

extern "C" {

// Doubles of the residual buffer K5 writes and K6 reads, for B rows.
int carel_hsic_residuals(int B) { return 2 * B + kResExtra; }

int carel_hsic_max_dim() { return kMaxDim; }

int carel_hsic_max_rows() { return kMaxRows; }

// Doubles of scratch K5 needs besides the residuals, for B rows.
int carel_hsic_fwd_scratch(int B) { return B; }

// K5: out[0] = HSIC; res gets the row sums, n and the totals for K6.
// scratch: carel_hsic_fwd_scratch(B) doubles. One cooperative launch; an
// error, and no launch, if the grid cannot be resident.
int carel_hsic_fwd(const float* x, const float* y, const float* mask, int B,
                   int d, float s_x, float s_y, double* res, double* scratch,
                   float* out, void* stream) {
  if (bad_shape(B, d, s_x, s_y)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, hsic_fwd_kernel, kFwdThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int rows = (B + kFwdWarps - 1) / kFwdWarps;  // blocks of a row a warp
  const int grid = rows < resident * sms ? rows : resident * sms;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  FwdArgs a = {x, y, mask, B, d, 1.0 / (double)s_x, 1.0 / (double)s_y,
               res, scratch, out};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)hsic_fwd_kernel,
                                          dim3(grid), dim3(kFwdThreads), args,
                                          0, (cudaStream_t)stream);
}

// K6: dx, dy of g * HSIC, with g = *g_ptr read on the device and res the
// residuals K5 wrote for the same inputs. One launch, a warp an output row.
int carel_hsic_bwd(const float* x, const float* y, const float* mask, int B,
                   int d, float s_x, float s_y, const double* res,
                   const float* g_ptr, float* dx, float* dy, void* stream) {
  if (bad_shape(B, d, s_x, s_y)) return (int)cudaErrorInvalidValue;
  BwdArgs args{x, y, mask, B, d, 1.0 / (double)s_x, 1.0 / (double)s_y,
               res, g_ptr, dx, dy};
  const int grid = (2 * B + kBwdWarps - 1) / kBwdWarps;
#define CAREL_LAUNCH(DP) \
  hsic_bwd_kernel<DP><<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(args)
  CAREL_DISPATCH_DIM(d, CAREL_LAUNCH);
#undef CAREL_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"

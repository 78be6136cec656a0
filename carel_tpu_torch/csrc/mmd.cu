// Fused unbiased MMD^2 between two latent samples: forward (K1) and
// analytic backward (K2), for Hopper (sm_90a).
//
// Replaces carel_tpu/ops/pallas_pairwise.py: _mmd_fwd_kernel (forward, via
// _mmd_call_fwd) and _mmd_bwd_kernel (backward, via _mmd_core_bwd).
//
//   MMD^2 = 2 a01 sum k(x, y) + a00 (sum_{i!=j} k(x, x) + sum_{i!=j} k(y, y)),
//   k(a, b) = sum_alpha exp(-alpha (eps + |d2|)),  d2 = |a|^2 + |b|^2 - 2 a.b,
//   masked rows zeroed, n = sum(mask), a00 = 1/(n(n-1)), a01 = -1/n^2.
//
// What bounds it on this card: launch latency. At the training shape
// (B = 64 rows, d = 24) the statistic is ~0.5 MFLOP over ~12 KB of input,
// far below a microsecond at either the fp32 rate or the memory rate, so
// what counts is the number of launches and of dependent trips to memory:
//   K1  one launch. A block takes one pair of kTile-row tiles (ti <= tj):
//       the xy pairs of (ti, tj) and, off the diagonal, of (tj, ti), and the
//       xx and yy pairs of (ti, tj), only j > i inside a diagonal tile. d2
//       is bitwise symmetric, so the xx and yy sums over the upper triangle,
//       doubled in double, are exact. A thread a row stages the block's four
//       row tiles in shared memory and forms the row's squared norm once;
//       then thread (i, j) takes pair (i, j) of all four tile products,
//       their dot products side by side, and sums in double. The block
//       writes 3 partials, and the last block to take a ticket merges all
//       partials in a fixed order (thread-strided, then the block's fixed
//       tree), forms n and the value and puts the ticket back to 0. The
//       diagonal blocks write the 2B row norms for K2. B = 64: 36 blocks of
//       64 threads (small tiles and one staging phase measured faster than
//       tiles of 16 rows or a separate norm phase). What is left is latency:
//       a launch, then three dependent trips to memory (the rows, the
//       ticket, the partials) with a short chain of arithmetic and barriers
//       between them.
//   K2  one launch, a warp per output row (rows of dx, then of dy; B = 64:
//       128 warps in 16 blocks of 256). The lanes stride over j, each lane
//       keeps the row's d accumulators in registers, and the warp adds them
//       by recursive halving, which gives the bits of a fixed xor butterfly
//       per accumulator in 31 shuffles instead of 5 d. d2 comes from K1's
//       norms and the same sequential dot product, so sign(d2) is the sign
//       the forward saw. x and y go through shared memory in chunks of
//       kChunk rows.
// No float atomics: the value and the gradients repeat bit for bit. The one
// integer atomic is K1's ticket, which always returns to 0, so a CUDA graph
// replays K1 as it is.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include "warp_merge.cuh"

namespace {

constexpr float kEps = 1e-5f;
constexpr int kMaxAlphas = 4;
constexpr int kMaxDim = 32;
constexpr int kStride = kMaxDim + 4;  // floats a staged row: no bank conflicts
constexpr int kTile = 8;              // rows of a K1 tile
constexpr int kFwdThreads = kTile * kTile;  // a thread a pair of rows
constexpr int kFwdWarps = kFwdThreads / 32;
// K1 stages its 4 kTile rows and 2 kTile masks with one thread each, and
// its block sums shuffle over whole warps
static_assert(kFwdThreads % 32 == 0 && kFwdThreads >= 6 * kTile,
              "K1's block must be whole warps and cover its staging");
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kChunk = 128;  // rows of x and of y K2 stages at a time

struct Alphas {
  float a[kMaxAlphas];
  int n;
};

// sum_a exp(-a * (eps + |d2|)); the loops run over constant indices, so the
// alphas stay in the kernel's parameters and never go to local memory
__device__ __forceinline__ float rbf(float d2, const Alphas& al) {
  const float pd2 = kEps + fabsf(d2);
  float k = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxAlphas; ++i)
    if (i < al.n) k += expf(-al.a[i] * pd2);
  return k;
}

// d rbf / d d2 = sign(d2) * sum_a (-a) exp(-a * (eps + |d2|))
__device__ __forceinline__ float drbf(float d2, const Alphas& al) {
  const float pd2 = kEps + fabsf(d2);
  float c = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxAlphas; ++i)
    if (i < al.n) c += -al.a[i] * expf(-al.a[i] * pd2);
  const float sgn = (d2 > 0.f) ? 1.f : ((d2 < 0.f) ? -1.f : 0.f);
  return c * sgn;
}

// a.b over DP coordinates (zero past d), k ascending: fp multiplication
// commutes, so dot(a, b) and dot(b, a) have the same bits
template <int DP>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < DP; ++k) s = fmaf(a[k], b[k], s);
  return s;
}

// d2 from the two squared norms and the dot product; symmetric bit for bit
__device__ __forceinline__ float sq_dist(float na, float nb, float ab) {
  return fmaf(-2.f, ab, na + nb);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s + a.b over four coordinates, in order (dot's sequence, four steps of it)
__device__ __forceinline__ float fma4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

template <int DP>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
#pragma unroll
  for (int k = 0; k < DP; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + k);
    dst[k] = v.x;
    dst[k + 1] = v.y;
    dst[k + 2] = v.z;
    dst[k + 3] = v.w;
  }
}

// N fixed-order block sums at once: an xor butterfly in each warp, then the
// warps in order; every thread gets the N sums
template <int N>
__device__ __forceinline__ void block_sums(double (&v)[N],
                                           double* warp_part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
  if (threadIdx.x % 32 == 0)
#pragma unroll
    for (int q = 0; q < N; ++q) warp_part[threadIdx.x / 32 * N + q] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) {
    double s = 0.0;
    for (int w = 0; w < kFwdWarps; ++w) s += warp_part[w * N + q];
    v[q] = s;
  }
  __syncthreads();
}

struct FwdArgs {
  const float* x;
  const float* y;
  const float* mask;
  int B, d;
  Alphas al;
  unsigned int* ticket;  // scratch[0]; 0 between launches
  double* part;          // scratch[1 ..]: 3 partials a block (xy, xx, yy)
  float* buf;            // out, n, |x_i|^2 [B], |y_i|^2 [B]
};

template <int DP>
__global__ void __launch_bounds__(kFwdThreads) mmd_fwd_kernel(FwdArgs a) {
  // x and y rows of tile ti, then of tile tj
  __shared__ __align__(16) float rows[4][kTile][kStride];
  __shared__ float norm[4][kTile];
  __shared__ float msk[2][kTile];
  __shared__ double warp_part[kFwdWarps * 4];
  __shared__ bool last;
  const int B = a.B, d = a.d;
  const int nt = (B + kTile - 1) / kTile;
  // block -> (ti, tj), ti <= tj, the upper triangle row by row
  int ti = 0, rest = blockIdx.x;
  while (rest >= nt - ti) {
    rest -= nt - ti;
    ++ti;
  }
  const int tj = ti + rest;
  const bool diag = ti == tj;

  // thread r < 4 kTile stages row r of the four tiles (zero past d and past
  // B) and forms its squared norm; the next 2 kTile threads stage the masks
  if (threadIdx.x < 4 * kTile) {
    const int which = threadIdx.x / kTile, r = threadIdx.x % kTile;
    const int row = ((which < 2) ? ti : tj) * kTile + r;
    const float* src =
        ((which & 1) ? a.y : a.x) + (size_t)min(row, B - 1) * d;
    float own[DP];
#pragma unroll
    for (int k = 0; k < DP; ++k) own[k] = (row < B && k < d) ? src[k] : 0.f;
#pragma unroll
    for (int k = 0; k < DP; k += 4)
      *reinterpret_cast<float4*>(rows[which][r] + k) =
          make_float4(own[k], own[k + 1], own[k + 2], own[k + 3]);
    const float nrm = dot<DP>(own, own);
    norm[which][r] = nrm;
    if (diag && which < 2 && row < B) a.buf[2 + which * B + row] = nrm;
  } else if (threadIdx.x < 6 * kTile) {
    const int side = threadIdx.x / kTile - 4, r = threadIdx.x % kTile;
    const int row = (side ? tj : ti) * kTile + r;
    msk[side][r] = row < B ? a.mask[row] : 0.f;
  }
  __syncthreads();

  // thread (i, j) takes the pair (i, j) of each of the four tile products:
  // xy (x_ti, y_tj), xy (x_tj, y_ti) off the diagonal, xx (x_ti, x_tj) and
  // yy (y_ti, y_tj), the last two only for j > i on the diagonal. Their four
  // dot products run side by side, each in dot's order.
  const int i = threadIdx.x % kTile, j = threadIdx.x / kTile;
  float dxy = 0.f, dyx = 0.f, dxx = 0.f, dyy = 0.f;
#pragma unroll
  for (int k = 0; k < DP; k += 4) {
    const float4 xi = ld4(rows[0][i] + k), ui = ld4(rows[2][i] + k);
    const float4 yi = ld4(rows[1][i] + k);
    const float4 vj = ld4(rows[3][j] + k), yj = ld4(rows[1][j] + k);
    const float4 uj = ld4(rows[2][j] + k);
    dxy = fma4(xi, vj, dxy);
    dyx = fma4(ui, yj, dyx);
    dxx = fma4(xi, uj, dxx);
    dyy = fma4(yi, vj, dyy);
  }
  const float mij = msk[0][i] * msk[1][j];
  const bool upper = !diag || j > i;
  double s[3];  // xy, xx, yy
  s[0] = (double)(rbf(sq_dist(norm[0][i], norm[3][j], dxy), a.al) * mij);
  if (!diag)
    s[0] += (double)(rbf(sq_dist(norm[2][i], norm[1][j], dyx), a.al) *
                     (msk[1][i] * msk[0][j]));
  const float kxx = rbf(sq_dist(norm[0][i], norm[2][j], dxx), a.al) * mij;
  const float kyy = rbf(sq_dist(norm[1][i], norm[3][j], dyy), a.al) * mij;
  s[1] = upper ? (double)kxx : 0.0;
  s[2] = upper ? (double)kyy : 0.0;
  block_sums<3>(s, warp_part);

  if (threadIdx.x == 0) {
    double* p = a.part + 3 * (size_t)blockIdx.x;
    p[0] = s[0];
    p[1] = s[1];
    p[2] = s[2];
    // release: the partials are visible before the ticket is taken; the
    // last block's acquire makes every block's partials visible to it
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(
        *a.ticket);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) ==
           gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: thread t adds blocks t, t + kFwdThreads, ... in order
  double m[4] = {0.0, 0.0, 0.0, 0.0};  // xy, xx, yy, n
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kFwdThreads)
#pragma unroll
    for (int q = 0; q < 3; ++q) m[q] += __ldcg(a.part + 3 * (size_t)b + q);
  for (int r = threadIdx.x; r < B; r += kFwdThreads)
    m[3] += (double)a.mask[r];
  block_sums<4>(m, warp_part);
  if (threadIdx.x == 0) {
    const double n = m[3];
    const double a00 = 1.0 / (n * (n - 1.0));
    const double a01 = -1.0 / (n * n);
    // the xx and yy partials cover the upper triangle: doubled, exactly
    a.buf[0] = (float)(2.0 * a01 * m[0] + a00 * (2.0 * m[1]) +
                       a00 * (2.0 * m[2]));
    a.buf[1] = (float)n;
    *a.ticket = 0u;
  }
}

struct BwdArgs {
  const float* x;
  const float* y;
  const float* mask;
  int B, d;
  Alphas al;
  const float* res;  // K1's buf: MMD^2, n, |x_i|^2 [B], |y_i|^2 [B]
  const float* g;
  float* dx;
  float* dy;
};

template <int DP>
__global__ void __launch_bounds__(kBwdThreads) mmd_bwd_kernel(BwdArgs a) {
  __shared__ __align__(16) float xs[kChunk][kStride];
  __shared__ __align__(16) float ys[kChunk][kStride];
  __shared__ float nxs[kChunk], nys[kChunk], ms[kChunk];
  const int B = a.B, d = a.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = blockIdx.x * kBwdWarps + warp;  // output row, of 2B
  const bool active = q < 2 * B;
  const int side = (q >= B) ? 1 : 0;  // 0: row r of dx, 1: row r of dy
  const int r = active ? q - side * B : 0;
  const float* self = side ? a.y : a.x;

  float own[DP];
#pragma unroll
  for (int k = 0; k < DP; ++k) own[k] = k < d ? self[(size_t)r * d + k] : 0.f;
  const float n = a.res[1];
  const float n_own = a.res[2 + side * B + r];
  const float mr = a.mask[r];
  const float g = *a.g;
  const float a00 = 1.f / (n * (n - 1.f));
  const float a01 = -1.f / (n * n);
  const float w_cross = g * 2.f * a01;
  const float w_self = g * a00;
  const bool work = active && mr != 0.f;  // a masked row's gradient is 0

  float acc[DP];
#pragma unroll
  for (int k = 0; k < DP; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < B; c0 += kChunk) {
    const int rows = min(kChunk, B - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < rows * DP; e += kBwdThreads) {
      const int j = e / DP, k = e % DP;
      const size_t at = (size_t)(c0 + j) * d + k;
      xs[j][k] = k < d ? a.x[at] : 0.f;
      ys[j][k] = k < d ? a.y[at] : 0.f;
    }
    for (int j = threadIdx.x; j < rows; j += kBwdThreads) {
      nxs[j] = a.res[2 + c0 + j];
      nys[j] = a.res[2 + B + c0 + j];
      ms[j] = a.mask[c0 + j];
    }
    __syncthreads();
    if (!work) continue;
    const float(*cross)[kStride] = side ? xs : ys;
    const float(*within)[kStride] = side ? ys : xs;
    const float* n_cross = side ? nxs : nys;
    const float* n_within = side ? nys : nxs;
    for (int j = lane; j < rows; j += 32) {
      const float mm = mr * ms[j];
      float c[DP], w[DP];
      load_row<DP>(c, cross[j]);
      load_row<DP>(w, within[j]);
      float dc = 0.f, dw = 0.f;  // the two dot products, each in dot's order
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        dc = fmaf(own[k], c[k], dc);
        dw = fmaf(own[k], w[k], dw);
      }
      // cross block: d d2(own, c_j) / d own = 2 (own - c_j)
      const float cc =
          2.f * w_cross * drbf(sq_dist(n_own, n_cross[j], dc), a.al) * mm;
      // within block, j != r: own appears as row and as column, hence
      // 4 (own - w_j). At j = r the term is 0, and adding 0 to acc leaves
      // its bits as skipping it would.
      const float cw =
          (c0 + j != r)
              ? 4.f * w_self * drbf(sq_dist(n_own, n_within[j], dw), a.al) *
                    mm
              : 0.f;
#pragma unroll
      for (int k = 0; k < DP; ++k) acc[k] += cc * (own[k] - c[k]);
#pragma unroll
      for (int k = 0; k < DP; ++k) acc[k] += cw * (own[k] - w[k]);
    }
  }
  if (!active) return;
  // R accumulators, a power of two, zero past DP
  constexpr int R = kMergedValues<DP>;
  float v[R];
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = k < DP ? acc[k] : 0.f;
  warp_reduce_scatter<R>(v, lane);
  // lane l holds the sum of coordinate e(l); the lanes 32 / R apart hold
  // each coordinate once
  constexpr int spread = 32 / R;
  const int e = lane / spread;
  float* out = side ? a.dy : a.dx;
  if (lane % spread == 0 && e < d) out[(size_t)r * d + e] = v[0];
}

Alphas make_alphas(float a0, float a1, float a2, float a3, int n) {
  Alphas al;
  al.a[0] = a0;
  al.a[1] = a1;
  al.a[2] = a2;
  al.a[3] = a3;
  al.n = n;
  return al;
}

bool bad_shape(int B, int d, int n_alphas) {
  return B < 1 || d < 1 || d > kMaxDim || n_alphas < 1 || n_alphas > kMaxAlphas;
}

}  // namespace

extern "C" {

const char* carel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int carel_mmd_max_dim() { return kMaxDim; }

int carel_mmd_max_alphas() { return kMaxAlphas; }

// K1's tile rows: for B rows it launches nt (nt + 1) / 2 blocks,
// nt = ceil(B / tile), and needs 1 + 3 blocks doubles of scratch.
int carel_mmd_tile_rows() { return kTile; }

// K1: buf = [MMD^2, n = sum(mask), |x_i|^2 [B], |y_i|^2 [B]], all of which
// K2 reads as its residuals. scratch holds the ticket (0 before and after the launch)
// and the partials. One launch on ``stream``; two streams must not run K1
// on one scratch at once.
int carel_mmd_fwd(const float* x, const float* y, const float* mask, int B,
                  int d, float a0, float a1, float a2, float a3, int n_alphas,
                  double* scratch, float* buf, void* stream) {
  if (bad_shape(B, d, n_alphas)) return (int)cudaErrorInvalidValue;
  const int nt = (B + kTile - 1) / kTile;
  FwdArgs args{x, y, mask, B, d, make_alphas(a0, a1, a2, a3, n_alphas),
               reinterpret_cast<unsigned int*>(scratch), scratch + 1, buf};
  const int grid = nt * (nt + 1) / 2;
#define CAREL_LAUNCH(DP) \
  mmd_fwd_kernel<DP><<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(args)
  CAREL_DISPATCH_DIM(d, CAREL_LAUNCH);
#undef CAREL_LAUNCH
  return (int)cudaGetLastError();
}

// K2: dx, dy [B, d] of g * MMD^2, with res = buf of K1 on the same inputs
// and g = *g_ptr read on the device.
int carel_mmd_bwd(const float* x, const float* y, const float* mask, int B,
                  int d, float a0, float a1, float a2, float a3, int n_alphas,
                  const float* res, const float* g_ptr, float* dx, float* dy,
                  void* stream) {
  if (bad_shape(B, d, n_alphas)) return (int)cudaErrorInvalidValue;
  BwdArgs args{x, y, mask, B, d, make_alphas(a0, a1, a2, a3, n_alphas), res,
               g_ptr, dx, dy};
  const int grid = (2 * B + kBwdWarps - 1) / kBwdWarps;
#define CAREL_LAUNCH(DP) \
  mmd_bwd_kernel<DP><<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(args)
  CAREL_DISPATCH_DIM(d, CAREL_LAUNCH);
#undef CAREL_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"

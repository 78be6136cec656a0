// Fused unbiased MMD^2 between two latent samples: forward (K1) and
// analytic backward (K2), for Hopper (sm_90a).
//
// Replaces carel_tpu/ops/pallas_pairwise.py: _mmd_fwd_kernel (forward, via
// _mmd_call_fwd) and _mmd_bwd_kernel (backward, via _mmd_core_bwd).
//
// What bounds it on this card: launch latency. At the training shape
// (B = 64 rows, d = 24) the statistic is about 3*B*B*(2d+4) ~ 0.6 MFLOP over
// ~12 KB of input, far below a microsecond at either the fp32 rate or the
// memory rate. So the design keeps few small blocks and no [B, B] buffer,
// and spends nothing on tiling or tensor cores:
//   K1  grid (row tiles, 3): blockIdx.y picks the Gram block (xy, xx, yy).
//       Each block sums the RBF kernel over its pairs in double and reduces
//       in a fixed tree to one partial; a one-thread pass adds the partials
//       in a fixed order. No float atomics, so the value repeats bit for bit.
//   K2  grid (B, 2): one block per output row of dx or dy rebuilds its row of
//       the three coefficient matrices on the fly and reduces across threads
//       in a fixed tree.
// d2 = |a|^2 + |b|^2 - 2 a.b in fp32 followed by abs, as the reference and
// the plain version compute it (not sum (a-b)^2), so sign(d2) in K2 agrees.
// Masked rows, and the diagonal of the within-sample blocks, are zeroed.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-5f;
constexpr int kMaxAlphas = 4;
constexpr int kMaxDim = 32;
constexpr int kFwdThreads = 256;
constexpr int kFwdRows = 8;  // rows of the first sample per K1 block
constexpr int kBwdThreads = 128;

struct Alphas {
  float a[kMaxAlphas];
  int n;
};

// d2(a, b) is bitwise symmetric: fp addition and multiplication commute.
__device__ __forceinline__ float sq_dist(const float* a, const float* b,
                                         int d) {
  float na = 0.f, nb = 0.f, dot = 0.f;
  for (int k = 0; k < d; ++k) {
    na = fmaf(a[k], a[k], na);
    nb = fmaf(b[k], b[k], nb);
    dot = fmaf(a[k], b[k], dot);
  }
  return na + nb - 2.f * dot;
}

// sum_a exp(-a * (eps + |d2|))
__device__ __forceinline__ float rbf(float d2, const Alphas& al) {
  const float pd2 = kEps + fabsf(d2);
  float k = 0.f;
  for (int i = 0; i < al.n; ++i) k += expf(-al.a[i] * pd2);
  return k;
}

// d rbf / d d2 = sign(d2) * sum_a (-a) exp(-a * (eps + |d2|))
__device__ __forceinline__ float drbf(float d2, const Alphas& al) {
  const float pd2 = kEps + fabsf(d2);
  float c = 0.f;
  for (int i = 0; i < al.n; ++i) c += -al.a[i] * expf(-al.a[i] * pd2);
  const float sgn = (d2 > 0.f) ? 1.f : ((d2 < 0.f) ? -1.f : 0.f);
  return c * sgn;
}

__global__ void mmd_fwd_partial(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ mask, int B, int d,
                                Alphas al, double* __restrict__ partial) {
  __shared__ double red[kFwdThreads];
  const int blk = blockIdx.y;  // 0 = xy, 1 = xx, 2 = yy
  const float* A = (blk == 2) ? y : x;
  const float* C = (blk == 1) ? x : y;
  const int row0 = blockIdx.x * kFwdRows;
  const int rows = min(kFwdRows, B - row0);
  double acc = 0.0;
  for (int p = threadIdx.x; p < rows * B; p += blockDim.x) {
    const int i = row0 + p / B;
    const int j = p % B;
    if (blk != 0 && i == j) continue;
    const float k = rbf(sq_dist(A + (size_t)i * d, C + (size_t)j * d, d), al);
    acc += (double)(k * (mask[i] * mask[j]));
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kFwdThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blk * gridDim.x + blockIdx.x] = red[0];
}

__global__ void mmd_fwd_combine(const double* __restrict__ partial, int tiles,
                                const float* __restrict__ mask, int B,
                                float* __restrict__ out,
                                float* __restrict__ n_out) {
  if (threadIdx.x != 0) return;
  double n = 0.0;
  for (int i = 0; i < B; ++i) n += mask[i];
  double s[3] = {0.0, 0.0, 0.0};
  for (int b = 0; b < 3; ++b)
    for (int t = 0; t < tiles; ++t) s[b] += partial[b * tiles + t];
  const double a00 = 1.0 / (n * (n - 1.0));
  const double a01 = -1.0 / (n * n);
  out[0] = (float)(2.0 * a01 * s[0] + a00 * s[1] + a00 * s[2]);
  n_out[0] = (float)n;
}

__global__ void mmd_bwd_rows(const float* __restrict__ x,
                             const float* __restrict__ y,
                             const float* __restrict__ mask, int B, int d,
                             Alphas al, const float* __restrict__ n_ptr,
                             const float* __restrict__ g_ptr,
                             float* __restrict__ dx, float* __restrict__ dy) {
  __shared__ float own[kMaxDim];
  __shared__ float red[kBwdThreads][kMaxDim + 1];
  const int r = blockIdx.x;
  const int side = blockIdx.y;  // 0: row r of dx, 1: row r of dy
  const float* self = side == 0 ? x : y;
  const float* cross = side == 0 ? y : x;
  if (threadIdx.x < d) own[threadIdx.x] = self[(size_t)r * d + threadIdx.x];
  __syncthreads();

  const float n = *n_ptr;
  const float g = *g_ptr;
  const float a00 = 1.f / (n * (n - 1.f));
  const float a01 = -1.f / (n * n);
  const float w_cross = g * 2.f * a01;
  const float w_self = g * a00;
  const float mr = mask[r];

  float acc[kMaxDim];
#pragma unroll
  for (int k = 0; k < kMaxDim; ++k) acc[k] = 0.f;

  for (int j = threadIdx.x; j < B; j += blockDim.x) {
    const float mm = mr * mask[j];
    // cross block: d d2(own, c_j) / d own = 2 (own - c_j)
    const float* cj = cross + (size_t)j * d;
    const float cc = 2.f * w_cross * drbf(sq_dist(own, cj, d), al) * mm;
#pragma unroll
    for (int k = 0; k < kMaxDim; ++k)
      if (k < d) acc[k] += cc * (own[k] - cj[k]);
    if (j != r) {
      // within block: own appears as row and as column, hence 4 (own - s_j)
      const float* sj = self + (size_t)j * d;
      const float cs = 4.f * w_self * drbf(sq_dist(own, sj, d), al) * mm;
#pragma unroll
      for (int k = 0; k < kMaxDim; ++k)
        if (k < d) acc[k] += cs * (own[k] - sj[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxDim; ++k)
    if (k < d) red[threadIdx.x][k] = acc[k];
  __syncthreads();
  for (int s = kBwdThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int k = 0; k < d; ++k) red[threadIdx.x][k] += red[threadIdx.x + s][k];
    __syncthreads();
  }
  float* out = side == 0 ? dx : dy;
  if (threadIdx.x < d) out[(size_t)r * d + threadIdx.x] = red[0][threadIdx.x];
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

// Number of double partial sums K1 needs as scratch for B rows.
int carel_mmd_partials(int B) { return 3 * ((B + kFwdRows - 1) / kFwdRows); }

int carel_mmd_max_dim() { return kMaxDim; }

int carel_mmd_max_alphas() { return kMaxAlphas; }

// K1: out[0] = unbiased MMD^2, n_out[0] = sum(mask).
int carel_mmd_fwd(const float* x, const float* y, const float* mask, int B,
                  int d, float a0, float a1, float a2, float a3, int n_alphas,
                  double* partial, float* out, float* n_out, void* stream) {
  if (bad_shape(B, d, n_alphas)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Alphas al = make_alphas(a0, a1, a2, a3, n_alphas);
  const int tiles = (B + kFwdRows - 1) / kFwdRows;
  mmd_fwd_partial<<<dim3(tiles, 3), kFwdThreads, 0, s>>>(x, y, mask, B, d, al,
                                                        partial);
  mmd_fwd_combine<<<1, 32, 0, s>>>(partial, tiles, mask, B, out, n_out);
  return (int)cudaGetLastError();
}

// K2: dx, dy of g * MMD^2, with n = *n_ptr and g = *g_ptr read on the device.
int carel_mmd_bwd(const float* x, const float* y, const float* mask, int B,
                  int d, float a0, float a1, float a2, float a3, int n_alphas,
                  const float* n_ptr, const float* g_ptr, float* dx, float* dy,
                  void* stream) {
  if (bad_shape(B, d, n_alphas)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Alphas al = make_alphas(a0, a1, a2, a3, n_alphas);
  mmd_bwd_rows<<<dim3(B, 2), kBwdThreads, 0, s>>>(x, y, mask, B, d, al, n_ptr,
                                                  g_ptr, dx, dy);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
//   K3  each block owns one chunk of kFwdCols columns, keeps W's chunk
//       (transposed, padded against bank conflicts) and kRows rows of h in
//       shared memory, and writes per-row partials: (max, sumexp, sum z) in
//       sweep 1, (sum log1p(-p), sum p/(1-p)) in sweep 2. A one-thread-per-
//       row pass merges the partials of all chunks in a fixed order.
//   K4  each block owns kBwdChunks chunks of kBwdCols columns, rebuilds z and
//       G = dL/dz for them, writes dW and db of its own columns exactly, and
//       accumulates a partial dh [B, D] of its own; a last pass adds the
//       partial dh of all blocks in a fixed order.
// No float atomics anywhere, so every output repeats bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // batch rows per pass over a chunk
constexpr int kFwdCols = 128;  // V columns per K3 block
constexpr int kBwdCols = 64;   // V columns per K4 chunk
constexpr int kBwdChunks = 2;  // K4 chunks per block
constexpr int kMaxD = 64;
constexpr float kNeg = -1e30f;
constexpr float kPMax = 1.f - 1e-7f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// PASS 1: partial[(chunk * B + row) * 3 + {0,1,2}] = max, sumexp, sum z.
// PASS 2: partial[(chunk * B + row) * 2 + {0,1}] = sum log1p(-p), sum p/(1-p).
template <int PASS>
__global__ void __launch_bounds__(kThreads)
    bow_sweep(const float* __restrict__ h, const float* __restrict__ W,
              const float* __restrict__ b, int B, int D, int V,
              const float* __restrict__ lse, float* __restrict__ partial) {
  extern __shared__ float smem[];
  constexpr int TV = kFwdCols;
  constexpr int Q = TV / 32;
  const int ld = TV + 1;
  float* Ws = smem;           // [D][ld]
  float* hs = Ws + D * ld;    // [kRows][D]
  float* bs = hs + kRows * D; // [TV]
  const int chunk = blockIdx.x;
  const int v0 = chunk * TV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  load_w_chunk(W, b, D, V, v0, TV, Ws, bs);

  for (int r0 = 0; r0 < B; r0 += kRows) {
    const int rows = min(kRows, B - r0);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * D; e += blockDim.x)
      hs[e] = h[(size_t)r0 * D + e];
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      float z[Q];
      row_logits<Q>(hs, Ws, bs, D, ld, r, lane, z);
      const size_t row = (size_t)chunk * B + r0 + r;
      if (PASS == 1) {
        float m = kNeg;
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (v0 + lane + 32 * q < V) m = fmaxf(m, z[q]);
        m = warp_max(m);
        float se = 0.f, sz = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (v0 + lane + 32 * q < V) {
            se += expf(z[q] - m);
            sz += z[q];
          }
        }
        se = warp_sum(se);
        sz = warp_sum(sz);
        if (lane == 0) {
          partial[row * 3 + 0] = m;
          partial[row * 3 + 1] = se;
          partial[row * 3 + 2] = sz;
        }
      } else {
        const float L = lse[r0 + r];
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (v0 + lane + 32 * q < V) {
            const float p = fminf(expf(z[q] - L), kPMax);
            s1 += log1pf(-p);
            s2 += p / (1.f - p);
          }
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
          partial[row * 2 + 0] = s1;
          partial[row * 2 + 1] = s2;
        }
      }
    }
  }
}

// out is [4, B]: lse, S_z (written here), S_log1mp, Qp (written by combine2).
__global__ void bow_combine1(const float* __restrict__ partial, int chunks,
                             int B, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  float m = kNeg;
  for (int c = 0; c < chunks; ++c) m = fmaxf(m, partial[((size_t)c * B + r) * 3]);
  double l = 0.0, sz = 0.0;
  for (int c = 0; c < chunks; ++c) {
    const float* p = partial + ((size_t)c * B + r) * 3;
    l += (double)p[1] * exp((double)p[0] - (double)m);
    sz += p[2];
  }
  out[r] = m + (float)log(l);
  out[B + r] = (float)sz;
}

__global__ void bow_combine2(const float* __restrict__ partial, int chunks,
                             int B, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  double s1 = 0.0, s2 = 0.0;
  for (int c = 0; c < chunks; ++c) {
    const float* p = partial + ((size_t)c * B + r) * 2;
    s1 += p[0];
    s2 += p[1];
  }
  out[2 * B + r] = (float)s1;
  out[3 * B + r] = (float)s2;
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

size_t sweep_smem(int D) {
  return sizeof(float) * ((size_t)D * (kFwdCols + 1) + kRows * D + kFwdCols);
}

size_t bwd_smem(int D) {
  return sizeof(float) * ((size_t)D * (kBwdCols + 1) + kRows * D +
                          kRows * (kBwdCols + 1) + kBwdCols + 5 * kRows);
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

// Floats of scratch K3 needs: the sweep-1 partials (3 per row and chunk),
// reused by sweep 2.
long long carel_bow_fwd_scratch(int B, int V) {
  return 3LL * B * ((V + kFwdCols - 1) / kFwdCols);
}

// Floats of scratch K4 needs: one partial dh [B, D] per block.
long long carel_bow_bwd_scratch(int B, int D, int V) {
  const int nchunk = (V + kBwdCols - 1) / kBwdCols;
  const int blocks = (nchunk + kBwdChunks - 1) / kBwdChunks;
  return (long long)blocks * B * D;
}

// K3: out [4, B] = lse, S_z, S_log1mp, Qp per row.
int carel_bow_fwd(const float* h, const float* W, const float* b, int B, int D,
                  int V, float* scratch, float* out, void* stream) {
  if (bad_shape(B, D, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (V + kFwdCols - 1) / kFwdCols;
  const size_t smem = sweep_smem(D);
  cudaError_t err = allow_smem((const void*)bow_sweep<1>, smem);
  if (err == cudaSuccess) err = allow_smem((const void*)bow_sweep<2>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rb = (B + 127) / 128;
  bow_sweep<1><<<chunks, kThreads, smem, s>>>(h, W, b, B, D, V, nullptr,
                                              scratch);
  bow_combine1<<<rb, 128, 0, s>>>(scratch, chunks, B, out);
  bow_sweep<2><<<chunks, kThreads, smem, s>>>(h, W, b, B, D, V, out, scratch);
  bow_combine2<<<rb, 128, 0, s>>>(scratch, chunks, B, out);
  return (int)cudaGetLastError();
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

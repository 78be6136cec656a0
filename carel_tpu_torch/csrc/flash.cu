// Flash attention with a segment mask, forward (K7) and backward (K8: dK and
// dV, K9: dQ with the row term delta = sum(o * do) as its prologue), for
// Hopper (sm_90a).
//
// Replaces the stock Pallas TPU flash attention that carel_tpu's
// SelfAttention calls under attention_impl="flash"
// (carel_tpu/models/encoder.py:61; jax/experimental/pallas/ops/tpu/
// flash_attention.py): K7 _flash_attention_impl / _flash_attention_kernel,
// K8 _flash_attention_bwd_dkv / _flash_attention_dkv_kernel, K9
// _flash_attention_bwd_dq / _flash_attention_dq_kernel and the di sum of
// _flash_attention_bwd.
//
// What it computes, as the stock kernel does:
//   s = (q . k^T) * sm_scale + (seg[i] == seg[j] ? 0 : -0.7 * FLT_MAX)
//   o = softmax(s) . v, by online softmax over tiles of keys: the running
//   row max m and row sum l, p = exp(s - m) rounded to v's type before the
//   product with v, fp32 sums throughout, o = acc / l in the input type;
//   lse = m + log(l) per row is kept for the backward.
//   backward: p = exp(s - lse); dv = p^T . do; dp = do . v^T;
//   ds = (dp - delta) * p * sm_scale; dk = ds^T . q; dq = ds . k, with p and
//   ds rounded to the input type before their products and fp32 sums.
// The mask is a segment mask: token i sees token j iff their ids are equal,
// so pad queries see pad keys and every row has l > 0 (no NaN on an all-pad
// row). There is no dropout on the probabilities.
//
// What bounds it on this card: bytes. At [64, 12, 96, 64] bf16 the forward
// reads q, k, v and writes o once, 37.7 MB (0.011 ms at 3.35 TB/s), against
// 1.8 GFLOP (0.002 ms at the bf16 tensor-core rate).
//
// Which kernel runs. bf16 inputs: K7, K8 and K9 are the tensor-core kernels
// of flash_mma.cu (the entry points below send them there). fp32 inputs: all
// three are the kernels below, whose products are fp32 FMAs on the CUDA
// cores from fp32 tiles in shared memory. fp32 stays on the CUDA cores
// because the tensor cores have no full-fp32 product (TF32 keeps three
// digits) and do not round each addition as fmaf does; the fp32 results are
// held to 1e-5 (output) and 1e-4 (gradients). None of the kernels below
// reaches the bytes bound.
//
// Design of the kernels below:
//   - one block of 64 threads per (batch, head, tile of 32 rows); a loop
//     over tiles of 32 rows of the other side inside the block replaces the
//     TPU grid's sequential dimension; each thread holds a 4 x 4 piece of
//     the 32 x 32 score tile and a 4 x (hd / 8) piece of the output tile in
//     registers; probabilities go through shared memory to the second
//     product and never to device memory;
//   - q, k, v, o and the gradients are addressed by (batch, head, row)
//     strides with a contiguous last dimension, so the packed projection
//     [B, L, 3, h, hd] is read in place, the context is written as
//     [B, L, h * hd] and the gradient as one packed buffer;
//   - any L: the ragged edge of the last tile is masked here;
//   - no float atomics: a dQ tile is owned by a q-tile block that loops
//     over the keys (K9), a dK/dV tile by a kv-tile block that loops over
//     the queries (K8), every sum in a fixed order, so two runs give the
//     same bits.
// Head dims taken: 16, 32, 64, 128.

#include <cuda_runtime.h>

#include <cfloat>
#include <math_constants.h>

namespace {

constexpr int kTile = 32;     // rows of q and of k/v per tile
constexpr int kThreads = 64;  // 8 x 8 threads, 4 x 4 scores each
constexpr int kPad = 4;       // floats of row padding in shared memory
constexpr int kPLd = kTile + kPad;
constexpr float kMaskValue = (float)(-0.7 * (double)FLT_MAX);

struct Strides {
  long long b, h, l;  // elements between batches, heads and rows
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

// Rows row0 .. row0 + kTile of a [L, HD] slice (row stride in elements) into
// an fp32 tile [kTile][HD + kPad]; rows past L are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int L) {
  constexpr int V4 = HD / 4, LD = HD + kPad;
  for (int idx = threadIdx.x; idx < kTile * V4; idx += kThreads) {
    const int r = idx / V4, c4 = idx % V4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L)
      val = Io<T>::load4(src + (long long)(row0 + r) * row_stride + c4 * 4);
    *reinterpret_cast<float4*>(dst + r * LD + c4 * 4) = val;
  }
}

// The fp32 tile back to rows row0 .. of dst, rounded to T; rows past L are
// not written.
template <typename T, int HD>
__device__ __forceinline__ void store_tile(T* dst, long long row_stride,
                                           const float* src, int row0,
                                           int L) {
  constexpr int V4 = HD / 4, LD = HD + kPad;
  for (int idx = threadIdx.x; idx < kTile * V4; idx += kThreads) {
    const int r = idx / V4, c4 = idx % V4;
    if (row0 + r < L)
      Io<T>::store4(dst + (long long)(row0 + r) * row_stride + c4 * 4,
                    *reinterpret_cast<const float4*>(src + r * LD + c4 * 4));
  }
}

// out[i][j] = sum_d a[ty * 4 + i][d] * b[tx + 8 * j][d] over two tiles.
template <int HD>
__device__ __forceinline__ void tile_dot(const float* sa, const float* sb,
                                         int ty, int tx, float (&out)[4][4]) {
  constexpr int LD = HD + kPad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(sa + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(sb + (tx + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = out[i][j];
        acc = fmaf(a[i].x, b[j].x, acc);
        acc = fmaf(a[i].y, b[j].y, acc);
        acc = fmaf(a[i].z, b[j].z, acc);
        acc = fmaf(a[i].w, b[j].w, acc);
        out[i][j] = acc;
      }
  }
}

// Sum or max over the 8 threads (tx) that share a row group.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

// acc[i][c] += sum_j w[ty * 4 + i][j] * t[j][tx + 8 * c]: a [kTile][kPLd]
// weight tile times a [kTile][HD + kPad] tile.
template <int HD>
__device__ __forceinline__ void tile_accumulate(const float* sw,
                                                const float* st, int ty,
                                                int tx,
                                                float (&acc)[4][HD / 8]) {
  constexpr int LD = HD + kPad, NC = HD / 8;
  for (int j = 0; j < kTile; j += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const float4*>(sw + (ty * 4 + i) * kPLd + j);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float t0 = st[(j + 0) * LD + tx + 8 * c];
      const float t1 = st[(j + 1) * LD + tx + 8 * c];
      const float t2 = st[(j + 2) * LD + tx + 8 * c];
      const float t3 = st[(j + 3) * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = acc[i][c];
        a = fmaf(w[i].x, t0, a);
        a = fmaf(w[i].y, t1, a);
        a = fmaf(w[i].z, t2, a);
        a = fmaf(w[i].w, t3, a);
        acc[i][c] = a;
      }
    }
  }
}

// The thread's 4 x (HD / 8) piece into an fp32 tile.
template <int HD>
__device__ __forceinline__ void stage(float* dst, int ty, int tx,
                                      const float (&acc)[4][HD / 8]) {
  constexpr int LD = HD + kPad, NC = HD / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dst[(ty * 4 + i) * LD + tx + 8 * c] = acc[i][c];
}

struct BlockIndex {
  int tile, head, batch, bh;
};

__device__ __forceinline__ BlockIndex block_index(int L, int h) {
  const int tiles = (L + kTile - 1) / kTile;
  BlockIndex ix;
  ix.tile = blockIdx.x % tiles;
  ix.bh = blockIdx.x / tiles;
  ix.head = ix.bh % h;
  ix.batch = ix.bh / h;
  return ix;
}

// K7: o and lse for one tile of queries.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     T* __restrict__ o, float* __restrict__ lse, int h, int L,
                     Strides qs, Strides os, float scale) {
  constexpr int LD = HD + kPad, NC = HD / 8;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sp = sv + kTile * LD;
  int* sseg = reinterpret_cast<int*>(sp + kTile * kPLd);

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const BlockIndex ix = block_index(L, h);
  const int q0 = ix.tile * kTile;
  const long long base = ix.batch * qs.b + ix.head * qs.h;
  const int* seg_b = seg + (long long)ix.batch * L;

  load_tile<T, HD>(sq, q + base, qs.l, q0, L);
  int segq[4];
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    segq[i] = row < L ? seg_b[row] : 0;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the previous tile's products are done
    load_tile<T, HD>(sk, k + base, qs.l, k0, L);
    load_tile<T, HD>(sv, v + base, qs.l, k0, L);
    if (threadIdx.x < kTile)
      sseg[threadIdx.x] = k0 + threadIdx.x < L ? seg_b[k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[4][4];
    tile_dot<HD>(sq, sk, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 8 * j;
        if (k0 + col < L) {
          s[i][j] = s[i][j] * scale + (sseg[col] == segq[i] ? 0.f : kMaskValue);
          mt = fmaxf(mt, s[i][j]);
        } else {
          s[i][j] = -CUDART_INF_F;  // past the ragged edge: p = 0
        }
      }
      mt = row_max(mt);  // finite: key k0 is inside L
      const float alpha = expf(m[i] - mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mt);
        rs += p;
        sp[(ty * 4 + i) * kPLd + tx + 8 * j] = Io<T>::round(p);
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mt;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_accumulate<HD>(sp, sv, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] *= inv;
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < L)
      lse[(long long)ix.bh * L + row] = m[i] + logf(l[i]);
  }
  stage<HD>(sq, ty, tx, acc);  // sq was last read before the loop's last sync
  __syncthreads();
  store_tile<T, HD>(o + ix.batch * os.b + ix.head * os.h, os.l, sq, q0, L);
}

// The probability and the score gradient of one entry, from the raw dot
// products, as the stock backward forms them.
struct PDs {
  float p, ds;
};

__device__ __forceinline__ PDs p_and_ds(float s, float dp, bool same_segment,
                                        bool inside, float lse, float delta,
                                        float scale) {
  PDs r;
  r.p = inside
            ? expf(s * scale + (same_segment ? 0.f : kMaskValue) - lse)
            : 0.f;
  r.ds = ((dp - delta) * r.p) * scale;
  return r;
}

// K9: delta = sum(o * do) per row (written for K8), then dq for one tile of
// queries.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ seg,
                        const T* __restrict__ o, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq, int h,
                        int L, Strides qs, Strides os, Strides gs, Strides ds,
                        float scale) {
  constexpr int LD = HD + kPad, NC = HD / 8;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sdo = sq + kTile * LD;
  float* sk = sdo + kTile * LD;
  float* sv = sk + kTile * LD;
  float* sds = sv + kTile * LD;
  int* sseg = reinterpret_cast<int*>(sds + kTile * kPLd);

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const BlockIndex ix = block_index(L, h);
  const int q0 = ix.tile * kTile;
  const long long base = ix.batch * qs.b + ix.head * qs.h;
  const int* seg_b = seg + (long long)ix.batch * L;

  load_tile<T, HD>(sq, q + base, qs.l, q0, L);
  load_tile<T, HD>(sdo, dout + ix.batch * gs.b + ix.head * gs.h, gs.l, q0, L);
  load_tile<T, HD>(sk, o + ix.batch * os.b + ix.head * os.h, os.l, q0, L);
  __syncthreads();

  int segq[4];
  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = q0 + r;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      part = fmaf(sk[r * LD + tx + 8 * c], sdo[r * LD + tx + 8 * c], part);
    delta_r[i] = row_sum(part);
    segq[i] = row < L ? seg_b[row] : 0;
    lse_r[i] = row < L ? lse[(long long)ix.bh * L + row] : 0.f;
    if (tx == 0 && row < L) delta[(long long)ix.bh * L + row] = delta_r[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the o tile, or the previous tile's products, are done
    load_tile<T, HD>(sk, k + base, qs.l, k0, L);
    load_tile<T, HD>(sv, v + base, qs.l, k0, L);
    if (threadIdx.x < kTile)
      sseg[threadIdx.x] = k0 + threadIdx.x < L ? seg_b[k0 + threadIdx.x] : 0;
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<HD>(sq, sk, ty, tx, s);
    tile_dot<HD>(sdo, sv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 8 * j;
        const bool inside = k0 + col < L && q0 + ty * 4 + i < L;
        const PDs r = p_and_ds(s[i][j], dp[i][j], sseg[col] == segq[i], inside,
                               lse_r[i], delta_r[i], scale);
        sds[(ty * 4 + i) * kPLd + col] = Io<T>::round(r.ds);
      }
    __syncthreads();
    tile_accumulate<HD>(sds, sk, ty, tx, acc);
  }

  stage<HD>(sq, ty, tx, acc);  // sq was last read before the loop's last sync
  __syncthreads();
  store_tile<T, HD>(dq + ix.batch * ds.b + ix.head * ds.h, ds.l, sq, q0, L);
}

// K8: dk and dv for one tile of keys, looping over the tiles of queries.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ seg,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int h, int L, Strides qs,
                         Strides gs, Strides ds, float scale) {
  constexpr int LD = HD + kPad, NC = HD / 8;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + kTile * LD;
  float* sq = sv + kTile * LD;
  float* sdo = sq + kTile * LD;
  float* sp = sdo + kTile * LD;
  float* sds = sp + kTile * kPLd;
  float* slse = sds + kTile * kPLd;
  float* sdelta = slse + kTile;
  int* ssegq = reinterpret_cast<int*>(sdelta + kTile);

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const BlockIndex ix = block_index(L, h);
  const int k0 = ix.tile * kTile;
  const long long base = ix.batch * qs.b + ix.head * qs.h;
  const long long gbase = ix.batch * gs.b + ix.head * gs.h;
  const int* seg_b = seg + (long long)ix.batch * L;

  load_tile<T, HD>(sk, k + base, qs.l, k0, L);
  load_tile<T, HD>(sv, v + base, qs.l, k0, L);
  int segk[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = k0 + tx + 8 * j;
    segk[j] = col < L ? seg_b[col] : 0;
  }
  // this thread's piece of dk and dv: key rows ty * 4 + jj, columns tx + 8 c
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[jj][c] = dv_acc[jj][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();  // the previous tile's products are done
    load_tile<T, HD>(sq, q + base, qs.l, q0, L);
    load_tile<T, HD>(sdo, dout + gbase, gs.l, q0, L);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const bool in = row < L;
      slse[threadIdx.x] = in ? lse[(long long)ix.bh * L + row] : 0.f;
      sdelta[threadIdx.x] = in ? delta[(long long)ix.bh * L + row] : 0.f;
      ssegq[threadIdx.x] = in ? seg_b[row] : 0;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<HD>(sq, sk, ty, tx, s);
    tile_dot<HD>(sdo, sv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, col = tx + 8 * j;
        const bool inside = k0 + col < L && q0 + r < L;
        const PDs e = p_and_ds(s[i][j], dp[i][j], segk[j] == ssegq[r], inside,
                               slse[r], sdelta[r], scale);
        sp[r * kPLd + col] = Io<T>::round(e.p);
        sds[r * kPLd + col] = Io<T>::round(e.ds);
      }
    __syncthreads();

    // dv[j][c] += sum_i p[i][j] do[i][c]; dk[j][c] += sum_i ds[i][j] q[i][c]
    for (int i = 0; i < kTile; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(sp + i * kPLd + ty * 4);
      const float4 d4 =
          *reinterpret_cast<const float4*>(sds + i * kPLd + ty * 4);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float g = sdo[i * LD + tx + 8 * c];
        const float qq = sq[i * LD + tx + 8 * c];
        dv_acc[0][c] = fmaf(p4.x, g, dv_acc[0][c]);
        dv_acc[1][c] = fmaf(p4.y, g, dv_acc[1][c]);
        dv_acc[2][c] = fmaf(p4.z, g, dv_acc[2][c]);
        dv_acc[3][c] = fmaf(p4.w, g, dv_acc[3][c]);
        dk_acc[0][c] = fmaf(d4.x, qq, dk_acc[0][c]);
        dk_acc[1][c] = fmaf(d4.y, qq, dk_acc[1][c]);
        dk_acc[2][c] = fmaf(d4.z, qq, dk_acc[2][c]);
        dk_acc[3][c] = fmaf(d4.w, qq, dk_acc[3][c]);
      }
    }
  }

  __syncthreads();  // the last sums read sq and sdo
  stage<HD>(sq, ty, tx, dk_acc);
  stage<HD>(sdo, ty, tx, dv_acc);
  __syncthreads();
  const long long dbase = ix.batch * ds.b + ix.head * ds.h;
  store_tile<T, HD>(dk + dbase, ds.l, sq, k0, L);
  store_tile<T, HD>(dv + dbase, ds.l, sdo, k0, L);
}

constexpr size_t tile_bytes(int hd, int wide, int square, int vectors) {
  return (size_t)(wide * kTile * (hd + kPad) + square * kTile * kPLd +
                  vectors * kTile) * sizeof(float);
}

struct Shape {
  int B, h, L;
};

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int blocks(const Shape& sh) {
  return sh.B * sh.h * ((sh.L + kTile - 1) / kTile);
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg,
               void* o, float* lse, Shape sh, Strides qs, Strides os,
               float scale, cudaStream_t stream) {
  constexpr size_t bytes = tile_bytes(HD, 3, 1, 1);
  const cudaError_t e = allow_shared(flash_fwd_kernel<T, HD>, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<T, HD><<<blocks(sh), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(o), lse, sh.h, sh.L, qs,
      os, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd_dq(const void* q, const void* k, const void* v, const int* seg,
                  const void* o, const void* dout, const float* lse,
                  float* delta, void* dq, Shape sh, Strides qs, Strides os,
                  Strides gs, Strides ds, float scale, cudaStream_t stream) {
  constexpr size_t bytes = tile_bytes(HD, 4, 1, 1);
  const cudaError_t e = allow_shared(flash_bwd_dq_kernel<T, HD>, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, HD><<<blocks(sh), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sh.h,
      sh.L, qs, os, gs, ds, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_bwd_dkv(const void* q, const void* k, const void* v, const int* seg,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, Shape sh, Strides qs, Strides gs,
                   Strides ds, float scale, cudaStream_t stream) {
  constexpr size_t bytes = tile_bytes(HD, 4, 2, 3);
  const cudaError_t e = allow_shared(flash_bwd_dkv_kernel<T, HD>, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_kernel<T, HD><<<blocks(sh), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sh.h, sh.L, qs, gs, ds, scale);
  return (int)cudaGetLastError();
}

bool takes_head_dim(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 128;
}

bool bad_shape(const Shape& sh, int hd) {
  return sh.B < 1 || sh.h < 1 || sh.L < 1 || !takes_head_dim(hd);
}

// Calls LAUNCH<T, HD>(args...) for the head dim.
#define CAREL_FLASH_DISPATCH(LAUNCH, T, ...)                \
  switch (hd) {                                             \
    case 16: return LAUNCH<T, 16>(__VA_ARGS__);             \
    case 32: return LAUNCH<T, 32>(__VA_ARGS__);             \
    case 64: return LAUNCH<T, 64>(__VA_ARGS__);             \
    default: return LAUNCH<T, 128>(__VA_ARGS__);            \
  }

}  // namespace

extern "C" {

// K7, K8 and K9 for bf16 inputs: flash_mma.cu.
int carel_flash_fwd_bf16(const void* q, const void* k, const void* v,
                         const int* seg, void* o, float* lse, int B, int h,
                         int L, int hd, long long q_sb, long long q_sh,
                         long long q_sl, long long o_sb, long long o_sh,
                         long long o_sl, float scale, void* stream);
int carel_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                             const int* seg, const void* dout,
                             const float* lse, const float* delta, void* dk,
                             void* dv, int B, int h, int L, int hd,
                             long long q_sb, long long q_sh, long long q_sl,
                             long long g_sb, long long g_sh, long long g_sl,
                             long long d_sb, long long d_sh, long long d_sl,
                             float scale, void* stream);
int carel_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                            const int* seg, const void* o, const void* dout,
                            const float* lse, float* delta, void* dq, int B,
                            int h, int L, int hd, long long q_sb,
                            long long q_sh, long long q_sl, long long o_sb,
                            long long o_sh, long long o_sl, long long g_sb,
                            long long g_sh, long long g_sl, long long d_sb,
                            long long d_sh, long long d_sl, float scale,
                            void* stream);

int carel_flash_takes_head_dim(int hd) { return takes_head_dim(hd) ? 1 : 0; }

// K7. q, k, v share one stride triple (elements between batches, heads and
// rows; the last dimension is contiguous), o has its own; seg is int32
// [B, L], lse fp32 [B, h, L].
int carel_flash_fwd(const void* q, const void* k, const void* v,
                    const int* seg, void* o, float* lse, int B, int h, int L,
                    int hd, long long q_sb, long long q_sh, long long q_sl,
                    long long o_sb, long long o_sh, long long o_sl,
                    float scale, int is_bf16, void* stream) {
  const Shape sh = {B, h, L};
  if (bad_shape(sh, hd)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return carel_flash_fwd_bf16(q, k, v, seg, o, lse, B, h, L, hd, q_sb, q_sh,
                                q_sl, o_sb, o_sh, o_sl, scale, stream);
  const Strides qs = {q_sb, q_sh, q_sl}, os = {o_sb, o_sh, o_sl};
  CAREL_FLASH_DISPATCH(launch_fwd, float, q, k, v, seg, o, lse, sh, qs, os,
                       scale, (cudaStream_t)stream);
}

// K9. Writes delta fp32 [B, h, L] (read by K8) and dq; do and dq have their
// own stride triples.
int carel_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const int* seg, const void* o, const void* dout,
                       const float* lse, float* delta, void* dq, int B, int h,
                       int L, int hd, long long q_sb, long long q_sh,
                       long long q_sl, long long o_sb, long long o_sh,
                       long long o_sl, long long g_sb, long long g_sh,
                       long long g_sl, long long d_sb, long long d_sh,
                       long long d_sl, float scale, int is_bf16,
                       void* stream) {
  const Shape sh = {B, h, L};
  if (bad_shape(sh, hd)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return carel_flash_bwd_dq_bf16(q, k, v, seg, o, dout, lse, delta, dq, B, h,
                                   L, hd, q_sb, q_sh, q_sl, o_sb, o_sh, o_sl,
                                   g_sb, g_sh, g_sl, d_sb, d_sh, d_sl, scale,
                                   stream);
  const Strides qs = {q_sb, q_sh, q_sl}, os = {o_sb, o_sh, o_sl};
  const Strides gs = {g_sb, g_sh, g_sl}, ds = {d_sb, d_sh, d_sl};
  CAREL_FLASH_DISPATCH(launch_bwd_dq, float, q, k, v, seg, o, dout, lse, delta,
                       dq, sh, qs, os, gs, ds, scale, (cudaStream_t)stream);
}

// K8. Reads the delta of K9 for the same inputs; dk and dv share the stride
// triple of dq.
int carel_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const int* seg, const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int B, int h,
                        int L, int hd, long long q_sb, long long q_sh,
                        long long q_sl, long long g_sb, long long g_sh,
                        long long g_sl, long long d_sb, long long d_sh,
                        long long d_sl, float scale, int is_bf16,
                        void* stream) {
  const Shape sh = {B, h, L};
  if (bad_shape(sh, hd)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return carel_flash_bwd_dkv_bf16(q, k, v, seg, dout, lse, delta, dk, dv, B,
                                    h, L, hd, q_sb, q_sh, q_sl, g_sb, g_sh,
                                    g_sl, d_sb, d_sh, d_sl, scale, stream);
  const Strides qs = {q_sb, q_sh, q_sl}, gs = {g_sb, g_sh, g_sl};
  const Strides ds = {d_sb, d_sh, d_sl};
  CAREL_FLASH_DISPATCH(launch_bwd_dkv, float, q, k, v, seg, dout, lse, delta,
                       dk, dv, sh, qs, gs, ds, scale, (cudaStream_t)stream);
}

}  // extern "C"

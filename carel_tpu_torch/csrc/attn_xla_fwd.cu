// The xla attention core's forward kernel; attn_xla.cuh states the
// function, its bounds and the design.

#include "attn_xla.cuh"

namespace {

// Forward: the context, m and l for the block's strips of queries, a warp a
// strip; blockIdx.x = (batch * h + head) * chunks + chunk. With `stage` the
// block's rows of the keep mask are copied into shared memory first.
template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, min_blocks(HD))
    xla_attn_fwd_kernel(const bf16* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const uint8_t* __restrict__ keep,
                        bf16* __restrict__ out, float* __restrict__ mrow,
                        float* __restrict__ lrow, int h, int L, int chunks,
                        int stage, float scale, float fscale) {
  constexpr int LD = HD + kRowPad;
  constexpr int ON = HD / 8;  // n8 fragments of the context
  extern __shared__ uint4 smem16[];
  const int Lp = padded(L);
  const int own = (blockDim.x >> 5) * 16;
  bf16* sk = reinterpret_cast<bf16*>(smem16);  // [Lp][LD]
  bf16* sv = sk + Lp * LD;                      // [Lp][LD]
  bf16* sq = sv + Lp * LD;                      // [own][LD]
  float* sbias = reinterpret_cast<float*>(sq + own * LD);  // [Lp]
  uint8_t* skeep = reinterpret_cast<uint8_t*>(sbias + Lp);  // [own][L]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / chunks, head = bh % h, batch = bh / h;
  const int row0 = (blockIdx.x % chunks) * own;
  const long long rs = 3LL * h * HD;  // elements between rows of qkv
  const bf16* q = qkv + (long long)batch * L * rs + (long long)head * HD;
  const bf16* k = q + (long long)h * HD;
  const bf16* v = k + (long long)h * HD;
  const bool staged = keep && stage;
  const uint8_t* keep_rows = keep ? keep + ((long long)bh * L + row0) * L
                                  : nullptr;

  load_rows_async<HD>(sk, k, rs, 0, Lp, L);
  load_rows_async<HD>(sv, v, rs, 0, Lp, L);
  load_rows_async<HD>(sq, q, rs, row0, own, L);
  if (staged) stage_bytes(skeep, keep_rows, min(own, L - row0) * L);
  cp_async_commit();
  for (int i = threadIdx.x; i < Lp; i += blockDim.x)
    sbias[i] = i < L ? bias[(long long)batch * L + i] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const int wrow = row0 + warp * 16;  // the strip's first query
  if (wrow >= L) return;
  const bf16* strip = sq + warp * 16 * LD;
  const int n_tiles = Lp / kKeys;
  const int n_sweeps = (n_tiles + kHeld - 1) / kHeld;
  const uint8_t* keep_row[2];  // rows g and g + 8 of the strip's mask
#pragma unroll
  for (int r = 0; r < 2; ++r)
    keep_row[r] = (staged ? skeep : keep_rows) +
                  (long long)(warp * 16 + g + 8 * r) * L;

  // x of key tile kt for fragment rows g and g + 8; -inf past L
  auto logits = [&](float (&s)[kNT][4], int kt) {
    mma_tile_nt<HD>(s, strip, sk, kt * kKeys);
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * kKeys + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = col < L ? logit(s[n][e], scale, sbias[col]) : -CUDART_INF_F;
      }
  };

  float s[kHeld][kNT][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  for (int c = 0; c < n_sweeps; ++c) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const int kt = c * kHeld + j;
      if (kt >= n_tiles) continue;
      logits(s[j], kt);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][n][e]);
    }
  }
  m[0] = quad_max(m[0]);  // finite: key 0 lies inside L
  m[1] = quad_max(m[1]);

  // l: exp(x - m) in fp32, this lane's terms in key order, then the quad;
  // held tiles keep exp(x - m)
  float l[2] = {0.f, 0.f};
  for (int c = 0; c < n_sweeps; ++c) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const int kt = c * kHeld + j;
      if (kt >= n_tiles) continue;
      if (n_sweeps > 1) logits(s[j], kt);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][n][e] = expf(__fsub_rn(s[j][n][e], m[e >> 1]));
          l[e >> 1] += s[j][n][e];
        }
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  // p = exp(x - m) / l, rounded to bf16, dropped, packed; o += pd . v
  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int c = 0; c < n_sweeps; ++c) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const int kt = c * kHeld + j;
      if (kt >= n_tiles) continue;
      if (n_sweeps > 1) {
        logits(s[j], kt);
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][n][e] = expf(__fsub_rn(s[j][n][e], m[e >> 1]));
      }
      uint32_t pf[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float pd[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = kt * kKeys + n * 8 + 2 * t4 + (e & 1);
          pd[e] = round_bf16(__fdiv_rn(s[j][n][e], l[r]));
          if (keep) {
            const bool kept =
                wrow + g + 8 * r < L && col < L && keep_row[r][col];
            pd[e] = kept ? __fmul_rn(pd[e], fscale) : 0.f;
          }
        }
        pf[n][0] = pack_bf16(pd[0], pd[1]);
        pf[n][1] = pack_bf16(pd[2], pd[3]);
      }
      mma_tile_b_trans<HD>(acc, pf, sv, kt * kKeys);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (t4 == 0 && row < L) {
      mrow[(long long)bh * L + row] = m[r];
      lrow[(long long)bh * L + row] = l[r];
    }
  }
  store_rows<HD>(out + (long long)batch * L * h * HD + (long long)head * HD,
                 (long long)h * HD, acc, wrow, L);
}

template <int HD>
int launch_fwd(const void* qkv, const float* bias, const void* keep, void* out,
               float* m, float* l, int B, int h, int L, float scale,
               float fscale, cudaStream_t stream) {
  const Plan p = fwd_plan(L);
  size_t bytes = fwd_bytes(HD, L);
  const bool stage = keep && bytes + fwd_keep_bytes(L) <= (size_t)kSmemLimit;
  if (stage) bytes += fwd_keep_bytes(L);
  const cudaError_t e = allow_shared(xla_attn_fwd_kernel<HD>, bytes);
  if (e != cudaSuccess) return (int)e;
  xla_attn_fwd_kernel<HD><<<B * h * p.chunks, p.warps * 32, bytes, stream>>>(
      static_cast<const bf16*>(qkv), bias, static_cast<const uint8_t*>(keep),
      static_cast<bf16*>(out), m, l, h, L, p.chunks, stage, scale, fscale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 if the kernels take sequences of L at head dim hd, else 0.
int carel_xla_attn_takes(int L, int hd) { return takes(L, hd) ? 1 : 0; }

// The forward: qkv [B, L, 3, h, hd] bf16, bias [B, L] fp32, keep [B, h, L, L]
// bytes or null; writes out [B, L, h * hd] bf16 and m, l [B, h, L] fp32.
int carel_xla_attn_fwd(const void* qkv, const float* bias, const void* keep,
                       void* out, float* m, float* l, int B, int h, int L,
                       int hd, float scale, float fscale, void* stream) {
  CAREL_XLA_ATTN_DISPATCH(launch_fwd, qkv, bias, keep, out, m, l, B, h, L,
                          scale, fscale, (cudaStream_t)stream);
}

}  // extern "C"

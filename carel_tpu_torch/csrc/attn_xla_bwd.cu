// The xla attention core's backward kernel; attn_xla.cuh states the
// function, its bounds and the design.

#include "attn_xla.cuh"

namespace {

// Backward: dq, dk and dv of one (batch, head) a block, blockIdx.x =
// batch * h + head. With `stage` the head's keep mask is copied into shared
// memory first; with `ds_held` phase 2 keeps ds in shared memory and phase 3
// forms dq from it, else phase 1 forms dq in a second sweep.
template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, min_blocks(HD))
    xla_attn_bwd_kernel(const bf16* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const uint8_t* __restrict__ keep,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ mrow,
                        const float* __restrict__ lrow,
                        bf16* __restrict__ dqkv, int h, int L, int stage,
                        int ds_held, float scale, float fscale, float bscale) {
  constexpr int LD = HD + kRowPad;
  constexpr int ON = HD / 8;
  extern __shared__ uint4 smem16[];
  const int Lp = padded(L);
  const int LDS = Lp + kRowPad;  // row stride of the held ds
  bf16* sq = reinterpret_cast<bf16*>(smem16);  // [Lp][LD] each
  bf16* sk = sq + Lp * LD;
  bf16* sv = sk + Lp * LD;
  bf16* sdo = sv + Lp * LD;
  float* sbias = reinterpret_cast<float*>(sdo + Lp * LD);  // [Lp] each
  float* sm = sbias + Lp;
  float* sl = sm + Lp;
  float* sD = sl + Lp;
  uint8_t* skeep = reinterpret_cast<uint8_t*>(sD + Lp);  // [L][L]
  // ds^T as bf16 hi and lo, [key][query], when held
  bf16* sdsh = reinterpret_cast<bf16*>(skeep + (stage ? round16(L * L) : 0));
  bf16* sdsl = sdsh + Lp * LDS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int warps = blockDim.x >> 5;
  const int bh = blockIdx.x, head = bh % h, batch = bh / h;
  const long long rs = 3LL * h * HD;  // elements between rows of qkv, dqkv
  const long long gs = (long long)h * HD;  // between rows of do
  const long long base = (long long)batch * L * rs + (long long)head * HD;
  const bf16* q = qkv + base;
  const uint8_t* keep_g = keep ? keep + (long long)bh * L * L : nullptr;
  const bool staged = keep && stage;
  load_rows_async<HD>(sq, q, rs, 0, Lp, L);
  load_rows_async<HD>(sk, q + gs, rs, 0, Lp, L);
  load_rows_async<HD>(sv, q + 2 * gs, rs, 0, Lp, L);
  load_rows_async<HD>(sdo, dout + (long long)batch * L * gs + head * HD, gs, 0,
                      Lp, L);
  if (staged) stage_bytes(skeep, keep_g, L * L);
  cp_async_commit();
  for (int i = threadIdx.x; i < Lp; i += blockDim.x) {
    const bool in = i < L;
    sbias[i] = in ? bias[(long long)batch * L + i] : 0.f;
    sm[i] = in ? mrow[(long long)bh * L + i] : 0.f;
    sl[i] = in ? lrow[(long long)bh * L + i] : 1.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int strips = (L + 15) / 16, n_tiles = Lp / kKeys;
  const uint8_t* keep_bh = staged ? skeep : keep_g;  // [query][key]
  bf16* dq = dqkv + base;
  bf16* dk = dq + gs;
  bf16* dv = dq + 2 * gs;

  // Phase 1: a warp a strip of queries; D = sum_j dp p, then dq
  for (int st = warp; st < strips; st += warps) {
    const int row0 = st * 16;
    const bf16* qstrip = sq + row0 * LD;
    const bf16* dostrip = sdo + row0 * LD;
    bool row_in[2];
    float mr[2], lr[2], D[2] = {0.f, 0.f};
    const uint8_t* keep_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      row_in[r] = row < L;
      mr[r] = sm[row];
      lr[r] = sl[row];
      keep_row[r] = keep_bh ? keep_bh + row * L : nullptr;
    }
    // p and dp of key tile kt (0 outside L)
    auto tile = [&](float (&p)[kNT][4], float (&dp)[kNT][4], int kt) {
      mma_tile_nt<HD>(p, qstrip, sk, kt * kKeys);
      mma_tile_nt<HD>(dp, dostrip, sv, kt * kKeys);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = kt * kKeys + n * 8 + 2 * t4 + (e & 1);
          if (row_in[r] && col < L) {
            p[n][e] = __fdiv_rn(
                expf(__fsub_rn(logit(p[n][e], scale, sbias[col]), mr[r])),
                lr[r]);
            float d = round_bf16(dp[n][e]);
            if (keep_bh)
              d = keep_row[r][col] ? round_bf16(__fmul_rn(d, bscale)) : 0.f;
            dp[n][e] = d;
          } else {
            p[n][e] = 0.f;
            dp[n][e] = 0.f;
          }
        }
    };
    float p[kNT][4], dp[kNT][4];
    for (int kt = 0; kt < n_tiles; ++kt) {
      tile(p, dp, kt);
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          D[e >> 1] = fmaf(dp[n][e], p[n][e], D[e >> 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      D[r] = quad_sum(D[r]);
      if (t4 == 0 && row_in[r]) sD[row0 + g + 8 * r] = D[r];
    }
    if (ds_held) continue;  // phase 3 forms dq
    float acc[ON][4];
#pragma unroll
    for (int n = 0; n < ON; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      tile(p, dp, kt);
      uint32_t hi[kNT][2], lo[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float dh[4], dl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ds = __fmul_rn(
              __fmul_rn(p[n][e], __fsub_rn(dp[n][e], D[e >> 1])), scale);
          dh[e] = round_bf16(ds);
          dl[e] = ds - dh[e];  // exact
        }
        hi[n][0] = pack_bf16(dh[0], dh[1]);
        hi[n][1] = pack_bf16(dh[2], dh[3]);
        lo[n][0] = pack_bf16(dl[0], dl[1]);
        lo[n][1] = pack_bf16(dl[2], dl[3]);
      }
      mma_tile_b_trans<HD>(acc, hi, sk, kt * kKeys);
      mma_tile_b_trans<HD>(acc, lo, sk, kt * kKeys);
    }
    store_rows<HD>(dq, rs, acc, row0, L);
  }
  __syncthreads();  // the block's D is in shared memory

  // Phase 2: a warp a strip of keys; fragment rows are keys, columns queries
  for (int st = warp; st < strips; st += warps) {
    const int key0 = st * 16;
    const bf16* kstrip = sk + key0 * LD;
    const bf16* vstrip = sv + key0 * LD;
    bool key_in[2];
    float kbias[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + g + 8 * r;
      key_in[r] = key < L;
      kbias[r] = sbias[key];
    }
    // p (fp32) and pd (dropped, bf16 values) of the (key, query) element
    auto probs = [&](float s, int r, int col, float& p, float& pd) {
      p = __fdiv_rn(expf(__fsub_rn(logit(s, scale, kbias[r]), sm[col])),
                    sl[col]);
      pd = round_bf16(p);
      if (keep_bh)
        pd = keep_bh[col * L + key0 + g + 8 * r] ? __fmul_rn(pd, fscale)
                                                 : 0.f;
    };
    // ds, split into bf16 hi and lo, of the (key, query) element
    auto grads = [&](float p, float dpd, int r, int col, float& dh,
                     float& dl) {
      float d = round_bf16(dpd);
      if (keep_bh)
        d = keep_bh[col * L + key0 + g + 8 * r]
                ? round_bf16(__fmul_rn(d, bscale)) : 0.f;
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(d, sD[col])), scale);
      dh = round_bf16(ds);
      dl = ds - dh;  // exact
    };
    float dk_acc[ON][4], dv_acc[ON][4];
#pragma unroll
    for (int n = 0; n < ON; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
    for (int qt = 0; qt < n_tiles; ++qt) {
      float s[kNT][4], dp[kNT][4];
      mma_tile_nt<HD>(s, kstrip, sq, qt * kKeys);
      mma_tile_nt<HD>(dp, vstrip, sdo, qt * kKeys);
      uint32_t pf[kNT][2], hi[kNT][2], lo[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        float pd[4], dh[4], dl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = qt * kKeys + n * 8 + 2 * t4 + (e & 1);  // query
          pd[e] = dh[e] = dl[e] = 0.f;
          if (key_in[r] && col < L) {
            float p;
            probs(s[n][e], r, col, p, pd[e]);
            grads(p, dp[n][e], r, col, dh[e], dl[e]);
          }
        }
        pf[n][0] = pack_bf16(pd[0], pd[1]);
        pf[n][1] = pack_bf16(pd[2], pd[3]);
        hi[n][0] = pack_bf16(dh[0], dh[1]);
        hi[n][1] = pack_bf16(dh[2], dh[3]);
        lo[n][0] = pack_bf16(dl[0], dl[1]);
        lo[n][1] = pack_bf16(dl[2], dl[3]);
      }
      mma_tile_b_trans<HD>(dv_acc, pf, sdo, qt * kKeys);
      mma_tile_b_trans<HD>(dk_acc, hi, sq, qt * kKeys);
      mma_tile_b_trans<HD>(dk_acc, lo, sq, qt * kKeys);
      if (ds_held) {
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int at = (key0 + g + 8 * r) * LDS + qt * kKeys + n * 8 +
                           2 * t4;
            *reinterpret_cast<uint32_t*>(sdsh + at) = hi[n][r];
            *reinterpret_cast<uint32_t*>(sdsl + at) = lo[n][r];
          }
      }
    }
    store_rows<HD>(dk, rs, dk_acc, key0, L);
    store_rows<HD>(dv, rs, dv_acc, key0, L);
  }
  if (!ds_held) return;
  __syncthreads();  // the block's ds is in shared memory

  // Phase 3: a warp a strip of queries; dq += ds . k from the held ds, read
  // transposed ([key][query] in shared memory) as the A operand
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  for (int st = warp; st < strips; st += warps) {
    const int row0 = st * 16;
    float acc[ON][4];
#pragma unroll
    for (int n = 0; n < ON; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int ks = 0; ks < strips; ++ks) {
      uint32_t ah[4], al[4];
      ldmatrix_x4_trans(ah, sdsh + (ks * 16 + brow) * LDS + row0 + bcol);
      ldmatrix_x4_trans(al, sdsl + (ks * 16 + brow) * LDS + row0 + bcol);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, sk + (ks * 16 + arow) * LD + np * 16 + acol);
        mma_16x8x16(acc[2 * np], ah, f[0], f[1]);
        mma_16x8x16(acc[2 * np], al, f[0], f[1]);
        mma_16x8x16(acc[2 * np + 1], ah, f[2], f[3]);
        mma_16x8x16(acc[2 * np + 1], al, f[2], f[3]);
      }
    }
    store_rows<HD>(dq, rs, acc, row0, L);
  }
}

template <int HD>
int launch_bwd(const void* qkv, const float* bias, const void* keep,
               const void* dout, const float* m, const float* l, void* dqkv,
               int B, int h, int L, float scale, float fscale, float bscale,
               cudaStream_t stream) {
  const int strips = (L + 15) / 16;
  const int warps = strips < kMaxWarps ? strips : kMaxWarps;
  size_t bytes = bwd_bytes(HD, L);
  const bool stage = keep && bytes + bwd_keep_bytes(L) <= (size_t)kSmemLimit;
  if (stage) bytes += bwd_keep_bytes(L);
  // ds held where two blocks still fit an SM (its 233,472 bytes of shared
  // memory, 1 KB a block reserved): L <= 96 at hd 64
  const bool ds_held = 2 * (bytes + bwd_ds_bytes(L) + 1024) <= 233472;
  if (ds_held) bytes += bwd_ds_bytes(L);
  const cudaError_t e = allow_shared(xla_attn_bwd_kernel<HD>, bytes);
  if (e != cudaSuccess) return (int)e;
  xla_attn_bwd_kernel<HD><<<B * h, warps * 32, bytes, stream>>>(
      static_cast<const bf16*>(qkv), bias, static_cast<const uint8_t*>(keep),
      static_cast<const bf16*>(dout), m, l, static_cast<bf16*>(dqkv), h, L,
      stage, ds_held, scale, fscale, bscale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward: the forward's inputs, do [B, L, h * hd] bf16 and the
// forward's m and l; writes dqkv [B, L, 3, h, hd] bf16.
int carel_xla_attn_bwd(const void* qkv, const float* bias, const void* keep,
                       const void* dout, const float* m, const float* l,
                       void* dqkv, int B, int h, int L, int hd, float scale,
                       float fscale, float bscale, void* stream) {
  CAREL_XLA_ATTN_DISPATCH(launch_bwd, qkv, bias, keep, dout, m, l, dqkv, B, h,
                          L, scale, fscale, bscale, (cudaStream_t)stream);
}

}  // extern "C"

// The encoder's xla attention core for bf16 inputs on the Hopper tensor cores
// (sm_90a): one forward kernel (attn_xla_fwd.cu) and one backward kernel
// (attn_xla_bwd.cu), two sources so that each compiles beside the others;
// this header holds what they share, from the packed
// projection [B, L, 3, h, hd] to the context [B, L, h * hd] and back to one
// packed gradient [B, L, 3, h, hd].
//
// Replaces no TPU kernel: carel_tpu's SelfAttention leaves this core to XLA
// (carel_tpu/models/encoder.py:70-81, attention_impl="xla", the default),
// which fuses it on the TPU. The port ran it as PyTorch ops, a dozen kernels
// a layer over [B, h, L, L] tensors in device memory: the fp32 scores, the
// scale, the bias, the softmax, the bf16 cast, dropout, layout copies, and in
// the backward fp32 products on the CUDA cores. Here the scores stay in
// registers.
//
// The function, at the rounding points of the port's plain ops
// (ops/xla_attention.py: attention_ops; only sum orders differ):
//   x  = fp32(q . k^T) * scale + bias[key]   fp32 sums of the bf16 products;
//        two roundings, as torch multiplies by the fp32 reciprocal of
//        sqrt(hd) and then adds the key's bias (0, or -1e9 on a pad key)
//   p  = exp(x - max) / sum exp(x - max)      fp32, over the whole row
//   pd = bf16(bf16(p) * fscale) where the keep mask is set, else 0 (torch's
//        dropout arithmetic); without a mask pd = bf16(p)
//   o  = bf16(pd . v)                         fp32 sums
// and its gradient, from do = d o:
//   dv  = bf16(pd^T . do)
//   dpd = bf16(do . v^T); dp = bf16(dpd * bscale) where kept, else 0
//   ds  = p * (dp - sum_j dp p) * scale       fp32, p not rounded
//   dq  = bf16(ds . k), dk = bf16(ds^T . q)   the fp32 ds times the bf16
//        operand summed in fp32, as JAX transposes the fp32-output product:
//        ds is split into bf16 hi + bf16 lo and both go through the tensor
//        cores into one fp32 sum; what the split leaves (2^-16 of ds) is far
//        below the last rounding
// The keep mask is torch's own draw (the wrapper's), one byte an element of
// [B, h, L, L]; null without dropout.
//
// What bounds it on this card: bytes. At [64, 12, 96, 64] with dropout the
// forward reads the packed qkv (28.3 MB) and the mask (7.1 MB) and writes the
// context (9.4 MB) and m, l (0.6 MB): 45.4 MB, 0.0136 ms at 3.35 TB/s,
// against 1.8 GFLOP (0.0018 ms at 989 TFLOP/s). The backward reads qkv, do,
// the mask, m and l and writes the packed gradient: 73.7 MB, 0.022 ms,
// against 4.5 GFLOP of its five products (0.0046 ms).
//
// Design (mma.sync.m16n8k16 fed by ldmatrix, fp32 accumulators; the helpers
// of mma_tiles.cuh, shared with flash_mma.cu; a warp owns strips of 16 rows):
//   - forward: a block holds the whole head's k and v and its own query
//     strips in shared memory (rows padded by 16 bytes, zeros past L). A
//     warp's scores for up to kHeld tiles of 32 keys stay in registers: up to
//     L = 128 the row is formed once, its exact max and its sum taken, and
//     the normalised probabilities rounded, dropped and packed as the A
//     fragments of p . v. Past 128 keys the tiles are formed again for the
//     sum and for the products (three sweeps, the same bits each time). m and
//     l (fp32 [B, h, L]) are written for the backward;
//   - backward: a block owns one (batch, head) and holds its q, k, v and do
//     and the row vectors in shared memory. Phase 1, a warp a strip of
//     queries: a sweep over the key tiles forms p and dp and sums the row
//     term D = sum_j dp p. Phase 2, after the block's D is in shared memory,
//     a warp a strip of keys: the transposed tiles s^T = k . q^T and
//     dpd^T = v . do^T give p, pd, dp and ds for its keys, then
//     dv += pd^T . do and dk += ds^T . q. dq: where two blocks an SM still
//     fit with it (L <= 96 at hd 64), phase 2 also writes ds^T (hi and lo)
//     into shared memory and phase 3, a warp a strip of queries, reads it
//     transposed as the A operand of dq += ds . k (0.129 against 0.172 ms at
//     [64, 12, 96, 64]); else a second sweep of phase 1 forms ds again and
//     dq from it (at L = 128 holding ds leaves one block an SM: 0.282
//     against 0.234 ms). Every sum has a fixed order: no atomics, two runs
//     bit-equal;
//   - the keep mask goes into shared memory with the tiles where it fits (the
//     forward block's rows, the backward's whole head: 9 KB at L = 96) and is
//     read from there a byte an element; else from device memory;
//   - two blocks of up to 8 warps an SM (128 registers a thread) up to hd 64:
//     at [64, 12, 96, 64] one block an SM (183 registers) took the backward
//     0.29 ms, two 0.17 (three, spilling, 0.19), and the forward 0.089
//     against 0.057 ms (NVIDIA H100 80GB HBM3, 700 W);
//   - the outputs leave from the fragments as 4-byte stores straight into the
//     context and the packed gradient.
// Head dims taken: 16, 32, 64, 128; L up to what the backward's shared memory
// holds (carel_xla_attn_takes: 384 at hd 64). Inputs contiguous, 16-byte
// aligned; the wrapper checks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <math_constants.h>

#include "mma_tiles.cuh"

namespace {


constexpr int kKeys = 32;        // rows of the other side a tile
constexpr int kNT = kKeys / 8;   // n8 fragments of a tile
constexpr int kHeld = 4;         // tiles of scores the forward keeps: L <= 128
constexpr int kMaxWarps = 8;     // strips a block works on at once
constexpr int kSmemLimit = 232448;  // shared memory a block may take

// blocks of kMaxWarps warps an SM must hold: 2 caps the registers at 128 a
// thread up to hd 64; hd 128 takes what it needs
constexpr int min_blocks(int hd) { return hd <= 64 ? 2 : 1; }

__host__ __device__ constexpr int padded(int L) {
  return (L + kKeys - 1) / kKeys * kKeys;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x = s * scale + bias, rounded after each step as torch does (no fma)
__device__ __forceinline__ float logit(float s, float scale, float bias) {
  return __fadd_rn(__fmul_rn(s, scale), bias);
}

// Rows g and g + 8 (of the strip starting at row0) of an [rows, HD] fp32
// fragment set, rounded to bf16, into dst (row stride in elements); rows past
// L are not written.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           const float (&acc)[HD / 8][4],
                                           int row0, int L) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
    bf16* p = dst + (long long)row * row_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// acc[16 x HD] += a[16 x 32] . b[32 x HD], a as two k16 A fragments packed
// from C fragments (af[n][0]: row g, af[n][1]: row g + 8 of n8 fragment n), b
// rows row0 .. row0 + 32 of a [rows][HD + kRowPad] tile read transposed.
template <int HD>
__device__ __forceinline__ void mma_tile_b_trans(float (&acc)[HD / 8][4],
                                                 const uint32_t (&af)[kNT][2],
                                                 const bf16* b, int row0) {
  constexpr int LD = HD + kRowPad;
  const int lane = threadIdx.x & 31;
  const int arow = lane & 15, acol = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const uint32_t a[4] = {af[2 * kk][0], af[2 * kk][1], af[2 * kk + 1][0],
                           af[2 * kk + 1][1]};
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t f[4];
      ldmatrix_x4_trans(f, b + (row0 + kk * 16 + arow) * LD + np * 16 + acol);
      mma_16x8x16(acc[2 * np], a, f[0], f[1]);
      mma_16x8x16(acc[2 * np + 1], a, f[2], f[3]);
    }
  }
}

// s[16 x 32] = a_strip[16 x HD] . b[row0 .. row0 + 32]^T, b's rows read as
// they lie (the col operand).
template <int HD>
__device__ __forceinline__ void mma_tile_nt(float (&s)[kNT][4],
                                            const bf16* a_strip, const bf16* b,
                                            int row0) {
  constexpr int LD = HD + kRowPad;
  const int lane = threadIdx.x & 31;
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, a_strip + arow * LD + ks * 16 + acol);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t f[4];
      ldmatrix_x4(f, b + (row0 + np * 16 + brow) * LD + ks * 16 + bcol);
      mma_16x8x16(s[2 * np], a, f[0], f[1]);
      mma_16x8x16(s[2 * np + 1], a, f[2], f[3]);
    }
  }
}

// Copies n bytes of src (device memory) into dst (shared memory, 16-byte
// aligned): 16 bytes a thread by cp.async where src and n allow it (in the
// caller's commit group), else a byte a thread.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src,
                                            int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 15) == 0) {
    for (int i = threadIdx.x * 16; i < n; i += blockDim.x * 16)
      cp_async16(dst + i, src + i, true);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// How the forward cuts a head's queries into blocks: the fewest chunks of at
// most kMaxWarps strips, the strips spread evenly over them.
struct Plan {
  int chunks, warps;
};

Plan fwd_plan(int L) {
  const int strips = (L + 15) / 16;
  Plan p;
  p.chunks = (strips + kMaxWarps - 1) / kMaxWarps;
  p.warps = (strips + p.chunks - 1) / p.chunks;
  return p;
}

size_t fwd_bytes(int hd, int L) {
  return (size_t)(2 * padded(L) + fwd_plan(L).warps * 16) * (hd + kRowPad) *
             sizeof(bf16) +
         (size_t)padded(L) * sizeof(float);
}

size_t bwd_bytes(int hd, int L) {
  return (size_t)4 * padded(L) * (hd + kRowPad) * sizeof(bf16) +
         (size_t)4 * padded(L) * sizeof(float);
}

// the keep mask's rows that a block stages: the forward's own, the
// backward's whole head
size_t fwd_keep_bytes(int L) { return round16(fwd_plan(L).warps * 16 * L); }
size_t bwd_keep_bytes(int L) { return round16(L * L); }
// ds^T held as bf16 hi and lo
size_t bwd_ds_bytes(int L) {
  return (size_t)2 * padded(L) * (padded(L) + kRowPad) * sizeof(bf16);
}

bool takes(int L, int hd) {
  return (hd == 16 || hd == 32 || hd == 64 || hd == 128) && L > 0 &&
         fwd_bytes(hd, L) <= (size_t)kSmemLimit &&
         bwd_bytes(hd, L) <= (size_t)kSmemLimit;
}

#define CAREL_XLA_ATTN_DISPATCH(LAUNCH, ...)            \
  if (!takes(L, hd)) return (int)cudaErrorInvalidValue; \
  switch (hd) {                                         \
    case 16: return LAUNCH<16>(__VA_ARGS__);            \
    case 32: return LAUNCH<32>(__VA_ARGS__);            \
    case 64: return LAUNCH<64>(__VA_ARGS__);            \
    case 128: return LAUNCH<128>(__VA_ARGS__);          \
    default: return (int)cudaErrorInvalidValue;         \
  }

}  // namespace

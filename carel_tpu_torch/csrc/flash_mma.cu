// Flash attention with a segment mask for bf16 inputs on the Hopper tensor
// cores (sm_90a): the forward (K7), the backward for dK and dV (K8) and the
// backward for dQ with the row term delta = sum(o * do) as its prologue (K9).
//
// Replaces, for bf16, the stock Pallas TPU flash attention that carel_tpu's
// SelfAttention calls under attention_impl="flash"
// (carel_tpu/models/encoder.py:61; jax/experimental/pallas/ops/tpu/
// flash_attention.py): K7 _flash_attention_impl / _flash_attention_kernel,
// K8 _flash_attention_bwd_dkv / _flash_attention_dkv_kernel, K9
// _flash_attention_bwd_dq / _flash_attention_dq_kernel and the di sum of
// _flash_attention_bwd. The function is the one flash.cu states (segment
// mask with -0.7 * FLT_MAX, fp32 online softmax, exp(s - running max)
// rounded to bf16 before p.v, p and ds rounded to bf16 before their products
// in K8, ds alone in K9, fp32 sums, lse = m + log(l)); fp32 inputs keep the
// CUDA-core kernels of flash.cu, because the tensor cores have no full-fp32
// product (TF32 keeps three digits) and their sums do not round each
// addition as fmaf does.
//
// What bounds it on this card: bytes. At bf16 [64, 12, 96, 64] K7 moves
// 38 MB (0.0114 ms at 3.35 TB/s) against 1.3 GFLOP (0.0013 ms at 989
// TFLOP/s), K8 57 MB (0.0171 ms) against 2.5 GFLOP (0.0025 ms), K9 57 MB
// against 1.9 GFLOP (0.0019 ms): nine, seven and nine times more time in
// bytes than in operations. So the design spends nothing twice on memory
// and takes the tensor-core instruction that wastes no rows, not the one
// with the highest peak.
//
// Instruction: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 fed by
// ldmatrix. One warp owns a strip of 16 rows (queries in K7 and K9, keys in
// K8):
// L = 96 is 6 strips with no wasted row, where wgmma's 64-row tiles would
// waste a quarter of them at L = 96 and most at L = 37; mma.sync's lower
// peak is far from being the limit of a kernel bound by bytes.
//
// Design:
//   - both products of each kernel run on the tensor cores from bf16 tiles
//     in shared memory; nothing is widened to fp32 there. Rows are padded by
//     16 bytes (a row of hd = 64 is 144 bytes), so the eight 16-byte rows of
//     an ldmatrix fall on distinct banks for every head dim taken;
//   - the probabilities never leave registers: the C fragments of two
//     neighbouring n8 score tiles, rounded to bf16 and packed, are the A
//     fragment of the next k16 step of p.v. K8 gets the same by computing
//     the transposed tiles: a warp owns 16 keys, forms S^T = K_strip . Q^T
//     and dP^T = V_strip . dO^T (A = its K or V strip; B = the q or do tile,
//     which as [row][hd] in shared memory is already the col operand), then
//     dV_strip += p^T . dO and dK_strip += ds^T . Q with dO and Q as B
//     through ldmatrix.trans. lse, delta and the query segment ids index the
//     fragment's columns and are staged per tile of queries. A warp owns its
//     16 rows of the result outright: no reduction across warps, no atomics,
//     every sum in a fixed order, two runs bit-equal. K9 is K7's loop with
//     two score products: S = Q_strip . K^T and dP = dO_strip . V^T, p (not
//     rounded) and ds in the C fragments' registers, ds rounded and packed as
//     the A fragment of dQ_strip += ds . K with K as B through
//     ldmatrix.trans; lse, delta and the query segment ids are per-row
//     scalars in registers. delta is formed before the loop: a lane reads
//     its 16-byte pieces of its two o rows from device memory into registers
//     while the tiles are on their way, multiplies them with do from shared
//     memory and the quad adds up; the rows are written for K8, which the
//     wrapper launches after K9 on the same stream;
//   - a block owns up to 6 strips (96 rows, the model's max_len) of one
//     (batch, head): its own side (q in K7; k and v in K8; q and do in K9)
//     is loaded once and stays; the other side (k, v and the key segment ids
//     in K7 and K9; q, do, lse, delta and the query segment ids in K8) comes
//     in tiles of 32 rows through a ring filled by cp.async.cg (16 bytes a
//     thread, zero-filled past L), one commit group per tile. K7 and K8 have
//     4 stages, three tiles ahead of the products, so a tile's load overlaps
//     the products of the tiles before it: up to L = 96 every tile is
//     requested before the first product and no slot is reused. K9 has 2
//     stages, one tile ahead: measured faster than 3 or 4 (below), and it
//     leaves the registers without spills. Up to L = 96 one block holds a
//     whole (batch, head) and each tensor is read from device memory once. Up to L = 128 the ring
//     still holds the whole other side, but the head is cut into two
//     blocks; from L = 129 on the slots are reused (the loop takes over). A
//     head of more than 6 strips is cut into ceil(strips / 6) blocks of
//     equal strip counts, each streaming the other side once, mostly from
//     L2;
//   - the A fragments (the warp's q strip in K7, its k and v strips in K8,
//     its q and do strips in K9) are read again from shared memory by ldmatrix for each tile rather
//     than kept: on the card that costs K8 3 % and gains K7 5 %, because the
//     registers it frees let K7 hold 3 blocks an SM without spills, and at
//     hd = 128 K8's accumulators alone take 128 registers a thread;
//   - o, dk, dv and dq go through the warp's own strip of shared memory (its
//     q, or k and v, rows, which no other warp reads) and leave as 16-byte
//     stores along hd;
//   - the mask is added to s * scale before exp, not folded into an exp2
//     scale: -0.7 * FLT_MAX * log2(e) would be -inf and a row whose keys so
//     far are all masked would give inf - inf. Columns past L take p = 0.
//
// Blocks and warps in flight at L = 96, hd = 64 (6 warps a block; ptxas
// -v, CUDA 12.8; times on an NVIDIA H100 80GB HBM3 at 700 W by
// carel_tpu_torch/tools/flash_variants.py, batch 64 / batch 512):
//   K7: 41,856 bytes of shared memory (5 blocks would fit), 96 registers
//       under __launch_bounds__(192, 3): 3 blocks, 18 warps an SM, 396
//       blocks on the card; B.h = 768 (training) is 1.94 waves, 6,144
//       (serving at batch 512) 15.5. With 2 blocks an SM (111 registers)
//       it took 0.0230 / 0.1487 ms, with 3 0.0211 / 0.1262; 4 (80
//       registers, 80 bytes spilled) 0.0241 / 0.1385.
//   K8: 56,448 bytes (4 blocks would fit), 161 registers under
//       __launch_bounds__(192, 2): 2 blocks, 12 warps an SM, 264 on the
//       card; 768 is 2.91 waves. One block an SM took 0.059 ms, two 0.041;
//       three need 112 registers and spill 620 bytes (0.057).
//   K9: 46,336 bytes (4 blocks would fit), 96 registers without spills
//       under __launch_bounds__(192, 3) with its ring of 2 stages: 3 blocks,
//       18 warps an SM, 396 on the card; 768 is 1.94 waves: 0.0365 ms. With
//       3 stages it took 0.0397 and with 4 0.0404 (96 registers, 56 bytes
//       spilled either way); at 2 stages, 2 blocks an SM (144 registers)
//       0.0403 and 4 (80 registers, 148 bytes spilled) 0.0441. The time
//       hardly follows the occupancy: with every tile requested at once a
//       wave of blocks loads, then computes, and the two do not overlap.
//   Blocks of 3 warps, two per (batch, head), were no faster (K7 0.0229 /
//   0.1364, K8 0.0421, K9 0.0375), nor were tiles of 16 rows (0.0269 /
//   0.1782, 0.0444, 0.0392).
// At hd = 128 the bounds ask for one block an SM (K7 149, K8 242, K9 170
// registers, no spills).
//
// Inputs must start on 16-byte boundaries (8 bf16 elements: base pointers
// and the batch, head and row strides); the wrapper checks.
// Head dims taken: 16, 32, 64, 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <math_constants.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kTile = 32;     // rows of the streamed side per ring stage
constexpr int kStages = 4;    // ring depth of K7 and K8: three tiles in flight
constexpr int kDqStages = 2;  // ring depth of K9: one tile in flight
constexpr int kMaxWarps = 6;  // strips of 16 rows a block owns at most
// blocks of kMaxWarps warps that an SM must hold at hd <= 64, which caps the
// registers of K7 (112), K8 (168) and K9 (112); hd = 128 takes what it needs
constexpr int kFwdMinBlocks = 3;
constexpr int kDkvMinBlocks = 2;
constexpr int kDqMinBlocks = 3;
constexpr float kMaskValue = (float)(-0.7 * (double)FLT_MAX);

constexpr int min_blocks(int hd, int up_to_64) {
  return hd <= 64 ? up_to_64 : 1;
}

struct Strides {
  long long b, h, l;  // elements between batches, heads and rows
};

// Requests entries row0 .. row0 + kTile of a vector of L 4-byte values;
// entries past L become zeros.
template <typename T>
__device__ __forceinline__ void load_vec_async(T* dst, const T* src, int row0,
                                               int L) {
  static_assert(sizeof(T) == 4, "4-byte entries");
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const bool in = row0 + i < L;
    cp_async4(dst + i, src + (in ? row0 + i : 0), in);
  }
}

// Bytes of one ring stage: two [kTile][HD + kRowPad] bf16 tiles and
// `vectors` vectors of kTile 4-byte entries.
__host__ __device__ constexpr int stage_bytes(int hd, int vectors) {
  return 2 * kTile * (hd + kRowPad) * 2 + vectors * kTile * 4;
}

struct BlockIndex {
  int batch, head, bh, row0;  // row0: first of the rows the block owns
};

// blockIdx.x = (batch * h + head) * chunks + chunk; a block owns
// blockDim.x / 32 strips of 16 rows.
__device__ __forceinline__ BlockIndex block_index(int h, int chunks) {
  BlockIndex ix;
  ix.bh = blockIdx.x / chunks;
  ix.row0 = (blockIdx.x % chunks) * (blockDim.x >> 5) * 16;
  ix.head = ix.bh % h;
  ix.batch = ix.bh / h;
  return ix;
}

// K7: o and lse for the block's strips of queries, one strip a warp.
template <int HD>
__global__ void
__launch_bounds__(kMaxWarps * 32, min_blocks(HD, kFwdMinBlocks))
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ seg, bf16* __restrict__ o,
                         float* __restrict__ lse, int h, int L, int chunks,
                         Strides qs, Strides os, float scale) {
  constexpr int LD = HD + kRowPad;
  constexpr int KS = HD / 16;    // k16 steps of q . k^T
  constexpr int NT = kTile / 8;  // n8 score tiles per tile of keys
  constexpr int ON = HD / 8;     // n8 tiles of the output
  constexpr int kStageBytes = stage_bytes(HD, 1);
  extern __shared__ uint4 smem16[];
  bf16* sq = reinterpret_cast<bf16*>(smem16);  // [own rows][LD]
  const int own_rows = (blockDim.x >> 5) * 16;
  char* ring = reinterpret_cast<char*>(sq + own_rows * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const BlockIndex ix = block_index(h, chunks);
  const long long base = ix.batch * qs.b + ix.head * qs.h;
  const int* seg_b = seg + (long long)ix.batch * L;
  const int n_tiles = (L + kTile - 1) / kTile;

  // stage t % kStages: k tile, v tile, the keys' segment ids
  auto request = [&](int t) {
    bf16* sk = reinterpret_cast<bf16*>(ring + (t % kStages) * kStageBytes);
    bf16* sv = sk + kTile * LD;
    load_rows_async<HD>(sk, k + base, qs.l, t * kTile, kTile, L);
    load_rows_async<HD>(sv, v + base, qs.l, t * kTile, kTile, L);
    load_vec_async(reinterpret_cast<int*>(sv + kTile * LD), seg_b, t * kTile,
                   L);
  };

  // q rides in the first tile's group
  load_rows_async<HD>(sq, q + base, qs.l, ix.row0, own_rows, L);
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) request(t);
    cp_async_commit();  // one group per tile, empty past the last
  }

  const int wrow = warp * 16;
  bf16* strip = sq + wrow * LD;
  const bool active = ix.row0 + wrow < L;  // else the strip holds no query

  // fragment rows g and g + 8 of the strip
  int segq[2];
  float m[2], l[2], acc[ON][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ix.row0 + wrow + g + 8 * r;
    segq[r] = row < L ? seg_b[row] : 0;
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;  // this lane's part of the row sum
  }
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // lane addresses inside a 16 x 16 piece: the col (B) operand read as it
  // lies, and the A or transposed-B operand
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  const int arow = lane & 15, acol = (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile t has landed
    __syncthreads();  // everyone's has; tile t - 1 is done with by all warps
    if (t + kStages - 1 < n_tiles) request(t + kStages - 1);
    cp_async_commit();
    if (!active) continue;

    const bf16* sk =
        reinterpret_cast<const bf16*>(ring + (t % kStages) * kStageBytes);
    const bf16* sv = sk + kTile * LD;
    const int* sseg = reinterpret_cast<const int*>(sv + kTile * LD);
    const int k0 = t * kTile;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      ldmatrix_x4(qa, strip + arow * LD + ks * 16 + acol);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, sk + (np * 16 + brow) * LD + ks * 16 + bcol);
        mma_16x8x16(s[2 * np], qa, b[0], b[1]);
        mma_16x8x16(s[2 * np + 1], qa, b[2], b[3]);
      }
    }

    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1), r = e >> 1;
        if (k0 + col < L) {
          s[n][e] = s[n][e] * scale + (sseg[col] == segq[r] ? 0.f : kMaskValue);
          mt[r] = fmaxf(mt[r], s[n][e]);
        } else {
          s[n][e] = -CUDART_INF_F;  // past the ragged edge: p = 0
        }
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = quad_max(mt[r]);  // finite: key k0 is inside L
      alpha[r] = __expf(m[r] - mt[r]);
      m[r] = mt[r];
    }
    // p = exp(s - running max): its fp32 values into the row sum, rounded
    // to bf16 and packed as the A fragments of p . v
    uint32_t pf[NT][2];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = __expf(s[n][0] - mt[0]), p1 = __expf(s[n][1] - mt[0]);
      const float p2 = __expf(s[n][2] - mt[1]), p3 = __expf(s[n][3] - mt[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[n][0] = pack_bf16(p0, p1);
      pf[n][1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                             pf[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < ON / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sv + (kk * 16 + arow) * LD + np * 16 + acol);
        mma_16x8x16(acc[2 * np], a, b[0], b[1]);
        mma_16x8x16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  if (!active) return;

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
    const int row = ix.row0 + wrow + g + 8 * r;
    if (t4 == 0 && row < L)
      lse[(long long)ix.bh * L + row] = m[r] + logf(l[r]);
  }
  store_strip<HD>(o + ix.batch * os.b + ix.head * os.h, os.l, strip, acc,
                  inv[0], inv[1], ix.row0 + wrow, L);
}

// K8: dk and dv for the block's strips of keys, one strip a warp, looping
// over the tiles of queries. All tiles are transposed: fragment rows are
// keys, fragment columns queries.
template <int HD>
__global__ void
__launch_bounds__(kMaxWarps * 32, min_blocks(HD, kDkvMinBlocks))
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const int* __restrict__ seg,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int h, int L, int chunks, Strides qs, Strides gs,
                             Strides ds, float scale) {
  constexpr int LD = HD + kRowPad;
  constexpr int KS = HD / 16;    // k16 steps of k . q^T and v . do^T
  constexpr int NT = kTile / 8;  // n8 tiles (of queries) per tile
  constexpr int ON = HD / 8;     // n8 tiles of dk and dv
  constexpr int kStageBytes = stage_bytes(HD, 3);
  extern __shared__ uint4 smem16[];
  const int own_rows = (blockDim.x >> 5) * 16;
  bf16* sk = reinterpret_cast<bf16*>(smem16);  // [own rows][LD]
  bf16* sv = sk + own_rows * LD;
  char* ring = reinterpret_cast<char*>(sv + own_rows * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const BlockIndex ix = block_index(h, chunks);
  const long long base = ix.batch * qs.b + ix.head * qs.h;
  const long long gbase = ix.batch * gs.b + ix.head * gs.h;
  const int* seg_b = seg + (long long)ix.batch * L;
  const float* lse_b = lse + (long long)ix.bh * L;
  const float* delta_b = delta + (long long)ix.bh * L;
  const int n_tiles = (L + kTile - 1) / kTile;

  // stage t % kStages: q tile, do tile, lse, delta, the queries' segment ids
  auto request = [&](int t) {
    bf16* sq = reinterpret_cast<bf16*>(ring + (t % kStages) * kStageBytes);
    bf16* sdo = sq + kTile * LD;
    float* slse = reinterpret_cast<float*>(sdo + kTile * LD);
    load_rows_async<HD>(sq, q + base, qs.l, t * kTile, kTile, L);
    load_rows_async<HD>(sdo, dout + gbase, gs.l, t * kTile, kTile, L);
    load_vec_async(slse, lse_b, t * kTile, L);
    load_vec_async(slse + kTile, delta_b, t * kTile, L);
    load_vec_async(reinterpret_cast<int*>(slse + 2 * kTile), seg_b, t * kTile,
                   L);
  };

  // the block's k and v ride in the first tile's group
  load_rows_async<HD>(sk, k + base, qs.l, ix.row0, own_rows, L);
  load_rows_async<HD>(sv, v + base, qs.l, ix.row0, own_rows, L);
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) request(t);
    cp_async_commit();  // one group per tile, empty past the last
  }

  const int wrow = warp * 16;
  bf16* kstrip = sk + wrow * LD;
  bf16* vstrip = sv + wrow * LD;
  const bool active = ix.row0 + wrow < L;  // else the strip holds no key
  const int arow = lane & 15, acol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;

  // fragment rows g and g + 8 of the strip
  int segk[2];
  bool key_in[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ix.row0 + wrow + g + 8 * r;
    key_in[r] = row < L;
    segk[r] = key_in[r] ? seg_b[row] : 0;
  }
  float dk_acc[ON][4], dv_acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile t has landed
    __syncthreads();  // everyone's has; tile t - 1 is done with by all warps
    if (t + kStages - 1 < n_tiles) request(t + kStages - 1);
    cp_async_commit();
    if (!active) continue;

    const bf16* sq =
        reinterpret_cast<const bf16*>(ring + (t % kStages) * kStageBytes);
    const bf16* sdo = sq + kTile * LD;
    const float* slse = reinterpret_cast<const float*>(sdo + kTile * LD);
    const float* sdelta = slse + kTile;
    const int* ssegq = reinterpret_cast<const int*>(sdelta + kTile);
    const int q0 = t * kTile;

    // s^T = k_strip . q^T and dp^T = v_strip . do^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, kstrip + arow * LD + ks * 16 + acol);
      ldmatrix_x4(va, vstrip + arow * LD + ks * 16 + acol);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, sq + (np * 16 + brow) * LD + ks * 16 + bcol);
        mma_16x8x16(s[2 * np], ka, b[0], b[1]);
        mma_16x8x16(s[2 * np + 1], ka, b[2], b[3]);
        ldmatrix_x4(b, sdo + (np * 16 + brow) * LD + ks * 16 + bcol);
        mma_16x8x16(dp[2 * np], va, b[0], b[1]);
        mma_16x8x16(dp[2 * np + 1], va, b[2], b[3]);
      }
    }

    // p = exp(s - lse) and ds = (dp - delta) * p * scale, as the stock
    // backward forms them, rounded to bf16 and packed as A fragments
    uint32_t pf[NT][2], dsf[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float p[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1), r = e >> 1;
        const bool inside = q0 + col < L && key_in[r];
        p[e] = inside ? __expf(s[n][e] * scale +
                               (ssegq[col] == segk[r] ? 0.f : kMaskValue) -
                               slse[col])
                      : 0.f;
        d[e] = ((dp[n][e] - sdelta[col]) * p[e]) * scale;
      }
      pf[n][0] = pack_bf16(p[0], p[1]);
      pf[n][1] = pack_bf16(p[2], p[3]);
      dsf[n][0] = pack_bf16(d[0], d[1]);
      dsf[n][1] = pack_bf16(d[2], d[3]);
    }

    // dv_strip += p^T . do and dk_strip += ds^T . q
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                              pf[2 * kk + 1][1]};
      const uint32_t da[4] = {dsf[2 * kk][0], dsf[2 * kk][1],
                              dsf[2 * kk + 1][0], dsf[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < ON / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sdo + (kk * 16 + arow) * LD + np * 16 + acol);
        mma_16x8x16(dv_acc[2 * np], pa, b[0], b[1]);
        mma_16x8x16(dv_acc[2 * np + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, sq + (kk * 16 + arow) * LD + np * 16 + acol);
        mma_16x8x16(dk_acc[2 * np], da, b[0], b[1]);
        mma_16x8x16(dk_acc[2 * np + 1], da, b[2], b[3]);
      }
    }
  }
  if (!active) return;

  const long long dbase = ix.batch * ds.b + ix.head * ds.h;
  store_strip<HD>(dk + dbase, ds.l, kstrip, dk_acc, 1.f, 1.f, ix.row0 + wrow,
                  L);
  store_strip<HD>(dv + dbase, ds.l, vstrip, dv_acc, 1.f, 1.f, ix.row0 + wrow,
                  L);
}

// K9: delta = sum(o * do) per row (written for K8), then dq for the block's
// strips of queries, one strip a warp, looping over the tiles of keys: K7's
// loop with two score products (s and dp) and dq += ds . k in place of
// o += p . v.
template <int HD>
__global__ void
__launch_bounds__(kMaxWarps * 32, min_blocks(HD, kDqMinBlocks))
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const int* __restrict__ seg,
                            const bf16* __restrict__ o,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ delta, bf16* __restrict__ dq,
                            int h, int L, int chunks, Strides qs, Strides os,
                            Strides gs, Strides ds, float scale) {
  constexpr int LD = HD + kRowPad;
  constexpr int KS = HD / 16;    // k16 steps of q . k^T and do . v^T
  constexpr int NT = kTile / 8;  // n8 score tiles per tile of keys
  constexpr int ON = HD / 8;     // n8 tiles of dq
  constexpr int C = HD / 8;      // 16-byte pieces of a row
  constexpr int kStageBytes = stage_bytes(HD, 1);
  extern __shared__ uint4 smem16[];
  const int own_rows = (blockDim.x >> 5) * 16;
  bf16* sq = reinterpret_cast<bf16*>(smem16);  // [own rows][LD]
  bf16* sdo = sq + own_rows * LD;
  char* ring = reinterpret_cast<char*>(sdo + own_rows * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const BlockIndex ix = block_index(h, chunks);
  const long long base = ix.batch * qs.b + ix.head * qs.h;
  const int* seg_b = seg + (long long)ix.batch * L;
  const int n_tiles = (L + kTile - 1) / kTile;

  // stage t % kDqStages: k tile, v tile, the keys' segment ids
  auto request = [&](int t) {
    bf16* sk = reinterpret_cast<bf16*>(ring + (t % kDqStages) * kStageBytes);
    bf16* sv = sk + kTile * LD;
    load_rows_async<HD>(sk, k + base, qs.l, t * kTile, kTile, L);
    load_rows_async<HD>(sv, v + base, qs.l, t * kTile, kTile, L);
    load_vec_async(reinterpret_cast<int*>(sv + kTile * LD), seg_b, t * kTile,
                   L);
  };

  // q and do ride in the first tile's group
  load_rows_async<HD>(sq, q + base, qs.l, ix.row0, own_rows, L);
  load_rows_async<HD>(sdo, dout + ix.batch * gs.b + ix.head * gs.h, gs.l,
                      ix.row0, own_rows, L);
  for (int t = 0; t < kDqStages - 1; ++t) {
    if (t < n_tiles) request(t);
    cp_async_commit();  // one group per tile, empty past the last
  }

  const int wrow = warp * 16;
  bf16* qstrip = sq + wrow * LD;
  const bf16* dostrip = sdo + wrow * LD;
  const bool active = ix.row0 + wrow < L;  // else the strip holds no query

  // fragment rows g and g + 8 of the strip: their scalars, and this lane's
  // 16-byte pieces (t4, t4 + 4, ...) of their o rows, read from device memory
  // while the tiles are on their way
  int segq[2];
  bool row_in[2];
  float lse_r[2], delta_r[2] = {0.f, 0.f};
  uint4 o_own[2][(C + 3) / 4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ix.row0 + wrow + g + 8 * r;
    row_in[r] = row < L;
    segq[r] = row_in[r] ? seg_b[row] : 0;
    lse_r[r] = row_in[r] ? lse[(long long)ix.bh * L + row] : 0.f;
    const bf16* orow = o + ix.batch * os.b + ix.head * os.h +
                       (long long)(row_in[r] ? row : 0) * os.l;
#pragma unroll
    for (int i = 0; i < (C + 3) / 4; ++i) {
      const int c = t4 + 4 * i;
      o_own[r][i] = row_in[r] && c < C
                        ? *reinterpret_cast<const uint4*>(orow + c * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // delta: fp32 sum of the bf16 products o * do over the row, each lane its
  // pieces in order, then the quad; q and do have landed with the first group
  cp_async_wait<kDqStages - 2>();
  __syncthreads();
  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < (C + 3) / 4; ++i) {
        const int c = t4 + 4 * i;
        if (c < C) {
          const uint4 g4 = *reinterpret_cast<const uint4*>(
              dostrip + (g + 8 * r) * LD + c * 8);
          const __nv_bfloat162* a =
              reinterpret_cast<const __nv_bfloat162*>(&o_own[r][i]);
          const __nv_bfloat162* b =
              reinterpret_cast<const __nv_bfloat162*>(&g4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 af = __bfloat1622float2(a[e]);
            const float2 bf = __bfloat1622float2(b[e]);
            part = fmaf(af.x, bf.x, part);
            part = fmaf(af.y, bf.y, part);
          }
        }
      }
      delta_r[r] = quad_sum(part);
      if (t4 == 0 && row_in[r])
        delta[(long long)ix.bh * L + ix.row0 + wrow + g + 8 * r] = delta_r[r];
    }
  }

  float acc[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // lane addresses inside a 16 x 16 piece: the col (B) operand read as it
  // lies, and the A or transposed-B operand
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  const int arow = lane & 15, acol = (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kDqStages - 2>();  // this thread's part of tile t has landed
    __syncthreads();  // everyone's has; tile t - 1 is done with by all warps
    if (t + kDqStages - 1 < n_tiles) request(t + kDqStages - 1);
    cp_async_commit();
    if (!active) continue;

    const bf16* sk =
        reinterpret_cast<const bf16*>(ring + (t % kDqStages) * kStageBytes);
    const bf16* sv = sk + kTile * LD;
    const int* sseg = reinterpret_cast<const int*>(sv + kTile * LD);
    const int k0 = t * kTile;

    // s = q_strip . k^T and dp = do_strip . v^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, qstrip + arow * LD + ks * 16 + acol);
      ldmatrix_x4(da, dostrip + arow * LD + ks * 16 + acol);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, sk + (np * 16 + brow) * LD + ks * 16 + bcol);
        mma_16x8x16(s[2 * np], qa, b[0], b[1]);
        mma_16x8x16(s[2 * np + 1], qa, b[2], b[3]);
        ldmatrix_x4(b, sv + (np * 16 + brow) * LD + ks * 16 + bcol);
        mma_16x8x16(dp[2 * np], da, b[0], b[1]);
        mma_16x8x16(dp[2 * np + 1], da, b[2], b[3]);
      }
    }

    // p = exp(s - lse), not rounded, and ds = (dp - delta) * p * scale, as
    // the stock backward forms them; ds rounded to bf16 and packed as the A
    // fragments of ds . k
    uint32_t dsf[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1), r = e >> 1;
        const bool inside = k0 + col < L && row_in[r];
        const float p =
            inside ? __expf(s[n][e] * scale +
                            (sseg[col] == segq[r] ? 0.f : kMaskValue) -
                            lse_r[r])
                   : 0.f;
        d[e] = ((dp[n][e] - delta_r[r]) * p) * scale;
      }
      dsf[n][0] = pack_bf16(d[0], d[1]);
      dsf[n][1] = pack_bf16(d[2], d[3]);
    }

    // dq_strip += ds . k
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {dsf[2 * kk][0], dsf[2 * kk][1],
                             dsf[2 * kk + 1][0], dsf[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < ON / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sk + (kk * 16 + arow) * LD + np * 16 + acol);
        mma_16x8x16(acc[2 * np], a, b[0], b[1]);
        mma_16x8x16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  if (!active) return;

  store_strip<HD>(dq + ix.batch * ds.b + ix.head * ds.h, ds.l, qstrip, acc,
                  1.f, 1.f, ix.row0 + wrow, L);
}

// How a sequence of L rows is cut into blocks: the fewest chunks of at most
// kMaxWarps strips, with the strips spread evenly over them.
struct Plan {
  int chunks, warps, stages;
};

Plan plan(int L, int ring_depth) {
  const int strips = (L + 15) / 16;
  const int tiles = (L + kTile - 1) / kTile;
  Plan p;
  p.chunks = (strips + kMaxWarps - 1) / kMaxWarps;
  p.warps = (strips + p.chunks - 1) / p.chunks;
  p.stages = tiles < ring_depth ? tiles : ring_depth;
  return p;
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg,
               void* o, float* lse, int B, int h, int L, Strides qs,
               Strides os, float scale, cudaStream_t stream) {
  const Plan p = plan(L, kStages);
  const size_t bytes = (size_t)p.warps * 16 * (HD + kRowPad) * sizeof(bf16) +
                       (size_t)p.stages * stage_bytes(HD, 1);
  const cudaError_t e = allow_shared(flash_fwd_mma_kernel<HD>, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_mma_kernel<HD><<<B * h * p.chunks, p.warps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg, static_cast<bf16*>(o), lse, h, L,
      p.chunks, qs, os, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_dkv(const void* q, const void* k, const void* v, const int* seg,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int h, int L, Strides qs,
                   Strides gs, Strides ds, float scale, cudaStream_t stream) {
  const Plan p = plan(L, kStages);
  const size_t bytes =
      (size_t)2 * p.warps * 16 * (HD + kRowPad) * sizeof(bf16) +
      (size_t)p.stages * stage_bytes(HD, 3);
  const cudaError_t e = allow_shared(flash_bwd_dkv_mma_kernel<HD>, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_mma_kernel<HD>
      <<<B * h * p.chunks, p.warps * 32, bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), seg, static_cast<const bf16*>(dout),
          lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, L,
          p.chunks, qs, gs, ds, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd_dq(const void* q, const void* k, const void* v, const int* seg,
                  const void* o, const void* dout, const float* lse,
                  float* delta, void* dq, int B, int h, int L, Strides qs,
                  Strides os, Strides gs, Strides ds, float scale,
                  cudaStream_t stream) {
  const Plan p = plan(L, kDqStages);
  const size_t bytes =
      (size_t)2 * p.warps * 16 * (HD + kRowPad) * sizeof(bf16) +
      (size_t)p.stages * stage_bytes(HD, 1);
  const cudaError_t e = allow_shared(flash_bwd_dq_mma_kernel<HD>, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_mma_kernel<HD>
      <<<B * h * p.chunks, p.warps * 32, bytes, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), seg, static_cast<const bf16*>(o),
          static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
          h, L, p.chunks, qs, os, gs, ds, scale);
  return (int)cudaGetLastError();
}

// Calls LAUNCH<HD>(args...) for the head dim (one of 16, 32, 64, 128: the
// caller has checked).
#define CAREL_FLASH_MMA_DISPATCH(LAUNCH, ...)     \
  switch (hd) {                                   \
    case 16: return LAUNCH<16>(__VA_ARGS__);      \
    case 32: return LAUNCH<32>(__VA_ARGS__);      \
    case 64: return LAUNCH<64>(__VA_ARGS__);      \
    case 128: return LAUNCH<128>(__VA_ARGS__);    \
    default: return (int)cudaErrorInvalidValue;   \
  }

}  // namespace

extern "C" {

// K7 for bf16; the arguments of carel_flash_fwd (flash.cu), which checks
// the shape and sends bf16 inputs here.
int carel_flash_fwd_bf16(const void* q, const void* k, const void* v,
                         const int* seg, void* o, float* lse, int B, int h,
                         int L, int hd, long long q_sb, long long q_sh,
                         long long q_sl, long long o_sb, long long o_sh,
                         long long o_sl, float scale, void* stream) {
  const Strides qs = {q_sb, q_sh, q_sl}, os = {o_sb, o_sh, o_sl};
  CAREL_FLASH_MMA_DISPATCH(launch_fwd, q, k, v, seg, o, lse, B, h, L, qs, os,
                           scale, (cudaStream_t)stream);
}

// K8 for bf16; the arguments of carel_flash_bwd_dkv (flash.cu).
int carel_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                             const int* seg, const void* dout,
                             const float* lse, const float* delta, void* dk,
                             void* dv, int B, int h, int L, int hd,
                             long long q_sb, long long q_sh, long long q_sl,
                             long long g_sb, long long g_sh, long long g_sl,
                             long long d_sb, long long d_sh, long long d_sl,
                             float scale, void* stream) {
  const Strides qs = {q_sb, q_sh, q_sl}, gs = {g_sb, g_sh, g_sl};
  const Strides ds = {d_sb, d_sh, d_sl};
  CAREL_FLASH_MMA_DISPATCH(launch_bwd_dkv, q, k, v, seg, dout, lse, delta, dk,
                           dv, B, h, L, qs, gs, ds, scale,
                           (cudaStream_t)stream);
}

// K9 for bf16; the arguments of carel_flash_bwd_dq (flash.cu).
int carel_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                            const int* seg, const void* o, const void* dout,
                            const float* lse, float* delta, void* dq, int B,
                            int h, int L, int hd, long long q_sb,
                            long long q_sh, long long q_sl, long long o_sb,
                            long long o_sh, long long o_sl, long long g_sb,
                            long long g_sh, long long g_sl, long long d_sb,
                            long long d_sh, long long d_sl, float scale,
                            void* stream) {
  const Strides qs = {q_sb, q_sh, q_sl}, os = {o_sb, o_sh, o_sl};
  const Strides gs = {g_sb, g_sh, g_sl}, ds = {d_sb, d_sh, d_sl};
  CAREL_FLASH_MMA_DISPATCH(launch_bwd_dq, q, k, v, seg, o, dout, lse, delta,
                           dq, B, h, L, qs, os, gs, ds, scale,
                           (cudaStream_t)stream);
}

}  // extern "C"

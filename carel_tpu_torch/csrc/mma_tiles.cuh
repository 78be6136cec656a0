// Tile helpers of the hand-written bf16 attention kernels on the Hopper
// tensor cores (flash_mma.cu: K7-K9; attn_xla_fwd.cu, attn_xla_bwd.cu: the
// xla attention core):
// cp.async loads into padded shared-memory rows, ldmatrix, mma.sync
// m16n8k16 with fp32 sums, and the quad reductions over a fragment row.
// Included by each source; everything has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowPad = 8;    // bf16 elements (16 bytes) of row padding

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes from device to shared memory, asynchronously; zeros when
// !valid (a source size of 0 reads nothing and fills the destination).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8; register j holds elements (lane / 4, 2 * (lane % 4) + {0, 1}) of
// matrix j, or with .trans of its transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c[16 x 8] += a[16 x 16] . b[16 x 8] in fp32. With g = lane / 4 and
// t = lane % 4: a holds (row g | g + 8, k 2t, 2t + 1 | + 8) in a[0..3]; b
// holds (k 2t, 2t + 1 | + 8, column g) in b0, b1; c holds (row g, columns
// 2t, 2t + 1) in c[0], c[1] and (row g + 8, same columns) in c[2], c[3].
__device__ __forceinline__ void mma_16x8x16(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Sum or max over the 4 lanes of a quad, which share a fragment row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// Requests rows row0 .. row0 + rows of a [L, HD] slice (row stride in
// elements) into a [rows][HD + kRowPad] tile; rows past L become zeros (an
// mma multiplies whatever is there).
template <int HD>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                long long row_stride, int row0,
                                                int rows, int L) {
  constexpr int C = HD / 8, LD = HD + kRowPad;
  for (int idx = threadIdx.x; idx < rows * C; idx += blockDim.x) {
    const int r = idx / C, c = idx % C;
    const bool in = row0 + r < L;
    cp_async16(dst + r * LD + c * 8,
               src + (long long)(in ? row0 + r : 0) * row_stride + c * 8, in);
  }
}

// The warp's 16 x HD fp32 fragments, times one factor per fragment row,
// rounded to bf16 into its own strip of shared memory, and from there to
// rows row0 .. row0 + 16 of dst in 16-byte stores; rows past L are not
// written.
template <int HD>
__device__ __forceinline__ void store_strip(bf16* dst, long long row_stride,
                                            bf16* strip,
                                            const float (&acc)[HD / 8][4],
                                            float f0, float f1, int row0,
                                            int L) {
  constexpr int C = HD / 8, LD = HD + kRowPad;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // the warp's reads of its strip are done
#pragma unroll
  for (int n = 0; n < C; ++n) {
    *reinterpret_cast<uint32_t*>(strip + g * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * f0, acc[n][1] * f0);
    *reinterpret_cast<uint32_t*>(strip + (g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * f1, acc[n][3] * f1);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * C; idx += 32) {
    const int r = idx / C, c = idx % C;
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * row_stride +
                                c * 8) =
          *reinterpret_cast<const uint4*>(strip + r * LD + c * 8);
  }
}

// Lets the kernel take `bytes` of dynamic shared memory, and asks for the
// SM's largest shared-memory carveout, so that the blocks per SM are those
// the registers allow.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

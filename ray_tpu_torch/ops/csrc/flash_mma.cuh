// Warp-level tensor-core pieces for the flash-attention kernels on Hopper
// (sm_90a): bf16 mma.sync m16n8k16 with f32 accumulators, ldmatrix (plain
// and transposed) from shared memory, and 16-byte cp.async with zero fill.
//
// Fragment layouts of mma.m16n8k16 (lane = 4g + t; g = lane / 4 is the
// row group, t = lane % 4 the thread in the quad):
//   A 16 x 16 (row-major), 4 x b32 of two bf16 each:
//     a0 = A[g][2t, 2t+1]   a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9] a3 = A[g+8][2t+8, 2t+9]
//   B 16 x 8 (k x n), 2 x b32: b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C 16 x 8, 4 x f32: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// So the C fragments of two n8 tiles side by side (n = 0..7 and 8..15),
// rounded to bf16 and packed in pairs (c0c1, c2c3 of the first, c0c1, c2c3
// of the second), are exactly an A fragment of the next product: a score
// tile feeds P.V from registers (FlashAttention-2's register reuse).
//
// A row-major [rows][d] bf16 tile in shared memory is read by
//   ldmatrix_x4       as A (rows = M) or as B of A.B^T (rows = N);
//   ldmatrix_x4_trans as B of A.B (rows = K).
// Rows are padded by 16 bytes (see the kernels), so the 8 row addresses
// of one 8 x 8 matrix fall on 8 distinct 4-bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, not cached in L1. With !valid nothing is read
// and the 16 bytes are zero (the src-size 0 form): rows past the end of a
// ragged matrix arrive as zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes global -> shared (cp.async.cg takes 16 bytes only, so through
// L1); zero with !valid. For f32 rows (lse, delta) of any length.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] is this lane's part of it (row g, columns 2t, 2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// The same, each matrix transposed: r[i] holds rows 2t, 2t+1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two f32 rounded to bf16 (to nearest even, as XLA's convert), lo in the
// low half: the element of the lower column index, as A fragments want.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragments of the 16 x 16 block at (row0, col0) of a row-major bf16 tile
// in shared memory with a row stride of LDS elements:
// ld_a:  the A operand (rows = M, columns = K);
// ld_bt: the B operand of A.B^T (rows = N, columns = K): r[0], r[1] are
//        b0, b1 of the n8 tile of rows row0..+7, r[2], r[3] of rows +8..+15;
// ld_b:  the B operand of A.B (rows = K, columns = N), by ldmatrix.trans:
//        r[0], r[1] for columns col0..+7, r[2], r[3] for columns +8..+15.
template <int LDS>
__device__ __forceinline__ void ld_a(uint32_t (&r)[4], const __nv_bfloat16* s, int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, s + (row0 + (lane & 15)) * LDS + col0 + (lane >> 4) * 8);
}
template <int LDS>
__device__ __forceinline__ void ld_bt(uint32_t (&r)[4], const __nv_bfloat16* s, int row0,
                                      int col0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, s + (row0 + (lane & 7) + ((lane >> 4) << 3)) * LDS + col0 + ((lane >> 3) & 1) * 8);
}
template <int LDS>
__device__ __forceinline__ void ld_b(uint32_t (&r)[4], const __nv_bfloat16* s, int row0, int col0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(r, s + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + col0 + (lane >> 4) * 8);
}

// Rows [row0, row0 + ROWS) of a row-major [nrows, D] bf16 matrix into smem
// [ROWS][D + 8] by 16-byte cp.async; rows at or past nrows are zeros.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                        int nrows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < (ROWS * CH + NTHREADS - 1) / NTHREADS; ++it) {
    const int i = it * NTHREADS + threadIdx.x;
    if (ROWS * CH % NTHREADS != 0 && i >= ROWS * CH) break;
    const int r = i / CH, c = i % CH, gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async_16(dst + r * (D + 8) + c * 8, src + (size_t)(ok ? gr : 0) * D + c * 8, ok);
  }
}

// A warp's 16 x D f32 accumulator (C fragments, n8 tile j = columns 8j..)
// rounded to bf16 through its own 16 rows of smem (stride D + 8), then out
// as 16-byte stores to rows row0.. of a row-major [nrows, D] matrix.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int row0, int nrows,
                                           const float (&acc)[D / 8][4], __nv_bfloat16* stage) {
  constexpr int LDS = D + 8, ND = D / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LDS + 8 * j + 2 * t) =
        pack_bf16x2(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LDS + 8 * j + 2 * t) =
        pack_bf16x2(acc[j][2], acc[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * ND; i += 32) {
    const int r = i / ND, c = i % ND;
    if (row0 + r < nrows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * D + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + 8 * c);
  }
}

// c += a . b on the tensor cores: bf16 operands, products exact, f32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Max / sum over the 4 lanes of a quad: the lanes holding one C row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Launch with a block of `threads`, after raising the dynamic shared-memory
// cap; returns the launch's own error.
template <typename Kernel, typename... Args>
inline cudaError_t launch_block(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream,
                               Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace rtt

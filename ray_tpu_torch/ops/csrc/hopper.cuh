// Hopper (sm_90a) pieces for the flash-attention kernels: mbarriers, TMA
// tile copies and their tensor maps, wgmma and its shared-memory
// descriptors, exact-f32 products from TMA-loaded f32 tiles, register
// rebalancing between warpgroups, named barriers, the warp-level helpers
// and launch they share, and the head-dim dispatch of every entry point.
//
// Shared-memory tiles are what a 3-D TMA box of a row-major [n, rows, cols]
// tensor leaves there: `rows` rows of CW = min(cols, 128 / element bytes)
// elements (64 bf16, 32 f32), a row being one swizzle span of CW elements
// (32, 64 or 128 bytes); wider rows (d = 128 in bf16, d >= 64 in f32) are
// cut into column blocks of CW, one box each, stored one after the other.
// Within an 8-row group the 16-byte chunks of a row are permuted by
// XOR with the row's index (Swizzle<B, 4, 3> on the byte address, 2^B =
// span / 16), which is what `swizzle()` computes and what TMA and wgmma
// read when both are told the same span. Tiles start on 1024-byte
// boundaries, so the pattern is the same on the absolute address.
//
// A wgmma descriptor of such a tile:
//   K-major (the reduced dimension along the row: Q and K of Q.K^T):
//     8-row groups SBO = 8 * span bytes apart; a k16 step inside the
//     span moves the start address by 32 bytes; LBO is not read.
//   MN-major (the reduced dimension down the rows: V of P.V, keys x d):
//     8-key groups SBO = 8 * span bytes apart, column blocks (64 of d)
//     LBO bytes apart; a k16 step moves the start by 16 rows.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;  // finite mask value, as _NEG_INF in the JAX op

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two f32 rounded to bf16 (to nearest even, as XLA's convert), lo in the
// low half: the element of the lower column index, as A fragments want.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also announces `bytes` to come by TMA on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// True once the phase of this parity has completed (a fresh barrier is in
// phase 0, so parity 1 reads as completed at once).
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Spins until the phase of this parity has completed. No timeout: a trap
// on the wait path makes ptxas keep the consumers at the launch's register
// count (168) instead of setmaxnreg's 240, and the forward then spills.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---- TMA -------------------------------------------------------------------

// The box at (c0, c1, c2) (innermost first) of the tensor map into shared
// memory at dst; its bytes complete the transaction on `bar`. Elements
// outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(desc), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Shared memory at src out to the box at (c0, c1, c2); elements outside the
// tensor are not written.
__device__ __forceinline__ void tma_store_3d(const void* map, uint32_t src, int c0, int c1,
                                             int c2) {
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(desc), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Waits until this thread's stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// This thread's generic writes to shared memory become visible to the
// async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared memory by its 32-bit address (a generic pointer would take two
// registers a use).
__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// ---- warpgroups ------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Barrier `id` (1..15; 0 is __syncthreads) over `n` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 2^x, flushing results below 2^-126 to zero (one MUFU instruction; exp2f
// adds a scaling pass for subnormal results, which the softmax never needs:
// p that small is 0 to bf16 and to the row sum alike).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- swizzled tiles and wgmma descriptors ----------------------------------

// Byte offset `off` of a tile with rows of SPAN bytes, as TMA and wgmma
// place it.
template <int SPAN>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (SPAN / 16 - 1)) << 4);
}
template <int SPAN>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(SPAN == 32 || SPAN == 64 || SPAN == 128, "swizzle span");
  constexpr uint64_t layout = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}
// K-major tile (rows of SPAN bytes along the reduced dimension).
template <int SPAN>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return wgmma_desc<SPAN>(addr, 16, 8 * SPAN);
}
// MN-major tile: rows along the reduced dimension, column blocks of one
// span `block_bytes` apart.
template <int SPAN>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t block_bytes) {
  return wgmma_desc<SPAN>(addr, block_bytes, 8 * SPAN);
}

// ---- wgmma -----------------------------------------------------------------

// Orders this warpgroup's register writes before the wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins an accumulator's registers at this point of the program: no read
// or write of them moves across it (around an asynchronous wgmma).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Accumulator of m64nNk16 (f32): thread 32w + 4g + t of the warpgroup holds,
// for each n8 column block j, d[4j + 0, 1] = D[16w + g][8j + 2t, +1] and
// d[4j + 2, 3] = D[16w + g + 8][8j + 2t, +1] -- mma.sync's C fragment,
// repeated along N. A from registers (bf16): a[0] = A[16w + g][2t, +1],
// a[1] = A[16w + g + 8][2t, +1], a[2] = A[16w + g][2t + 8, +9],
// a[3] = A[16w + g + 8][2t + 8, +9] -- mma.sync's A fragment. So two n8
// blocks of one accumulator, rounded and packed in pairs, are the A
// fragment of a k16 step of the next product.

// D (64 x N f32) {=, +=} A . B with N = 2 * (d's length): A (64 x 16)
// K-major and B in shared memory (descriptors a, b), B K-major (N x 16:
// A . B^T, TRANS_B = 0) or MN-major (16 x N, TRANS_B = 1); scale_d = 0
// overwrites D.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_m64k16(float (&d)[8], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_m64k16(float (&d)[16], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_m64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_m64k16(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
}

// D (64 x N f32) {=, +=} A . B with N = 2 * (d's length): A (64 x 16 bf16)
// from registers, B (16 x N) MN-major in shared memory (descriptor b);
// scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_m64k16(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64k16(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64k16(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// ---- exact f32 products from f32 tiles -------------------------------------
//
// The f32 backward kernels' products on the CUDA cores, from f32 tiles
// that TMA left in shared memory (column blocks of CW = min(D, 32)
// floats, R * CW apart, each row one swizzle span of SPAN = 4 * CW bytes,
// its 16-byte chunks permuted by XOR with a function of the row). Each
// output element is one fma chain from 0 over the reduced index,
// ascending -- the order of a sequential f32 GEMM (cuBLAS's SIMT kernels,
// which compute the plain versions), so the kernels' sums end on the
// plain version's bits. Each thread owns a register micro-tile and feeds
// it by 16-byte shared reads: a read of 4 values of each of its rows and
// columns serves 4 x (rows x columns) fmas.

// The XOR that permutes row r's 16-byte chunks (Swizzle<B, 4, 3> on the
// byte address, as TMA writes a tile with rows of SPAN bytes): the same for
// rows 8 apart.
template <int SPAN>
__device__ __forceinline__ int chunk_xor(int r) {
  return ((r * SPAN) >> 7) & (SPAN / 16 - 1);
}
// Index (in floats) of the 16-byte chunk holding columns c .. c + 3
// (c % 4 == 0) of row r of an f32 tile of R rows and D columns, given
// x = chunk_xor(r).
template <int D, int R>
__device__ __forceinline__ int f32_chunk(int r, int x, int c) {
  constexpr int CW = D < 32 ? D : 32;
  return (c / CW) * (R * CW) + r * CW + ((((c % CW) >> 2) ^ x) << 2);
}
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] = sum over c of A[ra + SA i][c] * B[rb + SB j][c], c = 0 .. D-1
// ascending, one fma chain an element: a score-shaped product (S, dP, S^T,
// dP^T) of two f32 tiles with the reduced dimension (d) along their rows.
// SA and SB are multiples of 8, so every row of the thread shares its
// tile's chunk XOR.
template <int D, int RA, int RB, int MI, int NJ, int SA, int SB>
__device__ __forceinline__ void mm_rows_f32(float (&acc)[MI][NJ], const float* A, int ra,
                                            const float* B, int rb) {
  constexpr int SPAN = 4 * (D < 32 ? D : 32);
  static_assert(SA % 8 == 0 && SB % 8 == 0, "rows that share a chunk XOR");
  const int xa = chunk_xor<SPAN>(ra), xb = chunk_xor<SPAN>(rb);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    float4 a[MI], b[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + f32_chunk<D, RA>(ra + SA * i, xa, c));
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + f32_chunk<D, RB>(rb + SB * j, xb, c));
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = fmaf(lane4(a[i], cc), lane4(b[j], cc), acc[i][j]);
  }
}

// acc[i][j] += sum over k of P[rp + SP i][k] * B[k][8 cg + j], k = 0 .. NK-1
// ascending, continuing each element's fma chain: an output-shaped product
// (dV, dK, dQ). P is a row-major f32 buffer with rows LDP floats apart
// (P^T, dS^T or dS), B an f32 tile of NK rows and D columns; the thread
// owns columns 8 cg .. 8 cg + 7.
template <int D, int NK, int MI, int SP, int LDP>
__device__ __forceinline__ void mm_pb_f32(float (&acc)[MI][8], const float* P, int rp,
                                          const float* B, int cg) {
  constexpr int SPAN = 4 * (D < 32 ? D : 32);
#pragma unroll
  for (int k = 0; k < NK; k += 4) {
    float4 p[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (rp + SP * i) * LDP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int x = chunk_xor<SPAN>(k + kk);
      const float4 b0 = *reinterpret_cast<const float4*>(B + f32_chunk<D, NK>(k + kk, x, 8 * cg));
      const float4 b1 =
          *reinterpret_cast<const float4*>(B + f32_chunk<D, NK>(k + kk, x, 8 * cg + 4));
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(lane4(p[i], kk), bv[j], acc[i][j]);
    }
  }
}

// ---- host: tensor maps ----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (null if the
// driver does not have it).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A row-major [n, rows, cols] bf16 (or, with f32, float32) tensor, read or
// written in boxes of box_rows x box_cols of one head, swizzled by the box
// row's bytes (32, 64 or 128).
inline bool tensor_map_3d(CUtensorMap* map, const void* ptr, int n, int rows, int cols,
                          int box_rows, int box_cols, bool f32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t esz = f32 ? 4 : 2, span = box_cols * esz;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * esz, (cuuint64_t)rows * cols * esz};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace rtt

// Return LAUNCH with D = head_dim in {16, 32, 64, 128} (any other head_dim
// returns cudaErrorInvalidValue).
#define RTT_DISPATCH_D(HEAD_DIM, LAUNCH)                                       \
  do {                                                                         \
    switch (HEAD_DIM) {                                                        \
      case 16: { constexpr int D = 16; return (int)(LAUNCH); }                 \
      case 32: { constexpr int D = 32; return (int)(LAUNCH); }                 \
      case 64: { constexpr int D = 64; return (int)(LAUNCH); }                 \
      case 128: { constexpr int D = 128; return (int)(LAUNCH); }               \
    }                                                                          \
    return (int)cudaErrorInvalidValue;                                         \
  } while (0)

// Dynamic shared memory a kernel's block takes at this head_dim (-1 if the
// head_dim is not instantiated).
#define RTT_SMEM_BYTES(FN, HEAD_DIM)                                           \
  do {                                                                         \
    switch (HEAD_DIM) {                                                        \
      case 16: return (int)FN<16>();                                           \
      case 32: return (int)FN<32>();                                           \
      case 64: return (int)FN<64>();                                           \
      case 128: return (int)FN<128>();                                         \
    }                                                                          \
    return -1;                                                                 \
  } while (0)

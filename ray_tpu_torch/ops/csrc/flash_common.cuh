// Shared pieces of the three f32 flash-attention kernels on the CUDA cores
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu); bf16 runs on the
// tensor-core kernels (*_tc.cu, helpers in flash_mma.cuh).
//
// Design (all three kernels): one thread block of 256 threads (16 x 16)
// owns a 64-row tile of its output and walks the other operand's 64-row
// tiles in a loop inside the block -- the loop takes the place of the
// Pallas kernels' sequential "arbitrary" grid axis, whose sum was carried
// in VMEM scratch. Tiles are staged in shared memory, rows padded to D+1
// floats so that the strided per-thread access below is free of bank
// conflicts. Each thread computes a 4 x 4 micro-tile of
// every score-shaped product (rows ty+16i, columns tx+16j) and a
// 4 x D/16 micro-tile of every output-shaped product (columns tx+16q),
// with scalar FMA and f32 accumulators. Ragged edges are masked in the
// kernel; the causal diagonal is the loop bound plus a per-element mask.
//
// Bound on the H100: the work is matrix products (compute-bound at the
// model's shapes: 4*S^2*d/2 causal FLOPs against 4*S*d*2 bytes per head).
// Scalar FMA on the CUDA cores reaches at most 67 TFLOP/s; a tensor-core
// f32 product would be TF32, which cannot meet the f32 parity bound.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

constexpr int BM = 64;    // rows of the tile a block owns
constexpr int BN = 64;    // rows of each streamed tile
constexpr int NT = 256;   // threads per block: 16 (tx) x 16 (ty)
constexpr int LDP = BN + 1;  // padded row length of a score tile in smem
constexpr float NEG_INF = -1e30f;  // finite mask value, as _NEG_INF in the JAX op

// Sum / max over the 16 lanes (tx = 0..15) that share one ty.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Stage rows [row0, row0 + ROWS) of a row-major [nrows, D] matrix in smem
// as [ROWS][D + 1]; rows past nrows are zero. Consecutive threads read
// consecutive elements of a row (coalesced).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          int row0, int nrows) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int gr = row0 + r;
    dst[r * LD + c] = gr < nrows ? src[(size_t)gr * D + c] : 0.f;
  }
}

// acc[i][j] = sum_c A[ty + 16i][c] * B[tx + 16j][c], A and B in smem
// [64][D + 1]: a score-shaped product (Q.K^T, dO.V^T, K.Q^T, V.dO^T).
template <int D>
__device__ __forceinline__ void mm_abt(float acc[4][4], const float* __restrict__ A,
                                       const float* __restrict__ B, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][q] += sum_j P[ty + 16i][j] * V[j][tx + 16q], P in smem [64][LDP],
// V in smem [64][D + 1]: an output-shaped product (P.V, dS.K, P^T.dO,
// dS^T.Q).
template <int D>
__device__ __forceinline__ void mm_ab(float acc[4][D / 16], const float* __restrict__ P,
                                      const float* __restrict__ V, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int j = 0; j < BN; ++j) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * LDP + j];
#pragma unroll
    for (int q = 0; q < D / 16; ++q) {
      const float v = V[j * LD + tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][q] = fmaf(p[i], v, acc[i][q]);
    }
  }
}

// Raise the block's dynamic shared-memory cap, launch, and report the
// launch's own error (a refused launch never runs, and a later
// synchronize does not report it).
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
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

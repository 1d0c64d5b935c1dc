// Flash-attention backward, dk/dv pass (FlashAttention-2), f32.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_bwd_dkv_kernel (second
// pallas_call of _flash_bwd) for f32 inputs. rtt_flash_bwd_dkv below hands
// bf16 inputs to the tensor-core kernel of flash_bwd_dkv_tc.cu; f32 stays
// here, on the CUDA cores, because a tensor-core f32 product is TF32 and
// cannot meet the f32 parity bound. For every (batch*kv_head, key row):
//   dv = sum over the GQA group's q heads and all q rows of P^T . dO
//   dk = sum of the same of dS^T . Q
// with P = exp(q.K^T * scale - lse) and dS = P o (dO.V^T - delta) * scale.
//
// Grid (ceil(Sk/64), b*hk); one block owns 64 key rows (K, V resident) and
// loops over every q head of its GQA group and every q tile from the
// causal diagonal down. The sum over the group and the q tiles stays in
// registers for the whole loop -- no atomics, no second pass -- which is
// what the Pallas kernel's inner "arbitrary" grid axis did in VMEM.
//
// Bound: compute (four matrix products per tile pair, 2x the forward).
// Each Q/dO tile is read once per block, and every shared-memory value
// feeds 4 FMAs, on the CUDA cores (67 TFLOP/s f32 peak).
#include "flash_common.cuh"

namespace rtt {

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * ((2 * BM + 2 * BN) * (D + 1) + 2 * BM * LDP + 2 * BN);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int h, int hk, int sq,
                     int sk, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DQ = D / 16;
  float* Ks = smem;
  float* Vs = Ks + BM * LD;
  float* Qs = Vs + BM * LD;
  float* dOs = Qs + BN * LD;
  float* Pt = dOs + BN * LD;
  float* dSt = Pt + BM * LDP;
  float* lse_s = dSt + BM * LDP;
  float* delta_s = lse_s + BN;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bkv = blockIdx.y;
  const int group = h / hk;
  const int qh0 = (bkv / hk) * h + (bkv % hk) * group;  // first q head of the group
  const int k0 = blockIdx.x * BM;

  load_tile<D, BM>(Ks, k + (size_t)bkv * sk * D, k0, sk);
  load_tile<D, BM>(Vs, v + (size_t)bkv * sk * D, k0, sk);

  float dk_acc[4][DQ], dv_acc[4][DQ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DQ; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nqb = (sq + BN - 1) / BN;
  const int qb0 = causal ? k0 / BN : 0;  // q tiles above the diagonal see none of these keys
  for (int g = 0; g < group; ++g) {
    const int bh = qh0 + g;
    for (int qb = qb0; qb < nqb; ++qb) {
      const int q0 = qb * BN;
      __syncthreads();
      load_tile<D, BN>(Qs, q + (size_t)bh * sq * D, q0, sq);
      load_tile<D, BN>(dOs, dout + (size_t)bh * sq * D, q0, sq);
      if (threadIdx.x < BN) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < sq ? lse[(size_t)bh * sq + qi] : 0.f;
        delta_s[threadIdx.x] = qi < sq ? delta[(size_t)bh * sq + qi] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];  // transposed tiles: row = key, column = query
      mm_abt<D>(st, Ks, Qs, ty, tx);
      mm_abt<D>(dpt, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int qi = q0 + r;
          const bool ok = qi < sq && kj < sk && (!causal || qi >= kj);
          const float p = ok ? expf(st[i][j] * scale - lse_s[r]) : 0.f;
          const float ds = p * (dpt[i][j] - delta_s[r]) * scale;
          Pt[(ty + 16 * i) * LDP + r] = p;
          dSt[(ty + 16 * i) * LDP + r] = ds;
        }
      }
      __syncthreads();
      mm_ab<D>(dv_acc, Pt, dOs, ty, tx);
      mm_ab<D>(dk_acc, dSt, Qs, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= sk) continue;
    float* dkrow = dk + ((size_t)bkv * sk + kj) * D;
    float* dvrow = dv + ((size_t)bkv * sk + kj) * D;
#pragma unroll
    for (int c = 0; c < DQ; ++c) {
      dkrow[tx + 16 * c] = dk_acc[i][c];
      dvrow[tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// flash_bwd_dkv_tc.cu: the bf16 kernel
int flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int bkv, int h, int hk,
                     int sq, int sk, int head_dim, float scale, int causal, void* stream);

}  // namespace rtt

// q, dout [b*h, sq, d]; k, v, dk, dv [b*hk, sk, d]; lse, delta [b*h, sq] f32.
// dtype 0 = float32 (CUDA cores, here), 1 = bfloat16 (tensor cores).
extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int bkv, int h, int hk, int sq, int sk, int head_dim,
                                 float scale, int causal, int dtype, void* stream) {
  if (dtype == 1)
    return rtt::flash_bwd_dkv_tc(q, k, v, dout, lse, delta, dk, dv, bkv, h, hk, sq, sk, head_dim,
                                 scale, causal, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((sk + rtt::BM - 1) / rtt::BM, bkv);
  RTT_DISPATCH_D(head_dim,
                 rtt::launch(rtt::flash_bwd_dkv_kernel<D>, grid, rtt::dkv_smem_bytes<D>(), stream,
                             static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), static_cast<const float*>(dout),
                             static_cast<const float*>(lse), static_cast<const float*>(delta),
                             static_cast<float*>(dk), static_cast<float*>(dv), h, hk, sq, sk,
                             scale, causal));
}

extern "C" int rtt_flash_bwd_dkv_smem_bytes(int head_dim) { RTT_SMEM_BYTES(rtt::dkv_smem_bytes, head_dim); }

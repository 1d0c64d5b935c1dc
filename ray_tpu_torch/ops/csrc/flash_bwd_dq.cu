// Flash-attention backward, dq pass (FlashAttention-2), f32.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_bwd_dq_kernel (first
// pallas_call of _flash_bwd) for f32 inputs. rtt_flash_bwd_dq below hands
// bf16 inputs to the tensor-core kernel of flash_bwd_dq_tc.cu; f32 stays
// here, on the CUDA cores, because a tensor-core f32 product is TF32 and
// cannot meet the f32 parity bound. For every (batch*head, query row):
//   P  = exp(q.K^T * scale - lse)
//   dS = P o (dO.V^T - delta) * scale
//   dq = dS . K
// with delta = rowsum(dO o O) computed by the caller.
//
// Grid (ceil(Sq/64), b*h); one block owns 64 query rows (Q, dO, lse, delta
// stay resident) and loops over the K/V tiles up to the causal diagonal;
// the dq sum stays in registers for the whole loop. GQA reads the shared
// kv head in place.
//
// Bound: compute (three matrix products per tile pair, 1.5x the forward).
// The design reads each K/V tile once per block and feeds 4 FMAs from
// every shared-memory value, on the CUDA cores (67 TFLOP/s f32 peak).
#include "flash_common.cuh"

namespace rtt {

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((2 * BM + 2 * BN) * (D + 1) + BM * LDP);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int h, int hk, int sq, int sk, float scale,
                    int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DQ = D / 16;
  float* Qs = smem;
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* dSs = Vs + BN * LD;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int bkv = (bh / h) * hk + (bh % h) / (h / hk);
  const int q0 = blockIdx.x * BM;
  const float* kp = k + (size_t)bkv * sk * D;
  const float* vp = v + (size_t)bkv * sk * D;

  load_tile<D, BM>(Qs, q + (size_t)bh * sq * D, q0, sq);
  load_tile<D, BM>(dOs, dout + (size_t)bh * sq * D, q0, sq);

  float row_lse[4], row_delta[4], acc[4][DQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    row_lse[i] = qi < sq ? lse[(size_t)bh * sq + qi] : 0.f;
    row_delta[i] = qi < sq ? delta[(size_t)bh * sq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < DQ; ++c) acc[i][c] = 0.f;
  }

  int nkb = (sk + BN - 1) / BN;
  if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();
    load_tile<D, BN>(Ks, kp, k0, sk);
    load_tile<D, BN>(Vs, vp, k0, sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    mm_abt<D>(s, Qs, Ks, ty, tx);
    mm_abt<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = qi < sq && kj < sk && (!causal || qi >= kj);
        const float p = ok ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        const float ds = p * (dp[i][j] - row_delta[i]) * scale;
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    mm_ab<D>(acc, dSs, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    float* row = dq + ((size_t)bh * sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DQ; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

// flash_bwd_dq_tc.cu: the bf16 kernel
int flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, int bh, int h, int hk, int sq, int sk,
                    int head_dim, float scale, int causal, void* stream);

}  // namespace rtt

// q, dout, dq [b*h, sq, d]; k, v [b*hk, sk, d]; lse, delta [b*h, sq] f32.
// dtype 0 = float32 (CUDA cores, here), 1 = bfloat16 (tensor cores).
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int bh, int h,
                                int hk, int sq, int sk, int head_dim, float scale, int causal,
                                int dtype, void* stream) {
  if (dtype == 1)
    return rtt::flash_bwd_dq_tc(q, k, v, dout, lse, delta, dq, bh, h, hk, sq, sk, head_dim, scale,
                                causal, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + rtt::BM - 1) / rtt::BM, bh);
  RTT_DISPATCH_D(head_dim,
                 rtt::launch(rtt::flash_bwd_dq_kernel<D>, grid, rtt::dq_smem_bytes<D>(), stream,
                             static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), static_cast<const float*>(dout),
                             static_cast<const float*>(lse), static_cast<const float*>(delta),
                             static_cast<float*>(dq), h, hk, sq, sk, scale, causal));
}

extern "C" int rtt_flash_bwd_dq_smem_bytes(int head_dim) { RTT_SMEM_BYTES(rtt::dq_smem_bytes, head_dim); }

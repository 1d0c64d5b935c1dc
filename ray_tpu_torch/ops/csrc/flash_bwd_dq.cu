// Flash-attention backward, dq pass (FlashAttention-2).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_bwd_dq_kernel (first
// pallas_call of _flash_bwd). For every (batch*head, query row):
//   P  = exp(q.K^T * scale - lse)
//   dS = P o (dO.V^T - delta) * scale, rounded to K's dtype
//   dq = dS . K                              (f32 sum, q's dtype)
// with delta = rowsum(dO o O) computed by the caller.
//
// Grid (ceil(Sq/64), b*h); one block owns 64 query rows (Q, dO, lse, delta
// stay resident) and loops over the K/V tiles up to the causal diagonal;
// the dq sum stays in registers for the whole loop. GQA reads the shared
// kv head in place.
//
// Bound: compute (three matrix products per tile pair, 1.5x the forward).
// The design reads each K/V tile once per block and feeds 4 FMAs from
// every shared-memory value; CUDA cores only, tensor cores are later work.
#include "flash_common.cuh"

namespace rtt {

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((2 * BM + 2 * BN) * (D + 1) + BM * LDP);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int h, int hk, int sq,
                    int sk, float scale, int causal) {
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
  const T* kp = k + (size_t)bkv * sk * D;
  const T* vp = v + (size_t)bkv * sk * D;

  load_tile<T, D, BM>(Qs, q + (size_t)bh * sq * D, q0, sq);
  load_tile<T, D, BM>(dOs, dout + (size_t)bh * sq * D, q0, sq);

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
    load_tile<T, D, BN>(Ks, kp, k0, sk);
    load_tile<T, D, BN>(Vs, vp, k0, sk);
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
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    mm_ab<D>(acc, dSs, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    T* row = dq + ((size_t)bh * sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DQ; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

}  // namespace rtt

// q, dout, dq [b*h, sq, d]; k, v [b*hk, sk, d]; lse, delta [b*h, sq] f32.
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int bh, int h,
                                int hk, int sq, int sk, int head_dim, float scale, int causal,
                                int dtype, void* stream) {
  const dim3 grid((sq + rtt::BM - 1) / rtt::BM, bh);
  RTT_DISPATCH(dtype, head_dim,
               rtt::launch(rtt::flash_bwd_dq_kernel<T, D>, grid, rtt::dq_smem_bytes<D>(), stream,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<const T*>(dout),
                           static_cast<const float*>(lse), static_cast<const float*>(delta),
                           static_cast<T*>(dq), h, hk, sq, sk, scale, causal));
}

extern "C" int rtt_flash_bwd_dq_smem_bytes(int head_dim) { RTT_SMEM_BYTES(rtt::dq_smem_bytes, head_dim); }

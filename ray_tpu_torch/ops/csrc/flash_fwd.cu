// Flash-attention forward (FlashAttention-2, online softmax), f32.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched
// by _flash_fwd) for f32 inputs. rtt_flash_fwd below hands bf16 inputs to
// the tensor-core kernel of flash_fwd_tc.cu; f32 stays here, on the CUDA
// cores, because a tensor-core f32 product is TF32 and cannot meet the f32
// parity bound. Computes, for every (batch*head, query row),
//   o   = softmax(q.K^T * scale) . V
//   lse = m + log(l)                       (f32, saved for the backward)
// keeping (m, l, acc) in registers; rows with l = 0 are clamped at 1e-30,
// as the Pallas kernel does.
//
// Grid (ceil(Sq/64), b*h); one block owns 64 query rows and loops over the
// K/V tiles up to the causal diagonal. GQA: the block reads the K/V of
// kv head (bh % h) / (h / hk) in place -- repeated K/V never exists.
//
// Bound: compute (matrix products). What the design does about it: Q stays
// in shared memory for the whole loop, each K/V tile is read once per
// block, causal tiles above the diagonal are never loaded, and every
// shared-memory value feeds 4 FMAs (4 x 4 register micro-tiles). It runs
// on the CUDA cores (67 TFLOP/s f32 peak).
#include "flash_common.cuh"

namespace rtt {

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * ((BM + 2 * BN) * (D + 1) + BM * LDP);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int h, int hk, int sq, int sk, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DQ = D / 16;
  float* Qs = smem;
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int bkv = (bh / h) * hk + (bh % h) / (h / hk);
  const int q0 = blockIdx.x * BM;
  const float* kp = k + (size_t)bkv * sk * D;
  const float* vp = v + (size_t)bkv * sk * D;

  load_tile<D, BM>(Qs, q + (size_t)bh * sq * D, q0, sq);

  float m[4], l[4], acc[4][DQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DQ; ++c) acc[i][c] = 0.f;
  }

  int nkb = (sk + BN - 1) / BN;
  if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();  // the previous tile's readers of Ks/Vs/Ps are done
    load_tile<D, BN>(Ks, kp, k0, sk);
    load_tile<D, BN>(Vs, vp, k0, sk);
    __syncthreads();

    float s[4][4];
    mm_abt<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < sk && (!causal || qi >= kj);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DQ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mm_ab<D>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)bh * sq + qi) * D;
#pragma unroll
    for (int c = 0; c < DQ; ++c) orow[tx + 16 * c] = acc[i][c] / lc;
    if (tx == 0) lse[(size_t)bh * sq + qi] = m[i] + logf(lc);
  }
}

// flash_fwd_tc.cu: the bf16 kernel
int flash_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int h,
                 int hk, int sq, int sk, int head_dim, float scale, int causal, void* stream);

}  // namespace rtt

// q [b*h, sq, d]; k, v [b*hk, sk, d]; o like q; lse [b*h, sq] f32.
// dtype 0 = float32 (CUDA cores, here), 1 = bfloat16 (tensor cores).
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int h, int hk, int sq, int sk, int head_dim, float scale,
                             int causal, int dtype, void* stream) {
  if (dtype == 1)
    return rtt::flash_fwd_tc(q, k, v, o, lse, bh, h, hk, sq, sk, head_dim, scale, causal, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + rtt::BM - 1) / rtt::BM, bh);
  RTT_DISPATCH_D(head_dim,
                 rtt::launch(rtt::flash_fwd_kernel<D>, grid, rtt::fwd_smem_bytes<D>(), stream,
                             static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), static_cast<float*>(o),
                             static_cast<float*>(lse), h, hk, sq, sk, scale, causal));
}

extern "C" int rtt_flash_fwd_smem_bytes(int head_dim) { RTT_SMEM_BYTES(rtt::fwd_smem_bytes, head_dim); }

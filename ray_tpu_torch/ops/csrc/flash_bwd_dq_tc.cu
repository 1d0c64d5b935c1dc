// Flash-attention backward, dq pass, on the tensor cores (bf16;
// FlashAttention-2).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_bwd_dq_kernel (first
// pallas_call of _flash_bwd) for bf16 inputs; f32 stays on flash_bwd_dq.cu
// (a tensor-core f32 product is TF32). For every (batch*head, query row):
//   p  = exp(q.k * scale - lse)                         (f32)
//   dS = p o (dO.v - delta) * scale, rounded to bf16
//   dq = sum over keys of dS . k                        (f32 sum, bf16)
// with the causal mask top-left aligned, masked p at 0, ragged lengths
// masked, not padded, and GQA's kv head read in place.
//
// Bound: operations. 3 products of 2*b*h*pairs*d FLOP each (pairs = the
// (q, k) pairs the mask keeps) over 989 TFLOP/s of bf16 tensor cores; the
// bytes (q, k, v, dO, lse, delta read once, dq written once) take 6x less
// time at the training shapes. What the design does about it:
// - The forward's design with V's role changed. Each warp owns 16 query
//   rows, a block of 4 warps 64. Q and dO are read once into registers as
//   A fragments (ldmatrix). S = Q.K^T and dP = dO.V^T take K and V by plain
//   ldmatrix ([key][d] row-major is B's column-major); the C fragments of
//   dS, rounded and packed in pairs, are the A fragments of dQ += dS.K (K by
//   ldmatrix.trans): dS never leaves the registers.
// - lse and delta are per row: two values a lane, in registers. There is
//   no online maximum, so the K tile is taken 16 keys at a time: S and dP
//   are 2 n8 tiles (8 registers) each.
// - dQ is summed through mma.sync's accumulator over the whole key loop.
//   Its f32 sum rounds toward zero at every step, which biases dk and dv
//   too far (see flash_bwd_dkv_tc.cu), but not dq: a row's sum spans one
//   head's keys, and dS changes sign, so a fresh accumulator per slice
//   would cost registers and time for no accuracy the bound needs.
// - K/V tiles come by 16-byte cp.async into a two-stage ring: tile j+1 is
//   in flight while tile j is computed. Rows are padded by 16 bytes, so
//   ldmatrix is free of bank conflicts; rows past sk arrive as zeros.
// - Causal: the loop stops at the q tile's last K tile; only diagonal and
//   ragged slices take the per-element mask; a warp whose 16 rows all come
//   before a slice's first key skips the slice. The heaviest causal q tiles
//   launch first (blockIdx.y reversed, with b*h on blockIdx.x).
// - dq goes out through shared memory as 16-byte stores.
// Later work: wgmma, TMA with mbarriers, warp specialisation.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace rtt {

constexpr int DQ_WARPS = 4;  // warps per block, 16 query rows each
constexpr int DQ_BN = 64;    // keys per K/V tile

// Two ring stages, each a K tile then a V tile of DQ_BN rows of D + 8 bf16.
template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * 2 * 2 * DQ_BN * (D + 8);
}

template <int D, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int h, int hk, int sq, int sk, float scale,
                       int causal) {
  constexpr int BM = 16 * WARPS, BN = DQ_BN, LDS = D + 8, NTHREADS = 32 * WARPS;
  constexpr int ND = D / 8, KC = D / 16;  // n8 tiles of dq, k16 chunks of d
  constexpr int STAGE = 2 * BN * LDS;     // K then V
  static_assert(D % 16 == 0 && BM <= BN, "Q and dO must fit in one ring stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int bkv = (bh / h) * hk + (bh % h) / (h / hk);
  const __nv_bfloat16* kp = k + (size_t)bkv * sk * D;
  const __nv_bfloat16* vp = v + (size_t)bkv * sk * D;

  int nkb = (sk + BN - 1) / BN;
  if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1);

  // Q and dO into stage 1 (free until tile 1 is issued), tile 0 into stage 0.
  cp_tile<D, BM, NTHREADS>(smem + STAGE, q + (size_t)bh * sq * D, q0, sq);
  cp_tile<D, BM, NTHREADS>(smem + STAGE + BM * LDS, dout + (size_t)bh * sq * D, q0, sq);
  cp_async_commit();
  cp_tile<D, BN, NTHREADS>(smem, kp, 0, sk);
  cp_tile<D, BN, NTHREADS>(smem + BN * LDS, vp, 0, sk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[KC][4], oa[KC][4];  // A fragments of Q and dO
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    ld_a<LDS>(qa[kc], smem + STAGE, 16 * warp, 16 * kc);
    ld_a<LDS>(oa[kc], smem + STAGE + BM * LDS, 16 * warp, 16 * kc);
  }
  __syncthreads();

  const int qw0 = q0 + 16 * warp;  // this warp's first row
  const int row[2] = {qw0 + g, qw0 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < sq;
    lse_r[r] = ok ? lse[(size_t)bh * sq + row[r]] : 0.f;
    delta_r[r] = ok ? delta[(size_t)bh * sq + row[r]] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BN;
    if (kb + 1 < nkb) {
      __nv_bfloat16* nxt = smem + ((kb + 1) & 1) * STAGE;
      cp_tile<D, BN, NTHREADS>(nxt, kp, k0 + BN, sk);
      cp_tile<D, BN, NTHREADS>(nxt + BN * LDS, vp, k0 + BN, sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kb has landed (this thread's copies) ...
    __syncthreads();     // ... and every thread's
    const __nv_bfloat16* Ks = smem + (kb & 1) * STAGE;
    const __nv_bfloat16* Vs = Ks + BN * LDS;

    for (int ks = 0; ks < BN / 16; ++ks) {
      const int ks0 = k0 + 16 * ks;  // the slice's first key
      if (ks0 >= sk || (causal && ks0 > qw0 + 15)) continue;  // no visible (row, key) pair
      // S = Q.K^T and dP = dO.V^T; n8 tile j holds keys ks0 + 8j ..
      float s[2][4], dps[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dps[j][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t b[4];
        ld_bt<LDS>(b, Ks, 16 * ks, 16 * kc);
        mma_bf16_16816(s[0], qa[kc], b[0], b[1]);
        mma_bf16_16816(s[1], qa[kc], b[2], b[3]);
        ld_bt<LDS>(b, Vs, 16 * ks, 16 * kc);
        mma_bf16_16816(dps[0], oa[kc], b[0], b[1]);
        mma_bf16_16816(dps[1], oa[kc], b[2], b[3]);
      }

      // element (j, i): row row[i / 2], key ks0 + 8j + 2t + (i & 1)
      const bool edge = ks0 + 16 > sk || (causal && ks0 + 15 > qw0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = expf(s[j][i] * scale - lse_r[i / 2]);
          if (edge) {
            const int key = ks0 + 8 * j + 2 * t + (i & 1);
            if (key >= sk || (causal && key > row[i / 2])) p = 0.f;
          }
          s[j][i] = p * (dps[j][i] - delta_r[i / 2]) * scale;  // dS
        }
      const float* dsf = &s[0][0];
      uint32_t pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = pack_bf16x2(dsf[2 * i], dsf[2 * i + 1]);

      // dQ += dS.K over the slice's 16 keys
#pragma unroll
      for (int dp = 0; dp < KC; ++dp) {
        uint32_t b[4];
        ld_b<LDS>(b, Ks, 16 * ks, 16 * dp);
        mma_bf16_16816(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16_16816(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // this warp's 16 rows of stage 0, read by no one now, stage the output
  store_rows<D>(dq + (size_t)bh * sq * D, qw0, sq, acc, smem + 16 * warp * LDS);
}

template <int D>
int dq_tc_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int bh, int h, int hk, int sq, int sk, float scale,
                 int causal, void* stream) {
  constexpr int BM = 16 * DQ_WARPS;
  const dim3 grid(bh, (sq + BM - 1) / BM);
  return (int)launch_block(flash_bwd_dq_tc_kernel<D, DQ_WARPS>, grid, 32 * DQ_WARPS,
                           dq_tc_smem_bytes<D>(), stream, static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
                           static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), h,
                           hk, sq, sk, scale, causal);
}

// The bf16 route of rtt_flash_bwd_dq (flash_bwd_dq.cu). q, k, v and dout
// must be 16-byte aligned (the wrapper checks).
int flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, int bh, int h, int hk, int sq, int sk,
                    int head_dim, float scale, int causal, void* stream) {
  RTT_DISPATCH_D(head_dim, dq_tc_launch<D>(q, k, v, dout, lse, delta, dq, bh, h, hk, sq, sk, scale,
                                            causal, stream));
}

}  // namespace rtt

extern "C" int rtt_flash_bwd_dq_tc_smem_bytes(int head_dim) {
  RTT_SMEM_BYTES(rtt::dq_tc_smem_bytes, head_dim);
}

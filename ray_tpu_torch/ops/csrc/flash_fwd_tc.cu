// Flash-attention forward on the tensor cores (bf16; FlashAttention-2).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched
// by _flash_fwd) for bf16 inputs; f32 stays on flash_fwd.cu (a tensor-core
// f32 product is TF32). Computes, for every (batch*head, query row),
//   o   = softmax(q.K^T * scale) . V       (bf16)
//   lse = m + log(max(l, 1e-30))           (f32, saved for the backward)
// with (m, l, acc) in f32 registers, p rounded to bf16 before P.V (the
// Pallas kernel's p.astype(v.dtype)), l summed from the unrounded p, the
// causal mask top-left aligned, and masked scores at the finite -1e30.
//
// Bound: operations. 2 products of 2*b*h*pairs*d FLOP each (pairs = the
// (q, k) pairs the mask keeps) over 989 TFLOP/s of bf16 tensor cores; the
// bytes (q, k, v read once, o and lse written once) take 5x less time at
// the training shapes. What the design does about it:
// - Both products are mma.sync m16n8k16 bf16 with f32 accumulators: a
//   bf16 product accumulated in f32, what the Pallas kernel asks for with
//   preferred_element_type=f32.
// - Each warp owns 16 whole query rows, so a row's max and sum are a
//   shuffle over the 4 lanes of a quad. Q is read once into registers as
//   A fragments (ldmatrix). K is the B operand of Q.K^T (plain ldmatrix:
//   [key][d] row-major is B's column-major); V is the B operand of P.V
//   (ldmatrix.trans). P never leaves the registers: the score fragments,
//   rounded to bf16, are the A fragments of P.V.
// - Shared memory holds bf16 tiles, rows padded by 16 bytes so ldmatrix is
//   free of bank conflicts. K/V tiles come by 16-byte cp.async into a
//   two-stage ring: tile j+1 is in flight while tile j is computed. Rows
//   past sk (or sq) arrive as zeros (src-size 0), so ragged lengths need
//   no padding.
// - The causal loop stops at the q tile's last K tile; only the diagonal
//   and ragged tiles take the per-element mask, and masked p is set to 0.
//   A warp whose rows all lie above a tile skips it. The heaviest causal q
//   tiles launch first (blockIdx.y reversed, with b*h on blockIdx.x).
// Later work: wgmma, TMA with mbarriers, warp specialisation.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace rtt {

constexpr int TC_WARPS = 4;  // warps per block, 16 query rows each
constexpr int TC_BN = 64;    // keys per K/V tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Two ring stages, each a K tile then a V tile of TC_BN rows of D + 8 bf16.
template <int D>
constexpr size_t fwd_tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * 2 * 2 * TC_BN * (D + 8);
}

template <int D, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int h, int hk, int sq, int sk, float scale_log2,
                    int causal) {
  constexpr int BM = 16 * WARPS, BN = TC_BN, LDS = D + 8, NTHREADS = 32 * WARPS;
  constexpr int NS = BN / 8;  // n8 score tiles per K tile
  constexpr int ND = D / 8;   // n8 output tiles
  static_assert(D % 16 == 0 && BM <= 2 * BN, "Q must fit in one ring stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int STAGE = 2 * BN * LDS;  // K then V

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int bkv = (bh / h) * hk + (bh % h) / (h / hk);
  const __nv_bfloat16* kp = k + (size_t)bkv * sk * D;
  const __nv_bfloat16* vp = v + (size_t)bkv * sk * D;

  int nkb = (sk + BN - 1) / BN;
  if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1);

  // Q into stage 1 (free until tile 1 is issued), tile 0 into stage 0.
  cp_tile<D, BM, NTHREADS>(smem + STAGE, q + (size_t)bh * sq * D, q0, sq);
  cp_async_commit();
  cp_tile<D, BN, NTHREADS>(smem, kp, 0, sk);
  cp_tile<D, BN, NTHREADS>(smem + BN * LDS, vp, 0, sk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) ld_a<LDS>(qa[kc], smem + STAGE, 16 * warp, 16 * kc);
  __syncthreads();

  const int qw0 = q0 + 16 * warp;  // this warp's first row
  const int row[2] = {qw0 + g, qw0 + g + 8};
  float oacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m2[2] = {NEG_INF, NEG_INF};  // running max of the scores, in log2 units
  float lsum[2] = {0.f, 0.f};        // this lane's part of the row sum of p

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

    if (!(causal && k0 > qw0 + 15)) {  // some key of the tile is visible to this warp
      // S = Q.K^T: score tile j holds keys k0 + 8j .. k0 + 8j + 7
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          uint32_t kb4[4];
          ld_bt<LDS>(kb4, Ks, 16 * np, 16 * kc);
          mma_bf16_16816(s[2 * np], qa[kc], kb4[0], kb4[1]);
          mma_bf16_16816(s[2 * np + 1], qa[kc], kb4[2], kb4[3]);
        }
      }

      // element (j, i): row row[i / 2], key k0 + 8j + 2t + (i & 1)
      const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > qw0);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] *= scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (i & 1);
            if (key >= sk || (causal && key > row[i / 2])) s[j][i] = NEG_INF;
          }
          mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m2[r], quad_max(mx[r]));
        alpha[r] = exp2f(m2[r] - m_new);
        m2[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bool ok = true;
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + (i & 1);
            ok = key < sk && !(causal && key > row[i / 2]);
          }
          s[j][i] = ok ? exp2f(s[j][i] - m2[i / 2]) : 0.f;  // p
          rs[i / 2] += s[j][i];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) lsum[r] = alpha[r] * lsum[r] + rs[r];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        oacc[j][0] *= alpha[0]; oacc[j][1] *= alpha[0]; oacc[j][2] *= alpha[1]; oacc[j][3] *= alpha[1];
      }

      // O += P.V over the tile's keys, 16 at a time; P from registers
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const float* ps = s[2 * kc];  // score tiles 2kc, 2kc + 1: 8 floats
        uint32_t pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = pack_bf16x2(ps[2 * i], ps[2 * i + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          ld_b<LDS>(vb, Vs, 16 * kc, 16 * dp);
          mma_bf16_16816(oacc[2 * dp], pa, vb[0], vb[1]);
          mma_bf16_16816(oacc[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // o = acc / l through this warp's 16 rows of stage 0, read by no one now
  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lc[r] = fmaxf(quad_sum(lsum[r]), 1e-30f);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    oacc[j][0] /= lc[0]; oacc[j][1] /= lc[0]; oacc[j][2] /= lc[1]; oacc[j][3] /= lc[1];
  }
  store_rows<D>(o + (size_t)bh * sq * D, qw0, sq, oacc, smem + 16 * warp * LDS);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < sq) lse[(size_t)bh * sq + row[r]] = m2[r] * LN2 + logf(lc[r]);
  }
}

template <int D>
int fwd_tc_launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int h,
                  int hk, int sq, int sk, float scale, int causal, void* stream) {
  constexpr int BM = 16 * TC_WARPS;
  const dim3 grid(bh, (sq + BM - 1) / BM);
  return (int)launch_block(flash_fwd_tc_kernel<D, TC_WARPS>, grid, 32 * TC_WARPS,
                           fwd_tc_smem_bytes<D>(), stream,
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
                           static_cast<float*>(lse), h, hk, sq, sk, scale * LOG2E, causal);
}

// The bf16 route of rtt_flash_fwd (flash_fwd.cu). Pointers must be 16-byte
// aligned (the wrapper checks).
int flash_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int h,
                 int hk, int sq, int sk, int head_dim, float scale, int causal, void* stream) {
  RTT_DISPATCH_D(head_dim, fwd_tc_launch<D>(q, k, v, o, lse, bh, h, hk, sq, sk, scale, causal,
                                             stream));
}

}  // namespace rtt

extern "C" int rtt_flash_fwd_tc_smem_bytes(int head_dim) {
  RTT_SMEM_BYTES(rtt::fwd_tc_smem_bytes, head_dim);
}

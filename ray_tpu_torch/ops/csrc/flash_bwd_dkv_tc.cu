// Flash-attention backward, dk/dv pass, on the tensor cores (bf16;
// FlashAttention-2).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_bwd_dkv_kernel (second
// pallas_call of _flash_bwd) for bf16 inputs; f32 stays on flash_bwd_dkv.cu
// (a tensor-core f32 product is TF32). For every (batch*kv_head, key row),
// summed over every q head of the GQA group and every query:
//   p  = exp(q.k * scale - lse)                         (f32)
//   dv += round_bf16(p) . dO
//   dS = p o (dO.v - delta) * scale, from the unrounded p, then rounded
//   dk += round_bf16(dS) . q
// with every sum in f32, the causal mask top-left aligned, masked p at 0,
// and ragged lengths masked, not padded.
//
// Bound: operations. 4 products of 2*b*h*pairs*d FLOP each (pairs = the
// (q, k) pairs the mask keeps) over 989 TFLOP/s of bf16 tensor cores; the
// bytes (q, k, v, dO, lse, delta read once, dk and dv written once) take
// 7x less time at the training shapes. What the design does about it:
// - The forward's design transposed: keys are the M dimension. Each warp
//   owns 16 key rows, a block of 4 warps 64 keys, and computes
//   S^T = K.Q^T and dP^T = V.dO^T directly (K and V are A operands, Q and
//   dO B operands by plain ldmatrix), so no transpose goes through shared
//   memory. The C fragments of P^T and dS^T, rounded and packed in pairs,
//   are the A fragments of dV += P^T.dO and dK += dS^T.Q (dO and Q by
//   ldmatrix.trans): P and dS never leave the registers.
// - lse and delta are per query, the column of a C fragment: each lane
//   reads its columns 2t, 2t+1 from a small f32 array that travels with the
//   q tile. There is no online maximum, so the q tile is taken 16 queries
//   at a time: S^T and dP^T are 2 n8 tiles (8 registers) each.
// - mma.sync rounds its f32 sum toward zero at every step, so one chain
//   over the whole q loop (group * S queries in GQA) biases dk and dv,
//   and took GQA's dk over the 2^-12 relative RMS bound. Each slice's
//   product goes into a fresh accumulator, added to dK and dV
//   round-to-nearest.
// - dK and dV take 128 f32 registers a thread at d=128, so K and V stay in
//   shared memory for the block's whole loop and their fragments are
//   re-read per use. Q, dO, lse and delta come by cp.async into a two-stage
//   ring: tile i+1 is in flight while tile i is computed. All 16-byte rows
//   are padded by 16 bytes, so ldmatrix is free of bank conflicts. At
//   d=128 that is 104 KB, two blocks an SM.
// - GQA: the block loops over the group's q heads, so the group sum stays
//   in registers: no atomics, no second pass.
// - Causal: the q loop starts at the diagonal tile; only diagonal and
//   ragged slices take the per-element mask; a warp whose 16 keys all come
//   after a slice's last query skips the slice. The grid is (b*hk, key
//   tiles), so the low key tiles, which visit the most q tiles, launch
//   first.
// - dk and dv go out through shared memory as 16-byte stores.
// Later work: wgmma, TMA with mbarriers, warp specialisation.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace rtt {

constexpr int DKV_WARPS = 4;  // warps per block, 16 keys each
constexpr int DKV_BQ = 64;    // queries per Q/dO tile of the ring

// K and V (16 * DKV_WARPS rows each), then two ring stages, each a Q and a
// dO tile (DKV_BQ rows) and the tile's lse and delta (DKV_BQ f32 each);
// every row D + 8 bf16.
template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * 16 * DKV_WARPS + 2 * 2 * DKV_BQ) * (D + 8) +
         sizeof(float) * 2 * 2 * DKV_BQ;
}

template <int D, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int h,
                        int hk, int sq, int sk, float scale, int causal) {
  constexpr int BK = 16 * WARPS, BQ = DKV_BQ, LDS = D + 8, NTHREADS = 32 * WARPS;
  constexpr int ND = D / 8;  // n8 tiles of dk and dv
  constexpr int STAGE = 2 * BQ * LDS + 2 * BQ * 2;  // in bf16: Q, dO, then lse and delta
  static_assert(D % 16 == 0 && BQ % 16 == 0, "16-row slices");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* const Vs = Ks + BK * LDS;
  __nv_bfloat16* const ring = Vs + BK * LDS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // low key tiles (the most causal work) first
  const int kw0 = k0 + 16 * warp;  // this warp's first key
  const int group = h / hk;
  const int qh0 = (bkv / hk) * h + (bkv % hk) * group;  // first q head of the group
  const int qb0 = causal ? k0 / BQ : 0;  // q tiles above the diagonal see none of these keys
  const int nq = max((sq + BQ - 1) / BQ - qb0, 0);  // q tiles per q head
  const int n_it = group * nq;                       // (q head, q tile) pairs

  // Q, dO, lse and delta of pair `it` into ring stage `stage`; rows past sq
  // arrive as zeros.
  auto load_pair = [&](int it, int stage) {
    const int bh = qh0 + it / nq, q0 = (qb0 + it % nq) * BQ;
    __nv_bfloat16* st = ring + stage * STAGE;
    cp_tile<D, BQ, NTHREADS>(st, q + (size_t)bh * sq * D, q0, sq);
    cp_tile<D, BQ, NTHREADS>(st + BQ * LDS, dout + (size_t)bh * sq * D, q0, sq);
    float* rows = reinterpret_cast<float*>(st + 2 * BQ * LDS);
    for (int i = threadIdx.x; i < 2 * BQ; i += NTHREADS) {
      const int r = q0 + i % BQ;
      const bool ok = r < sq;
      cp_async_4(rows + i, (i < BQ ? lse : delta) + (size_t)bh * sq + (ok ? r : 0), ok);
    }
  };

  if (n_it > 0) {
    cp_tile<D, BK, NTHREADS>(Ks, k + (size_t)bkv * sk * D, k0, sk);
    cp_tile<D, BK, NTHREADS>(Vs, v + (size_t)bkv * sk * D, k0, sk);
    load_pair(0, 0);
  }
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[j][i] = dva[j][i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_pair(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // pair it (and K, V) has landed (this thread's copies) ...
    __syncthreads();     // ... and every thread's
    const __nv_bfloat16* Qs = ring + (it & 1) * STAGE;
    const __nv_bfloat16* dOs = Qs + BQ * LDS;
    const float* lse_s = reinterpret_cast<const float*>(Qs + 2 * BQ * LDS);
    const float* delta_s = lse_s + BQ;
    const int q0 = (qb0 + it % nq) * BQ;

    for (int qs = 0; qs < BQ / 16; ++qs) {
      const int qs0 = q0 + 16 * qs;  // the slice's first query
      if (qs0 >= sq || (causal && qs0 + 15 < kw0)) continue;  // no visible (key, query) pair
      // S^T = K.Q^T and dP^T = V.dO^T; n8 tile j holds queries qs0 + 8j ..
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t a[4], b[4];
        ld_a<LDS>(a, Ks, 16 * warp, 16 * kc);
        ld_bt<LDS>(b, Qs, 16 * qs, 16 * kc);
        mma_bf16_16816(st[0], a, b[0], b[1]);
        mma_bf16_16816(st[1], a, b[2], b[3]);
        ld_a<LDS>(a, Vs, 16 * warp, 16 * kc);
        ld_bt<LDS>(b, dOs, 16 * qs, 16 * kc);
        mma_bf16_16816(dpt[0], a, b[0], b[1]);
        mma_bf16_16816(dpt[1], a, b[2], b[3]);
      }

      // element (j, i): key kw0 + g + 8 (i / 2), query qs0 + 8j + 2t + (i & 1)
      const bool edge = qs0 + 16 > sq || (causal && qs0 < kw0 + 15);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 16 * qs + 8 * j + 2 * t;  // column within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = expf(st[j][i] * scale - ((i & 1) ? l2.y : l2.x));
          if (edge) {
            const int qi = q0 + c + (i & 1), key = kw0 + g + 8 * (i / 2);
            if (qi >= sq || (causal && key > qi)) p = 0.f;
          }
          dpt[j][i] = p * (dpt[j][i] - ((i & 1) ? d2.y : d2.x)) * scale;  // dS^T
          st[j][i] = p;                                                    // P^T
        }
      }
      const float* pf = &st[0][0];
      const float* dsf = &dpt[0][0];
      uint32_t pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = pack_bf16x2(pf[2 * i], pf[2 * i + 1]);
        da[i] = pack_bf16x2(dsf[2 * i], dsf[2 * i + 1]);
      }

      // dV += P^T.dO and dK += dS^T.Q over the slice's 16 queries, each n8
      // tile's product in a fresh accumulator added round-to-nearest
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        float tv[2][4] = {}, tk[2][4] = {};
        uint32_t b[4];
        ld_b<LDS>(b, dOs, 16 * qs, 16 * dp);
        mma_bf16_16816(tv[0], pa, b[0], b[1]);
        mma_bf16_16816(tv[1], pa, b[2], b[3]);
        ld_b<LDS>(b, Qs, 16 * qs, 16 * dp);
        mma_bf16_16816(tk[0], da, b[0], b[1]);
        mma_bf16_16816(tk[1], da, b[2], b[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[2 * dp + j][i] += tv[j][i];
            dka[2 * dp + j][i] += tk[j][i];
          }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  // each warp's own 16 rows of Ks and Vs, read by no one now, stage the output
  store_rows<D>(dk + (size_t)bkv * sk * D, kw0, sk, dka, Ks + 16 * warp * LDS);
  store_rows<D>(dv + (size_t)bkv * sk * D, kw0, sk, dva, Vs + 16 * warp * LDS);
}

template <int D>
int dkv_tc_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* dk, void* dv, int bkv, int h, int hk, int sq, int sk,
                  float scale, int causal, void* stream) {
  constexpr int BK = 16 * DKV_WARPS;
  const dim3 grid(bkv, (sk + BK - 1) / BK);
  return (int)launch_block(flash_bwd_dkv_tc_kernel<D, DKV_WARPS>, grid, 32 * DKV_WARPS,
                           dkv_tc_smem_bytes<D>(), stream,
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
                           static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
                           static_cast<__nv_bfloat16*>(dv), h, hk, sq, sk, scale, causal);
}

// The bf16 route of rtt_flash_bwd_dkv (flash_bwd_dkv.cu). q, k, v and dout
// must be 16-byte aligned (the wrapper checks).
int flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int bkv, int h, int hk,
                     int sq, int sk, int head_dim, float scale, int causal, void* stream) {
  RTT_DISPATCH_D(head_dim, dkv_tc_launch<D>(q, k, v, dout, lse, delta, dk, dv, bkv, h, hk, sq, sk,
                                             scale, causal, stream));
}

}  // namespace rtt

extern "C" int rtt_flash_bwd_dkv_tc_smem_bytes(int head_dim) {
  RTT_SMEM_BYTES(rtt::dkv_tc_smem_bytes, head_dim);
}

// Flash-attention backward, dq pass, on Hopper's tensor cores (bf16):
// wgmma from shared memory and registers, TMA loads into an mbarrier ring,
// one producer warp and two consumer warpgroups.
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
// (q, k) pairs the mask keeps) over 989 TFLOP/s of bf16 tensor cores: at
// b=2, h=32, S=2048, d=128, causal, 0.104 ms; the bytes (q, k, v, dO, lse,
// delta read once, dq written once) take 6x less. What the design does
// about it -- the forward's skeleton (flash_fwd_tc.cu) almost as it is:
// - A block owns BM = 128 query rows and has three warpgroups. Warpgroup 0
//   is the producer (setmaxnreg 24): one thread loads the Q and dO tiles
//   once by TMA, then K and V tiles of BN = 128 keys into a ring of two
//   stages, each stage with a "full" barrier (completed by the TMA's
//   bytes) and an "empty" barrier the consumers arrive on.
// - Warpgroups 1 and 2 are the consumers (setmaxnreg 240), 64 query rows
//   each. S = Q.K^T and dP = dO.V^T are wgmma m64n128k16 with both
//   operands K-major in shared memory (the 128-byte swizzle; d = 128's
//   256-byte rows as two 64-column boxes); p and dS come from the
//   accumulators in registers (ex2.approx.ftz, the scale folded into its
//   FMA; lse and delta are per row, two of each a thread, in registers).
//   dQ += dS.K takes A from registers -- the rounded dS accumulator is
//   exactly its fragment -- and B = K MN-major in shared memory (the
//   transpose bit).
// - A long wgmma accumulator chain loses accuracy (flash_bwd_dkv_tc.cu):
//   each K tile's dS.K (8 k16 steps) goes into a fresh accumulator, added
//   to dQ round-to-nearest. A row's one chain spans only one head's keys
//   and stays under the bound, but with less margin, at the same speed on
//   the H100. No atomics: the same result on every run.
// - Registers of a consumer thread at d = 128: dQ 64 f32 and S and dP 64
//   each, 192 of the 240, while S and dP are in use; then dQ, the fresh
//   accumulator (64) and dS packed (32). Tiles of 64 keys (twice the
//   ring's round trips) measured as fast in main and slower in GQA and
//   non-causal. Shared memory at d = 128: Q and dO 64 KB, two stages of K
//   and V 128 KB: 197,672 bytes a block.
// - A consumer arrives on a stage's "empty" barrier only after the
//   wgmma.wait_group that retires dS.K, the last product reading it; the
//   producer refills a stage only after both consumers have.
// - Causal: a q tile loops only up to its diagonal K tile; only tiles that
//   cross a warp's diagonal or the ragged last one take the per-element
//   mask; the heaviest q tiles launch first (blockIdx.y reversed, b*h on
//   blockIdx.x).
// - Ragged sq/sk: 3-D tensor maps over [b*h, sq, d] and [b*hk, sk, d], so
//   rows past a head's end arrive as zeros; keys past sk are masked (p =
//   0), and dq leaves through this consumer's rows of the Q tile by a TMA
//   store, which drops rows past sq.
// Every head dim of KERNEL_HEAD_DIMS takes this path: rows of 32, 64 and
// 128 bytes swizzle by their own span.
#include "hopper.cuh"

namespace rtt {

constexpr int DQ_BM = 128;       // query rows a block owns, 64 per consumer
constexpr int DQ_BN = 128;       // keys per K/V tile
constexpr int DQ_STAGES = 2;     // K/V ring depth
constexpr int DQ_THREADS = 384;  // warpgroup 0 produces, 1 and 2 consume

// Shared memory of one block, from a 1024-byte aligned base: Q and dO
// [BM x D], then per stage K and V [BN x D], each as D / CW column blocks
// of CW bf16 a row; then the barriers.
template <int D, int STAGES = DQ_STAGES>
struct DqSmem {
  static constexpr int CW = D < 64 ? D : 64;  // columns of a block (one swizzle span)
  static constexpr int SPAN = 2 * CW;         // its bytes
  static constexpr int QT = DQ_BM * D * 2;    // the Q (or dO) tile
  static constexpr int KV = DQ_BN * D * 2;    // one K (or V) tile
  static constexpr int RING = 2 * QT;
  static constexpr int BAR = RING + 2 * STAGES * KV;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return DqSmem<D>::BYTES;
}

template <int D, int STAGES>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_dq,
                       const float* __restrict__ lse, const float* __restrict__ delta, int h,
                       int hk, int sq, int sk, float scale, int causal) {
  using S = DqSmem<D, STAGES>;
  constexpr int BM = DQ_BM, BN = DQ_BN, CW = S::CW, SPAN = S::SPAN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the Q tile; dO follows
  const uint32_t bars = base + S::BAR;  // full_q, full[STAGES], empty[STAGES]
  const uint32_t full_q = bars;
  auto full_bar = [&](int s) { return bars + 8 * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto k_tile = [&](int s) { return base + S::RING + 2 * s * S::KV; };  // V follows at + KV

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int bkv = (bh / h) * hk + (bh % h) / (h / hk);
  int nkb = (sk + BN - 1) / BN;
  if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 2 * 128);  // every consumer thread arrives
    }
    fence_mbar_init();
  }
  __syncthreads();

  // The warpgroup's role, read from lane 0 so that the compiler sees it
  // uniform over the warp (setmaxnreg and wgmma are warpgroup-collective).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 2 * S::QT);
      for (int c = 0; c < D / CW; ++c) {
        tma_load_3d(base + c * BM * SPAN, &tm_q, full_q, c * CW, q0, bh);
        tma_load_3d(base + S::QT + c * BM * SPAN, &tm_do, full_q, c * CW, q0, bh);
      }
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(empty_bar(s), ((kb / STAGES) & 1) ^ 1);  // both consumers are done with it
        const uint32_t kt = k_tile(s);
        mbar_expect_tx(full_bar(s), 2 * S::KV);
        for (int c = 0; c < D / CW; ++c) {
          tma_load_3d(kt + c * BN * SPAN, &tm_k, full_bar(s), c * CW, kb * BN, bkv);
          tma_load_3d(kt + S::KV + c * BN * SPAN, &tm_v, full_bar(s), c * CW, kb * BN, bkv);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    setmaxnreg_inc<240>();
    const int cons = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int rc0 = q0 + 64 * cons;   // this consumer's first row
    const int rw0 = rc0 + 16 * warp;  // this warp's first row
    const int row[2] = {rw0 + g, rw0 + g + 8};
    const uint32_t q_rows = base + 64 * cons * SPAN;  // this consumer's rows of Q's block 0
    const uint32_t do_rows = q_rows + S::QT;
    const float scale_log2 = scale * LOG2E;
    float lse2[2], dlt[2];  // lse * log2(e) and delta of this thread's rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = row[r] < sq;
      lse2[r] = ok ? lse[(size_t)bh * sq + row[r]] * LOG2E : 0.f;
      dlt[r] = ok ? delta[(size_t)bh * sq + row[r]] : 0.f;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(full_q, 0);

    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % STAGES;
      const uint32_t ph = (kb / STAGES) & 1, kt = k_tile(s), vt = kt + S::KV;
      const int k0 = kb * BN;
      mbar_wait(full_bar(s), ph);
      // S = Q.K^T and dP = dO.V^T: k16 steps along d, block 16 kc / CW
      float sacc[BN / 2], dpacc[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t off = (16 * kc / CW) * BM * SPAN + (16 * kc % CW) * 2;
        const uint32_t koff = (16 * kc / CW) * BN * SPAN + (16 * kc % CW) * 2;
        wgmma_ss_m64k16(sacc, desc_kmajor<SPAN>(q_rows + off), desc_kmajor<SPAN>(kt + koff),
                        kc > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t off = (16 * kc / CW) * BM * SPAN + (16 * kc % CW) * 2;
        const uint32_t koff = (16 * kc / CW) * BN * SPAN + (16 * kc % CW) * 2;
        wgmma_ss_m64k16(dpacc, desc_kmajor<SPAN>(do_rows + off), desc_kmajor<SPAN>(vt + koff),
                        kc > 0);
      }
      wgmma_commit();

      // element i: row row[(i >> 1) & 1], key k0 + 8 (i / 4) + 2t + (i & 1)
      const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > rw0);
      wgmma_wait<1>();
      fence_regs(sacc);  // S has landed; P while dP runs
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2_ftz(fmaf(sacc[i], scale_log2, -lse2[r]));
        if (edge) {
          const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (key >= sk || (causal && key > row[r])) p = 0.f;
        }
        sacc[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dpacc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sacc[i] = sacc[i] * (dpacc[i] - dlt[(i >> 1) & 1]) * scale;  // dS

      // dQ += dS.K: two n8 blocks of dS, rounded to bf16, per k16 step of keys
      uint32_t da[BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          da[kc][i] = pack_bf16x2(sacc[8 * kc + 2 * i], sacc[8 * kc + 2 * i + 1]);
      // in a fresh accumulator, added to the sum round-to-nearest
      float tile[D / 2];
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs_m64k16(tile, da[kc], desc_mnmajor<SPAN>(kt + 16 * kc * SPAN, BN * SPAN), kc > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tile);  // dS.K has retired: this thread is done with the stage
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] += tile[i];
      mbar_arrive(empty_bar(s));
    }

    // dq rounded to bf16 into this consumer's rows of the Q tile (no wgmma
    // reads them any more), then out by one TMA store per block
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lrow = 64 * cons + 16 * warp + g + 8 * r, col = (8 * j) % CW + 2 * t;
        const uint32_t off = (8 * j / CW) * BM * SPAN + swizzle<SPAN>(lrow * SPAN + 2 * col);
        st_shared_b32(base + off, pack_bf16x2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]));
      }
    fence_proxy_async();
    named_barrier_sync(1 + cons, 128);
    if (tid == 0) {
      for (int c = 0; c < D / CW; ++c)
        tma_store_3d(&tm_dq, q_rows + c * BM * SPAN, c * CW, rc0, bh);
      tma_store_wait();
    }
  }
}

// ---- host: the launch

template <int D>
int dq_tc_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, int bh, int h, int hk, int sq, int sk, float scale,
                 int causal, void* stream) {
  constexpr int CW = DqSmem<D>::CW;
  const int bkv = bh / h * hk;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq;
  if (!tensor_map_3d(&tm_q, q, bh, sq, D, DQ_BM, CW) ||
      !tensor_map_3d(&tm_do, dout, bh, sq, D, DQ_BM, CW) ||
      !tensor_map_3d(&tm_k, k, bkv, sk, D, DQ_BN, CW) ||
      !tensor_map_3d(&tm_v, v, bkv, sk, D, DQ_BN, CW) ||
      !tensor_map_3d(&tm_dq, dq, bh, sq, D, DQ_BM / 2, CW))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (sq + DQ_BM - 1) / DQ_BM);
  return (int)launch_block(flash_bwd_dq_tc_kernel<D, DQ_STAGES>, grid, DQ_THREADS,
                           dq_tc_smem_bytes<D>(), stream, tm_q, tm_do, tm_k, tm_v, tm_dq,
                           static_cast<const float*>(lse), static_cast<const float*>(delta), h,
                           hk, sq, sk, scale, causal);
}

// The bf16 route of rtt_flash_bwd_dq (flash_bwd_dq.cu). Pointers must be
// 16-byte aligned (the wrapper checks q, k, v and dout; dq is its own
// allocation): TMA reads and writes from such addresses.
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

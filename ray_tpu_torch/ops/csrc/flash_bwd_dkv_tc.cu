// Flash-attention backward, dk/dv pass, on Hopper's tensor cores (bf16):
// wgmma from shared memory and registers, TMA loads into an mbarrier ring,
// one producer warp and two consumer warpgroups.
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
// (q, k) pairs the mask keeps) over 989 TFLOP/s of bf16 tensor cores: at
// b=2, h=32, S=2048, d=128, causal, 0.139 ms; the bytes (q, k, v, dO,
// lse, delta read once, dk and dv written once) take 7x less. Only wgmma
// reaches that rate, and only when the tensor cores never wait for data.
// What the design does about it -- the forward's (flash_fwd_tc.cu) with the
// roles in the ring changed:
// - A block owns BK = 128 keys of one kv head and has three warpgroups.
//   Warpgroup 0 is the producer (setmaxnreg 24): its first warp loads K
//   and V once by TMA, then streams the Q and dO tiles of BQ = 64 queries,
//   (q head, q tile) after (q head, q tile), through a ring of two stages.
//   One lane issues the TMA loads; all 32 copy the tile's lse (times
//   log2 e) and delta into the stage and arrive on its "full" barrier,
//   which completes when they have and the TMA's bytes have landed (lse
//   and delta rows of a ragged length are not 16-byte aligned, as TMA
//   needs). An "empty" barrier per stage takes every consumer thread's
//   arrival. The producer counts its way through the pairs: a division by
//   the tile count there cost the registers that made ptxas spill.
// - Warpgroups 1 and 2 are the consumers (setmaxnreg 240), 64 keys each:
//   keys are the M dimension. S^T = K.Q^T and dP^T = V.dO^T are wgmma
//   m64n64k16 with both operands K-major in shared memory (the 128-byte
//   swizzle; d = 128's 256-byte rows as two 64-column boxes). p and dS
//   come from the accumulators in registers, one MUFU instruction an
//   exponential (ex2.approx.ftz, the scale folded into its FMA); lse and
//   delta are per query, a column of the transposed accumulator, so each
//   lane reads its columns from the stage's f32 arrays.
// - dV += P^T.dO and dK += dS^T.Q read P^T and dS^T, rounded to bf16, from
//   this consumer's two 64 x 64 tiles in shared memory (rows of 128 bytes,
//   swizzled as TMA would), with dO and Q MN-major (the transpose bit).
//   They do not take A from registers, as the forward's P.V does, because
//   of the registers: a consumer thread at d = 128 holds dK and dV (64 f32
//   each, m64n128), S^T and dP^T (32 each), so 192 of its 240; each
//   product then goes into a fresh accumulator of 64 (below), and with the
//   packed fragments beside it (16 each) the loop spilled.
// - A long wgmma accumulator chain loses accuracy, as mma.sync's did
//   (whose f32 sum rounds toward zero): one chain over a key's group * S
//   queries takes dk and dv in GQA over the 2^-12 relative RMS bound
//   (tools/kernel_check.py's dkv_tc_one_chain). So each tile's product (4
//   k16 steps) goes into a fresh accumulator, added to dK or dV
//   round-to-nearest, as the mma.sync kernel added each 16-query slice;
//   the group sum stays on the chip, no atomics, no second pass, the same
//   result on every run.
// - Shared memory at d = 128: K and V 64 KB, two stages of Q and dO 64 KB,
//   P^T and dS^T 32 KB, lse and delta 1 KB: 165,928 bytes a block.
// - A consumer arrives on a stage's "empty" barrier only after the
//   wgmma.wait_group that retires dS^T.Q, the last product reading it; the
//   producer refills a stage only after both consumers have.
// - Causal: the q loop starts at the diagonal tile; only tiles that cross
//   a warp's diagonal take the per-element mask; a consumer whose 64 keys
//   all come after a tile's last query skips the tile's products. The grid
//   is (b*hk, key tiles), so the low key tiles, which visit the most q
//   tiles, launch first.
// - Ragged sq/sk: 3-D tensor maps over [b*h, sq, d] and [b*hk, sk, d].
//   Query rows past sq arrive as zeros, with lse and delta 0, so they add
//   exactly 0 to dK and dV (p = 1 times a zero dO row; dS = 0): no mask.
//   Key rows past sk only make rows of dK and dV that are never written.
// - dk and dv go out through this consumer's rows of the K and V tiles (no
//   wgmma reads them any more) by TMA stores, which drop rows past sk.
// Every head dim of KERNEL_HEAD_DIMS takes this path: rows of 32, 64 and
// 128 bytes swizzle by their own span.
#include "hopper.cuh"

namespace rtt {

constexpr int DKV_BK = 128;       // keys a block owns, 64 per consumer
constexpr int DKV_BQ = 64;        // queries per Q/dO tile of the ring
constexpr int DKV_STAGES = 2;     // Q/dO ring depth
constexpr int DKV_THREADS = 384;  // warpgroup 0 produces, 1 and 2 consume

// Shared memory of one block, from a 1024-byte aligned base: K and V
// [BK x D], then per stage Q and dO [BQ x D], each as D / CW column blocks
// of CW bf16 a row; then each consumer's P^T and dS^T [64 x BQ] (rows of
// one 128-byte span); then per stage lse * log2(e) and delta [BQ] f32;
// then the barriers.
template <int D, int STAGES = DKV_STAGES>
struct DkvSmem {
  static constexpr int CW = D < 64 ? D : 64;  // columns of a block (one swizzle span)
  static constexpr int SPAN = 2 * CW;         // its bytes
  static constexpr int KV = DKV_BK * D * 2;   // the K (or V) tile
  static constexpr int QT = DKV_BQ * D * 2;   // one Q (or dO) tile
  static constexpr int PS_SPAN = 2 * DKV_BQ;  // a row of P^T or dS^T
  static_assert(PS_SPAN == 128, "P^T and dS^T rows are one 128-byte swizzle span");
  static constexpr int PS = 64 * PS_SPAN;     // one consumer's P^T (or dS^T)
  static constexpr int RING = 2 * KV;
  static constexpr int PDS = RING + 2 * STAGES * QT;
  static constexpr int ROWS = PDS + 2 * 2 * PS;
  static constexpr int BAR = ROWS + 2 * STAGES * DKV_BQ * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return DkvSmem<D>::BYTES;
}

template <int D, int STAGES>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_dk,
                        const __grid_constant__ CUtensorMap tm_dv,
                        const float* __restrict__ lse, const float* __restrict__ delta, int h,
                        int hk, int sq, int sk, float scale, int causal) {
  using S = DkvSmem<D, STAGES>;
  constexpr int BK = DKV_BK, BQ = DKV_BQ, CW = S::CW, SPAN = S::SPAN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the K tile; V follows
  const uint32_t bars = base + S::BAR;  // full_kv, full[STAGES], empty[STAGES]
  const uint32_t full_kv = bars;
  auto full_bar = [&](int s) { return bars + 8 * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto q_tile = [&](int s) { return base + S::RING + 2 * s * S::QT; };  // dO follows at + QT

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // low key tiles (the most causal work) first
  const int group = h / hk;
  const int qh0 = (bkv / hk) * h + (bkv % hk) * group;  // first q head of the group
  const int qb0 = causal ? k0 / BQ : 0;  // q tiles above the diagonal see none of these keys
  const int nq = max((sq + BQ - 1) / BQ - qb0, 0);  // q tiles per q head
  const int n_it = group * nq;                       // (q head, q tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 32);        // the producer warp's lanes (lane 0's carries the bytes)
      mbar_init(empty_bar(s), 2 * 128);  // every consumer thread
    }
    fence_mbar_init();
  }
  __syncthreads();

  // The warpgroup's role, read from lane 0 so that the compiler sees it
  // uniform over the warp (setmaxnreg and wgmma are warpgroup-collective).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: the first warp; lane 0 issues every TMA load
    setmaxnreg_dec<24>();
    const int lane = threadIdx.x;
    if (lane < 32 && n_it > 0) {
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * S::KV);
        for (int c = 0; c < D / CW; ++c) {
          tma_load_3d(base + c * BK * SPAN, &tm_k, full_kv, c * CW, k0, bkv);
          tma_load_3d(base + S::KV + c * BK * SPAN, &tm_v, full_kv, c * CW, k0, bkv);
        }
      }
      int bh = qh0, qi = qb0;  // pair it's q head and q tile
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES, q0 = qi * BQ;
        mbar_wait(empty_bar(s), ((it / STAGES) & 1) ^ 1);  // both consumers are done with it
        const uint32_t rows = base + S::ROWS + 2 * s * BQ * 4;  // lse2, then delta
        const size_t row0 = (size_t)bh * sq + q0;
        for (int i = lane; i < BQ; i += 32) {
          const bool ok = q0 + i < sq;
          st_shared_b32(rows + 4 * i, __float_as_uint(ok ? lse[row0 + i] * LOG2E : 0.f));
          st_shared_b32(rows + 4 * (BQ + i), __float_as_uint(ok ? delta[row0 + i] : 0.f));
        }
        if (lane == 0) {
          const uint32_t qt = q_tile(s);
          mbar_expect_tx(full_bar(s), 2 * S::QT);
          for (int c = 0; c < D / CW; ++c) {
            tma_load_3d(qt + c * BQ * SPAN, &tm_q, full_bar(s), c * CW, q0, bh);
            tma_load_3d(qt + S::QT + c * BQ * SPAN, &tm_do, full_bar(s), c * CW, q0, bh);
          }
        } else {
          mbar_arrive(full_bar(s));  // after this lane's lse and delta (release)
        }
        if (++qi == qb0 + nq) {
          qi = qb0;
          ++bh;
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each
    setmaxnreg_inc<240>();
    const int cons = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int kc0 = k0 + 64 * cons;   // this consumer's first key
    const int kw0 = kc0 + 16 * warp;  // this warp's first key
    const uint32_t k_rows = base + 64 * cons * SPAN;  // this consumer's rows of K's block 0
    const uint32_t v_rows = k_rows + S::KV;
    const uint32_t p_tile = base + S::PDS + 2 * cons * S::PS;  // this consumer's P^T
    const uint32_t ds_tile = p_tile + S::PS;                    // and dS^T
    // where elements 4j + 2r, +1 of the S^T accumulator go in such a tile
    auto ps_off = [&](int j, int r) {
      return swizzle<128>((16 * warp + g + 8 * r) * S::PS_SPAN + 16 * j + 4 * t);
    };
    const float scale_log2 = scale * LOG2E;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if (n_it > 0) mbar_wait(full_kv, 0);

    for (int it = 0, qi = qb0; it < n_it; ++it, qi = qi + 1 == qb0 + nq ? qb0 : qi + 1) {
      const int s = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1, qt = q_tile(s), dot = qt + S::QT;
      const int q0 = qi * BQ;
      mbar_wait(full_bar(s), ph);
      if (!causal || q0 + BQ - 1 >= kc0) {  // some (key, query) pair of this consumer is visible
        // S^T = K.Q^T and dP^T = V.dO^T: k16 steps along d, block 16 kc / CW
        float st[BQ / 2], dpt[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          const uint32_t koff = (16 * kc / CW) * BK * SPAN + (16 * kc % CW) * 2;
          const uint32_t qoff = (16 * kc / CW) * BQ * SPAN + (16 * kc % CW) * 2;
          wgmma_ss_m64k16(st, desc_kmajor<SPAN>(k_rows + koff), desc_kmajor<SPAN>(qt + qoff),
                          kc > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          const uint32_t koff = (16 * kc / CW) * BK * SPAN + (16 * kc % CW) * 2;
          const uint32_t qoff = (16 * kc / CW) * BQ * SPAN + (16 * kc % CW) * 2;
          wgmma_ss_m64k16(dpt, desc_kmajor<SPAN>(v_rows + koff), desc_kmajor<SPAN>(dot + qoff),
                          kc > 0);
        }
        wgmma_commit();

        // element 4j + e: key kw0 + g + 8 (e >> 1), query q0 + 8j + 2t + (e & 1);
        // this lane's lse2 and delta, columns 8j + 2t, +1, at lse_a + 32 j
        const uint32_t lse_a = base + S::ROWS + (2 * s * BQ + 2 * t) * 4, dlt_a = lse_a + BQ * 4;
        const bool edge = causal && q0 < kw0 + 15;
        wgmma_wait<1>();
        fence_regs(st);  // S^T has landed; P^T while dP^T runs
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l2 = ld_shared_f32x2(lse_a + 32 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_ftz(fmaf(st[4 * j + e], scale_log2, -(e & 1 ? l2.y : l2.x)));
            if (edge && kw0 + g + 8 * (e >> 1) > q0 + 8 * j + 2 * t + (e & 1)) p = 0.f;
            st[4 * j + e] = p;
          }
        }
        // P^T and dS^T rounded to bf16 into this consumer's tiles, the A
        // operands of dV += P^T.dO and dK += dS^T.Q (element 4j + 2r + c at
        // row 16 warp + g + 8r, column 8j + 2t + c)
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            st_shared_b32(p_tile + ps_off(j, r),
                          pack_bf16x2(st[4 * j + 2 * r], st[4 * j + 2 * r + 1]));
        wgmma_wait<0>();
        fence_regs(dpt);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 d2 = ld_shared_f32x2(dlt_a + 32 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e)  // dS^T
            dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - (e & 1 ? d2.y : d2.x)) * scale;
        }
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            st_shared_b32(ds_tile + ps_off(j, r),
                          pack_bf16x2(dpt[4 * j + 2 * r], dpt[4 * j + 2 * r + 1]));
        fence_proxy_async();                // this thread's P^T and dS^T, for wgmma ...
        named_barrier_sync(1 + cons, 128);  // ... once the whole warpgroup's are in place

        // each product in a fresh accumulator, added to the sum round-to-nearest
        float tile[D / 2];
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc)
          wgmma_ss_m64k16<1>(tile, desc_kmajor<128>(p_tile + 32 * kc),
                             desc_mnmajor<SPAN>(dot + 16 * kc * SPAN, BQ * SPAN), kc > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(tile);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dv[i] += tile[i];
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc)
          wgmma_ss_m64k16<1>(tile, desc_kmajor<128>(ds_tile + 32 * kc),
                             desc_mnmajor<SPAN>(qt + 16 * kc * SPAN, BQ * SPAN), kc > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(tile);  // dS^T.Q has retired: this thread is done with the stage
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk[i] += tile[i];
      }
      mbar_arrive(empty_bar(s));
    }

    // dk and dv rounded to bf16 into this consumer's rows of the K and V
    // tiles, then out by one TMA store per block
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lrow = 64 * cons + 16 * warp + g + 8 * r, col = (8 * j) % CW + 2 * t;
        const uint32_t off = (8 * j / CW) * BK * SPAN + swizzle<SPAN>(lrow * SPAN + 2 * col);
        st_shared_b32(base + off, pack_bf16x2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]));
        st_shared_b32(base + S::KV + off, pack_bf16x2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]));
      }
    fence_proxy_async();
    named_barrier_sync(1 + cons, 128);
    if (tid == 0) {
      for (int c = 0; c < D / CW; ++c) {
        tma_store_3d(&tm_dk, k_rows + c * BK * SPAN, c * CW, kc0, bkv);
        tma_store_3d(&tm_dv, v_rows + c * BK * SPAN, c * CW, kc0, bkv);
      }
      tma_store_wait();
    }
  }
}

// ---- host: the launch

template <int D>
int dkv_tc_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* delta, void* dk, void* dv, int bkv, int h, int hk, int sq, int sk,
                  float scale, int causal, void* stream) {
  constexpr int CW = DkvSmem<D>::CW;
  const int bh = bkv / hk * h;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv;
  if (!tensor_map_3d(&tm_q, q, bh, sq, D, DKV_BQ, CW) ||
      !tensor_map_3d(&tm_do, dout, bh, sq, D, DKV_BQ, CW) ||
      !tensor_map_3d(&tm_k, k, bkv, sk, D, DKV_BK, CW) ||
      !tensor_map_3d(&tm_v, v, bkv, sk, D, DKV_BK, CW) ||
      !tensor_map_3d(&tm_dk, dk, bkv, sk, D, DKV_BK / 2, CW) ||
      !tensor_map_3d(&tm_dv, dv, bkv, sk, D, DKV_BK / 2, CW))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bkv, (sk + DKV_BK - 1) / DKV_BK);
  return (int)launch_block(flash_bwd_dkv_tc_kernel<D, DKV_STAGES>, grid, DKV_THREADS,
                           dkv_tc_smem_bytes<D>(), stream, tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv,
                           static_cast<const float*>(lse), static_cast<const float*>(delta), h,
                           hk, sq, sk, scale, causal);
}

// The bf16 route of rtt_flash_bwd_dkv (flash_bwd_dkv.cu). Pointers must be
// 16-byte aligned (the wrapper checks q, k, v and dout; dk and dv are its
// own allocations): TMA reads and writes from such addresses.
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

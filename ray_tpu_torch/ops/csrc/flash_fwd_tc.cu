// Flash-attention forward on Hopper's tensor cores (bf16): wgmma from
// shared memory, TMA loads into an mbarrier ring, one producer warp and two
// consumer warpgroups.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched
// by _flash_fwd) for bf16 inputs; f32 stays on flash_fwd.cu (a tensor-core
// f32 product is TF32). Computes, for every (batch*head, query row),
//   o   = softmax(q.K^T * scale) . V       (bf16)
//   lse = m + log(max(l, 1e-30))           (f32, saved for the backward)
// with (m, l, acc) in f32 registers, p rounded to bf16 before P.V (the
// Pallas kernel's p.astype(v.dtype)), l summed from the unrounded p, the
// causal mask top-left aligned, masked scores at the finite -1e30 and
// masked p = 0. GQA maps q head bh to kv head (bh / h) * hk + (bh % h) /
// (h / hk); repeated K/V is never stored.
//
// Bound: operations. 2 products of 2*b*h*pairs*d FLOP each (pairs = the
// (q, k) pairs the mask keeps) over 989 TFLOP/s of bf16 tensor cores: at
// b=2, h=32, S=2048, d=128, causal, 0.0695 ms; the bytes (q, k, v read
// once, o and lse written once) take 5x less. Only wgmma reaches that
// rate, and only when the tensor cores never wait for data or for the
// softmax. What the design does about it:
// - A block owns BM = 128 query rows and has three warpgroups. Warpgroup 0
//   is the producer: it gives up registers (setmaxnreg 24) and one thread
//   issues every load by TMA -- the Q tile once, then K and V tiles of
//   BN = 128 keys into a ring of two stages, each stage with a "full"
//   barrier for K, one for V (completed by the TMA's bytes) and an "empty"
//   barrier the consumers arrive on. Loads cost the consumers no
//   instruction and no register.
// - Warpgroups 1 and 2 are the consumers (setmaxnreg 240), 64 query rows
//   each. S = Q.K^T is wgmma m64n128k16 with both operands K-major in
//   shared memory (Q's rows and K's rows, the 128-byte swizzle; d = 128's
//   256-byte rows as two 64-column boxes). The online softmax runs in
//   registers on the accumulator, one MUFU instruction an exponential
//   (ex2.approx.ftz); a row's max and sum reduce over the 4 lanes that hold
//   it. O += P.V is wgmma with A from registers -- the S accumulator
//   rounded to bf16 is exactly its A fragment -- and B = V MN-major in
//   shared memory (the transpose bit). Each consumer runs S, softmax, P.V
//   in turn; while one runs its softmax, the other's products keep the
//   tensor cores busy. (Overlapping a tile's softmax with the previous
//   tile's P.V inside a warpgroup, with or without the consumers taking
//   turns by named barriers, measured slower on the H100.)
// - A consumer arrives on a stage's "empty" barrier only after the
//   wgmma.wait_group that retires the P.V reading the stage; the producer
//   refills a stage only after both consumers have.
// - Causal: a q tile loops only up to its diagonal K tile, only the
//   diagonal and the ragged last tile take the per-element mask, and the
//   heaviest q tiles launch first (blockIdx.y reversed, b*h on blockIdx.x).
// - Ragged sq/sk: 3-D tensor maps over [b*h, sq, d] and [b*hk, sk, d], so
//   rows past a head's end arrive as zeros and are never written: o leaves
//   through this consumer's rows of the Q tile by a TMA store, which drops
//   rows past sq.
// - Tensor maps are encoded on the host per launch and passed as
//   __grid_constant__ parameters; the encoder comes from the driver through
//   the runtime (cudaGetDriverEntryPointByVersion), so the library links
//   the runtime only.
// Every head dim of KERNEL_HEAD_DIMS takes this path: rows of 32, 64 and
// 128 bytes swizzle by their own span.
#include "hopper.cuh"

namespace rtt {

constexpr int FWD_BM = 128;       // query rows a block owns, 64 per consumer
constexpr int FWD_BN = 128;       // keys per K/V tile
constexpr int FWD_STAGES = 2;     // K/V ring depth
constexpr int FWD_THREADS = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of one block, from a 1024-byte aligned base: Q [BM x D],
// then per stage K [BN x D] and V [BN x D], each as D / CW column blocks of
// CW bf16 a row; then the barriers.
template <int D, int STAGES = FWD_STAGES>
struct FwdSmem {
  static constexpr int CW = D < 64 ? D : 64;  // columns of a block (one swizzle span)
  static constexpr int SPAN = 2 * CW;         // its bytes
  static constexpr int Q = FWD_BM * D * 2;
  static constexpr int KV = FWD_BN * D * 2;   // one K (or V) tile
  static constexpr int BAR = Q + 2 * STAGES * KV;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
};

template <int D>
constexpr size_t fwd_tc_smem_bytes() {
  return FwdSmem<D>::BYTES;
}

// One step of the online softmax on a consumer's S accumulator (keys k0..
// k0 + BN - 1): mask, raise the running max m2 (log2 units), turn s into p
// = 2^(s * scale_log2 - m2) (masked p = 0), add p's row sums into lsum and
// return each row's rescale factor alpha. The max is taken on the raw
// scores (negated for a negative scale) and the scale folded into the
// exponent's FMA. Element i: row row[(i >> 1) & 1], key k0 + 8 (i / 4) +
// 2t + (i & 1).
template <int BN, bool POS>
__device__ __forceinline__ void softmax_step(float (&s)[BN / 2], float (&m2)[2], float (&lsum)[2],
                                             float (&alpha)[2], float scale_log2, bool edge,
                                             int k0, int sk, const int (&row)[2], int t,
                                             int causal) {
  constexpr float MASKED = POS ? NEG_INF : -NEG_INF;  // a raw score whose scaled value is -1e30
  float mx[2] = {NEG_INF, NEG_INF};                   // of the raw scores, sign-corrected
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    if (edge) {
      const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      if (key >= sk || (causal && key > row[(i >> 1) & 1])) s[i] = MASKED;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], POS ? s[i] : -s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m2[r], quad_max(mx[r]) * fabsf(scale_log2));
    alpha[r] = exp2_ftz(m2[r] - m_new);
    m2[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float p = edge && s[i] == MASKED ? 0.f : exp2_ftz(fmaf(s[i], scale_log2, -m2[r]));
    s[i] = p;
    rs[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) lsum[r] = alpha[r] * lsum[r] + rs[r];
}

template <int D, int STAGES>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse, int h,
                    int hk, int sq, int sk, float scale_log2, int causal) {
  using S = FwdSmem<D, STAGES>;
  constexpr int BM = FWD_BM, BN = FWD_BN, CW = S::CW, SPAN = S::SPAN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq_base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the Q tile
  const uint32_t bars = sq_base + S::BAR;  // full_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty_bar = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
  auto k_tile = [&](int s) { return sq_base + S::Q + 2 * s * S::KV; };  // V follows at + KV

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int bkv = (bh / h) * hk + (bh % h) / (h / hk);
  int nkb = (sk + BN - 1) / BN;
  if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
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
      mbar_expect_tx(full_q, S::Q);
      for (int c = 0; c < D / CW; ++c)
        tma_load_3d(sq_base + c * BM * SPAN, &tm_q, full_q, c * CW, q0, bh);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(empty_bar(s), ((kb / STAGES) & 1) ^ 1);  // both consumers are done with it
        const uint32_t kt = k_tile(s), vt = kt + S::KV;
        mbar_expect_tx(full_k(s), S::KV);
        for (int c = 0; c < D / CW; ++c)
          tma_load_3d(kt + c * BN * SPAN, &tm_k, full_k(s), c * CW, kb * BN, bkv);
        mbar_expect_tx(full_v(s), S::KV);
        for (int c = 0; c < D / CW; ++c)
          tma_load_3d(vt + c * BN * SPAN, &tm_v, full_v(s), c * CW, kb * BN, bkv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    setmaxnreg_inc<240>();
    const int cons = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int rw0 = q0 + 64 * cons + 16 * warp;  // this warp's first row
    const int row[2] = {rw0 + g, rw0 + g + 8};
    const uint32_t q_rows = sq_base + 64 * cons * SPAN;  // this consumer's rows of block 0

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m2[2] = {NEG_INF, NEG_INF};  // running max of the scores, in log2 units
    float lsum[2] = {0.f, 0.f};        // this lane's part of the row sum of p
    mbar_wait(full_q, 0);

    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % STAGES;
      const uint32_t ph = (kb / STAGES) & 1, kt = k_tile(s), vt = kt + S::KV;
      const int k0 = kb * BN;

      // S = Q.K^T: k16 steps along d, block c = 16 kc / CW of both tiles
      float sacc[BN / 2];
      mbar_wait(full_k(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t off = (16 * kc / CW) * BM * SPAN + (16 * kc % CW) * 2;
        const uint32_t koff = (16 * kc / CW) * BN * SPAN + (16 * kc % CW) * 2;
        wgmma_ss_m64k16(sacc, desc_kmajor<SPAN>(q_rows + off), desc_kmajor<SPAN>(kt + koff),
                            kc > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);  // S = Q.K^T has landed

      const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > rw0);
      float alpha[2];
      if (scale_log2 >= 0.f)
        softmax_step<BN, true>(sacc, m2, lsum, alpha, scale_log2, edge, k0, sk, row, t, causal);
      else
        softmax_step<BN, false>(sacc, m2, lsum, alpha, scale_log2, edge, k0, sk, row, t, causal);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];

      // O += P.V: p rounded to bf16, two n8 blocks of S per k16 step of keys
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kc][i] = pack_bf16x2(sacc[8 * kc + 2 * i], sacc[8 * kc + 2 * i + 1]);
      fence_regs(oacc);
      fence_regs(pa);
      mbar_wait(full_v(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs_m64k16(oacc, pa[kc], desc_mnmajor<SPAN>(vt + 16 * kc * SPAN, BN * SPAN));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);  // P.V has retired: this thread is done with the stage
      mbar_arrive(empty_bar(s));
    }

    // o = acc / l, rounded to bf16, into this consumer's rows of the Q tile
    // (no wgmma reads them any more), then out by one TMA store per block
    float lc[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lc[r] = fmaxf(quad_sum(lsum[r]), 1e-30f);
      inv[r] = 1.f / lc[r];
    }
    unsigned char* const q_gen = smem_raw + (sq_base - smem_u32(smem_raw));
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lrow = 64 * cons + 16 * warp + g + 8 * r, col = (8 * j) % CW + 2 * t;
        const uint32_t off = (8 * j / CW) * BM * SPAN + swizzle<SPAN>(lrow * SPAN + 2 * col);
        *reinterpret_cast<uint32_t*>(q_gen + off) =
            pack_bf16x2(oacc[4 * j + 2 * r] * inv[r], oacc[4 * j + 2 * r + 1] * inv[r]);
      }
    fence_proxy_async();
    named_barrier_sync(1 + cons, 128);
    if (tid == 0) {
      for (int c = 0; c < D / CW; ++c)
        tma_store_3d(&tm_o, q_rows + c * BM * SPAN, c * CW, q0 + 64 * cons, bh);
      tma_store_wait();
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < sq) lse[(size_t)bh * sq + row[r]] = m2[r] * LN2 + logf(lc[r]);
    }
  }
}

// ---- host: the launch

template <int D>
int fwd_tc_launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int h,
                  int hk, int sq, int sk, float scale, int causal, void* stream) {
  constexpr int CW = FwdSmem<D>::CW;
  const int bkv = bh / h * hk;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!tensor_map_3d(&tm_q, q, bh, sq, D, FWD_BM, CW) ||
      !tensor_map_3d(&tm_k, k, bkv, sk, D, FWD_BN, CW) ||
      !tensor_map_3d(&tm_v, v, bkv, sk, D, FWD_BN, CW) ||
      !tensor_map_3d(&tm_o, o, bh, sq, D, FWD_BM / 2, CW))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (sq + FWD_BM - 1) / FWD_BM);
  return (int)launch_block(flash_fwd_tc_kernel<D, FWD_STAGES>, grid, FWD_THREADS,
                           fwd_tc_smem_bytes<D>(), stream, tm_q, tm_k, tm_v, tm_o,
                           static_cast<float*>(lse), h, hk, sq, sk, scale * LOG2E, causal);
}

// The bf16 route of rtt_flash_fwd (flash_fwd.cu). Pointers must be 16-byte
// aligned (the wrapper checks): TMA reads and writes from such addresses.
int flash_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int h,
                 int hk, int sq, int sk, int head_dim, float scale, int causal, void* stream) {
  RTT_DISPATCH_D(head_dim, fwd_tc_launch<D>(q, k, v, o, lse, bh, h, hk, sq, sk, scale, causal,
                                             stream));
}

}  // namespace rtt

extern "C" int rtt_flash_fwd_tc_smem_bytes(int head_dim) {
  RTT_SMEM_BYTES(rtt::fwd_tc_smem_bytes, head_dim);
}

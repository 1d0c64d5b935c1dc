// Flash-attention forward (online softmax), f32: TMA loads into an mbarrier
// ring, one producer warp and two consumer warpgroups, every product exact
// f32 on the CUDA cores.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_fwd_kernel (launched
// by _flash_fwd) for f32 inputs; rtt_flash_fwd below hands bf16 inputs to
// the wgmma kernel of flash_fwd_tc.cu. Computes, for every (batch*head,
// query row),
//   o   = softmax(q.K^T * scale) . V
//   lse = m + log(max(l, 1e-30))           (saved for the backward)
// keeping (m, l, o) in f32 registers, with the causal mask top-left
// aligned, masked scores at the finite -1e30 and masked p = 0, and ragged
// lengths masked.
//
// Bound: operations. 2 products of 2*b*h*pairs*d FLOP each (pairs = the
// (q, k) pairs the mask keeps): at b=2, h=32, S=2048, d=128, causal, 68.7
// GFLOP, 1.03 ms at the CUDA cores' 67 TFLOP/s; the bytes take 25x less.
// Why the CUDA cores: a tensor-core f32 product is TF32, which one pass
// cannot carry to the f32 rule, and split TF32 (three passes) would read
// at about the rule's scaled bound itself on the card. So every product is
// an f32 fmaf chain, from 0, the reduced index ascending; the online
// softmax's rescaling is the only order that differs from the plain
// version's, and the rule's o bound holds it (about 2e-7 relative RMS).
// What the design does about the CUDA cores' rate:
// - A block owns BM = 128 query rows of one q head. Warp 0 is the producer:
//   lane 0 loads Q once by TMA, then streams K and V tiles of BN = 64 keys
//   through a two-stage ring up to the causal diagonal (V as two boxes of
//   32 keys, one [32 x D] tile each). GQA reads the shared kv head in
//   place. Every consumer thread arrives on a stage's "empty" barrier after
//   P.V, the last product that reads it.
// - Warpgroups 1 and 2 consume (setmaxnreg 240; warpgroup 0, of which only
//   the producer warp works, keeps 24). Each owns 64 query rows and shares
//   every K/V stage with the other, and each warp owns 16 of those rows
//   outright: S = Q.K^T (a 4 x 8 register tile a thread, rows qg + 16 i,
//   keys kg + 8 j), the online softmax (a row's max and sum over the 8
//   lanes that hold it, by shuffles) and O += P.V (an 8 x 8 tile a thread
//   at d = 128: 8 of the warp's rows by 8 columns) all stay inside one
//   warp, which hands P, each row's alpha and at the end l from the one
//   layout to the other through its own buffer in shared memory. No named
//   barrier: the halves never wait on each other, and a warp's own steps
//   are ordered by __syncwarp.
// - Shared memory: 232,448 bytes a block cannot hold Q (64 KB at d = 128),
//   two stages of K and V (128 KB) and P for 128 rows of 64 keys (36 KB
//   at a conflict-free stride). Of the three ways out -- 32-key tiles,
//   P kept per warp, a 64-row block -- P is kept per warp, 16 rows of 32
//   keys, and each tile's P.V runs in two halves of 32 keys: the S tile
//   stays 4 x 8 (32-key tiles would cut it to 4 x 4 and double the
//   per-tile softmax, waits and shuffles), and a 64-row block would halve
//   the rows each K/V stage serves. 218,152 bytes a block at d = 128.
// - Every operand comes by 16-byte shared reads (hopper.cuh's
//   mm_rows_f32, mm_pb_f32) of the tiles as TMA swizzled them (rows of 32
//   floats, 128-byte span; d = 16: 64-byte span).
// - The sums: each o element is one fma chain over the keys ascending,
//   rescaled by alpha = exp(m_old - m_new) before each tile's P.V; l adds
//   each tile's row sum (this thread's 8 p in order, then the 8 lanes by a
//   fixed butterfly). No atomics: the same bits on every run.
// - Causal: the grid is (b*h, query tiles) with the last query tiles,
//   which visit the most key tiles, launched first; a warpgroup skips the
//   products of a tile wholly above its rows' diagonal (it still releases
//   the stage), and only tiles across the diagonal or the ragged end take
//   the per-element mask.
// - Ragged sq/sk: 3-D tensor maps over [b*h, sq, d] and [b*hk, sk, d];
//   rows outside arrive as zeros, keys past sk are masked (p = 0) and rows
//   past sq are not written.
#include "hopper.cuh"

namespace rtt {

constexpr int FWD_F32_BM = 128;      // query rows a block owns, 64 a consumer warpgroup
constexpr int FWD_F32_BN = 64;       // keys per K/V tile of the ring
constexpr int FWD_F32_HALF = 32;     // keys of a V box and of a warp's P
constexpr int FWD_F32_STAGES = 2;    // K/V ring depth
constexpr int FWD_F32_LDP = FWD_F32_HALF + 8;  // row stride of a warp's P (floats)
constexpr int FWD_F32_THREADS = 384;  // warpgroup 0 produces (one warp), 1-2 consume

// Shared memory of one block, from a 1024-byte aligned base: Q [BM x D],
// then per stage K [BN x D] and V (two [HALF x D] tiles), f32 tiles as TMA
// writes them; each consumer warp's P [16 x LDP]; the barriers.
template <int D>
struct FwdF32Smem {
  static constexpr int QT = FWD_F32_BM * D * 4;  // the Q tile
  static constexpr int KT = FWD_F32_BN * D * 4;  // one K (or V) tile
  static constexpr int RING = QT;
  static constexpr int PS = RING + 2 * FWD_F32_STAGES * KT;
  static constexpr int BAR = PS + 8 * 16 * FWD_F32_LDP * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * FWD_F32_STAGES) + 1024;  // + alignment slack
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  return FwdF32Smem<D>::BYTES;
}

template <int D>
__global__ void __launch_bounds__(FWD_F32_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                 float* __restrict__ lse, int h, int hk, int sq, int sk, float scale,
                 int causal) {
  using S = FwdF32Smem<D>;
  constexpr int BM = FWD_F32_BM, BN = FWD_F32_BN, HALF = FWD_F32_HALF, STAGES = FWD_F32_STAGES;
  constexpr int LDP = FWD_F32_LDP;
  constexpr int CW = D < 32 ? D : 32, SPAN = 4 * CW;
  // the P.V step: a warp's 16 rows by D / 8 groups of 8 columns, as RS row
  // sets (P rows rs + RS i, MI of them) by NCG groups; the 8 lanes of a
  // quarter-warp hold W groups side by side, so that their 16-byte reads of
  // a V row fall in distinct banks
  constexpr int NCG = D / 8, RS = 32 / NCG, MI = NCG / 2;
  constexpr int W = NCG < 4 ? NCG : 4, NH = NCG / W;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the Q tile
  const uint32_t bars = base + S::BAR;  // full_q, full[STAGES], empty[STAGES]
  const uint32_t full_q = bars;
  auto full_bar = [&](int s) { return bars + 8 * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto k_tile = [&](int s) { return base + S::RING + 2 * s * S::KT; };  // V follows at + KT
  // the same shared memory through a generic pointer, for plain loads and stores
  unsigned char* const sb = smem_raw + (base - smem_u32(smem_raw));
  auto tile_of = [&](uint32_t addr) { return reinterpret_cast<const float*>(sb + (addr - base)); };

  const int bh = blockIdx.x;
  const int bkv = (bh / h) * hk + (bh % h) / (h / hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest causal rows first
  int nkb = (sk + BN - 1) / BN;
  if (causal) nkb = min(nkb, (q0 + BM - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 256);  // every consumer thread
    }
    fence_mbar_init();
  }
  __syncthreads();

  // The warpgroup's role, read from lane 0 so that the compiler sees it
  // uniform over the warp (setmaxnreg is warpgroup-collective).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: the first warp; lane 0 issues every TMA load. The
    // consumers take the registers it gives up (240 a thread).
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, S::QT);
      for (int c = 0; c < D / CW; ++c)
        tma_load_3d(base + c * BM * SPAN, &tm_q, full_q, c * CW, q0, bh);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(empty_bar(s), ((kb / STAGES) & 1) ^ 1);  // every consumer is done with it
        const uint32_t kt = k_tile(s);
        mbar_expect_tx(full_bar(s), 2 * S::KT);
        for (int c = 0; c < D / CW; ++c) {
          tma_load_3d(kt + c * BN * SPAN, &tm_k, full_bar(s), c * CW, kb * BN, bkv);
          for (int hf = 0; hf < 2; ++hf)
            tma_load_3d(kt + S::KT + hf * (S::KT / 2) + c * HALF * SPAN, &tm_v, full_bar(s),
                        c * CW, kb * BN + hf * HALF, bkv);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cons owns rows r0 .. r0 + 63, warp w of its
  // 4 the 16 rows qg + 16 i (qg = 4 w + a: quarter-warp a, i < 4), which
  // are rows a + 4 i of the warp's P
  setmaxnreg_inc<240>();
  const int ct = threadIdx.x - 128, cons = ct / 128, lt = ct % 128, lane = lt % 32;
  const int qg = lt / 8, kg = lt % 8, a = lane / 8;
  const int cg = lane % W + W * ((lane / 8) % NH);                    // P.V: columns 8 cg ..
  const int rs = (lane / W) % (8 / W) + (8 / W) * (lane / (8 * NH));  // and P rows rs + RS i
  const int r0 = q0 + 64 * cons;
  const float* qt = tile_of(base) + 64 * cons * CW;  // this warpgroup's rows of Q
  float* pw = reinterpret_cast<float*>(sb + S::PS) + (ct / 32) * 16 * LDP;  // this warp's P
  float m[4], l[4], acc[MI][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  mbar_wait(full_q, 0);

  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % STAGES, k0 = kb * BN;
    const float* kt = tile_of(k_tile(s));
    mbar_wait(full_bar(s), (kb / STAGES) & 1);
    if (!causal || k0 <= r0 + 63) {  // a tile above every row's diagonal is all p = 0
      // S = Q.K^T over d, then scaled as the plain version scales it
      float sc[4][8];
      mm_rows_f32<D, BM, BN, 4, 8, 16, 8>(sc, qt, qg, kt, kg);
      const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > r0);
      float alpha[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = r0 + qg + 16 * i;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kj = k0 + kg + 8 * j;
          const bool masked = edge && (kj >= sk || (causal && kj > qi));
          sc[i][j] = masked ? NEG_INF : __fmul_rn(sc[i][j], scale);
          mx = fmaxf(mx, sc[i][j]);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = expf(m[i] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kj = k0 + kg + 8 * j;
          const bool masked = edge && (kj >= sk || (causal && kj > qi));
          sc[i][j] = masked ? 0.f : expf(sc[i][j] - m_new);
          rs += sc[i][j];
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
        l[i] = alpha[i] * l[i] + rs;
        m[i] = m_new;
      }
      // O += P.V, 32 keys at a time through this warp's P; its column HALF
      // carries each row's alpha to the lanes that hold the row's O
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        __syncwarp();  // the warp's last P.V is done with its P
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) pw[(a + 4 * i) * LDP + kg + 8 * j] = sc[i][4 * hf + j];
          if (hf == 0 && kg == 0) pw[(a + 4 * i) * LDP + HALF] = alpha[i];
        }
        __syncwarp();
        if (hf == 0) {
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const float al = pw[(rs + RS * i) * LDP + HALF];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] *= al;
          }
        }
        mm_pb_f32<D, HALF, MI, RS, LDP>(acc, pw, rs, kt + (S::KT + hf * (S::KT / 2)) / 4, cg);
      }
    }
    mbar_arrive(empty_bar(s));  // after P.V, the last product that read the stage
  }

  // o = O / l: l goes to the lanes that hold the row's O as alpha went
  __syncwarp();
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pw[(a + 4 * i) * LDP + HALF] = l[i];
      const int qi = r0 + qg + 16 * i;
      if (qi < sq) lse[(size_t)bh * sq + qi] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int pr = rs + RS * i;  // row (pr % 4) + 16 (pr / 4) of the warp's
    const int qi = r0 + 4 * (lt / 32) + pr % 4 + 16 * (pr / 4);
    if (qi >= sq) continue;
    const float lc = fmaxf(pw[pr * LDP + HALF], 1e-30f);
    float* out = o + ((size_t)bh * sq + qi) * D + 8 * cg;
    *reinterpret_cast<float4*>(out) =
        make_float4(acc[i][0] / lc, acc[i][1] / lc, acc[i][2] / lc, acc[i][3] / lc);
    *reinterpret_cast<float4*>(out + 4) =
        make_float4(acc[i][4] / lc, acc[i][5] / lc, acc[i][6] / lc, acc[i][7] / lc);
  }
}

template <int D>
int fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int h,
               int hk, int sq, int sk, float scale, int causal, void* stream) {
  constexpr int CW = D < 32 ? D : 32;
  const int bkv = bh / h * hk;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map_3d(&tm_q, q, bh, sq, D, FWD_F32_BM, CW, true) ||
      !tensor_map_3d(&tm_k, k, bkv, sk, D, FWD_F32_BN, CW, true) ||
      !tensor_map_3d(&tm_v, v, bkv, sk, D, FWD_F32_HALF, CW, true))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (sq + FWD_F32_BM - 1) / FWD_F32_BM);
  return (int)launch_block(flash_fwd_kernel<D>, grid, FWD_F32_THREADS, fwd_smem_bytes<D>(), stream,
                           tm_q, tm_k, tm_v, static_cast<float*>(o), static_cast<float*>(lse), h,
                           hk, sq, sk, scale, causal);
}

// flash_fwd_tc.cu: the bf16 kernel
int flash_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int h,
                 int hk, int sq, int sk, int head_dim, float scale, int causal, void* stream);

}  // namespace rtt

// q [b*h, sq, d]; k, v [b*hk, sk, d]; o like q; lse [b*h, sq] f32.
// dtype 0 = float32 (CUDA cores, here), 1 = bfloat16 (wgmma). q, k and v
// must start on 16-byte boundaries (TMA reads them); the wrapper checks.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int bh, int h, int hk, int sq, int sk, int head_dim, float scale,
                             int causal, int dtype, void* stream) {
  if (dtype == 1)
    return rtt::flash_fwd_tc(q, k, v, o, lse, bh, h, hk, sq, sk, head_dim, scale, causal, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  RTT_DISPATCH_D(head_dim, rtt::fwd_launch<D>(q, k, v, o, lse, bh, h, hk, sq, sk, scale, causal,
                                              stream));
}

extern "C" int rtt_flash_fwd_smem_bytes(int head_dim) { RTT_SMEM_BYTES(rtt::fwd_smem_bytes, head_dim); }

// Flash-attention backward, dq pass, f32: TMA loads into an mbarrier ring,
// one producer warp and eight consumer warps, every product exact f32 on
// the CUDA cores.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_bwd_dq_kernel (first
// pallas_call of _flash_bwd) for f32 inputs; rtt_flash_bwd_dq below hands
// bf16 inputs to the wgmma kernel of flash_bwd_dq_tc.cu. For every
// (batch*head, query row):
//   p  = exp(q.K^T * scale - lse)
//   dS = p o (dO.V^T - delta) * scale
//   dq = dS . K
// with delta = rowsum(dO o O) computed by the caller, every sum in f32,
// the causal mask top-left aligned, and ragged lengths masked.
//
// Bound: operations. 3 products of 2*b*h*pairs*d FLOP each: at b=2, h=32,
// S=2048, d=128, causal, 103.1 GFLOP, 1.54 ms at the CUDA cores' 67
// TFLOP/s; the bytes take 15x less. The products stay exact f32 fma chains
// in the plain version's order for the reason flash_bwd_dkv.cu gives (the
// f32 rule against cuBLAS's chains; dq's first causal row, where dS
// cancels to rounding noise, needs dP to half an ulp). The design is
// flash_bwd_dkv.cu's with the roles of queries and keys exchanged:
// - A block owns BM = 64 query rows of one q head. Warp 0 is the producer:
//   lane 0 loads Q and dO once by TMA, then streams K and V tiles of BN =
//   64 keys through a two-stage ring up to the causal diagonal. GQA reads
//   the shared kv head in place. Every consumer thread arrives on a
//   stage's "empty" barrier after dS.K, the last product that reads it.
// - Warpgroups 1 and 2 consume (setmaxnreg 240; warpgroup 0, of which
//   only the producer warp works, keeps 24), in two halves. Per tile,
//   half 0 computes S = Q.K^T and half 1 dP = dO.V^T (4 x 8 register
//   tiles a thread); half 0 writes P to shared memory, half 1 turns it
//   into dS in place at its own positions; then all 256 threads sum dQ +=
//   dS.K (4 x 8 tiles at d = 128, the keys in order). The dq sum stays in registers for the whole
//   loop: no atomics, the same bits on every run.
// - Shared memory at d = 128: Q and dO 64 KB, two stages of K and V 128
//   KB, P and dS 18 KB: 216,104 bytes a block.
// - Causal: the grid is (b*h, query tiles) with the last query tiles,
//   which visit the most key tiles, launched first; masked pairs take
//   p = 0.
// - Ragged sq/sk: rows outside the tensors arrive as zeros; keys past sk
//   are masked (p = 0) and rows past sq are not written.
#include "hopper.cuh"

namespace rtt {

constexpr int DQ_F32_BM = 64;      // query rows a block owns
constexpr int DQ_F32_BN = 64;      // keys per K/V tile of the ring
constexpr int DQ_F32_STAGES = 2;   // K/V ring depth
constexpr int DQ_F32_LDP = DQ_F32_BN + 8;  // row stride of P and dS (floats)
constexpr int DQ_F32_THREADS = 384;  // warpgroup 0 produces (one warp), 1-2 consume

// Shared memory of one block, from a 1024-byte aligned base: Q and dO
// [BM x D], then per stage K and V [BN x D] (f32 tiles as TMA writes them);
// P, then dS in its place [BM x LDP]; the barriers.
template <int D>
struct DqF32Smem {
  static constexpr int QT = DQ_F32_BM * D * 4;  // the Q (or dO) tile
  static constexpr int KT = DQ_F32_BN * D * 4;  // one K (or V) tile
  static constexpr int RING = 2 * QT;
  static constexpr int PS = RING + 2 * DQ_F32_STAGES * KT;
  static constexpr int BAR = PS + DQ_F32_BM * DQ_F32_LDP * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * DQ_F32_STAGES) + 1024;  // + alignment slack
};

template <int D>
constexpr size_t dq_smem_bytes() {
  return DqF32Smem<D>::BYTES;
}

template <int D>
__global__ void __launch_bounds__(DQ_F32_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int h, int hk,
                    int sq, int sk, float scale, int causal) {
  using S = DqF32Smem<D>;
  constexpr int BM = DQ_F32_BM, BN = DQ_F32_BN, STAGES = DQ_F32_STAGES, LDP = DQ_F32_LDP;
  constexpr int CW = D < 32 ? D : 32, SPAN = 4 * CW;
  // the output step: a thread owns 8 columns (group cg) of MI query rows
  // (rg + NRG i); at d = 16 only the first NRG * NCG threads have rows
  constexpr int NCG = D / 8, NRG = 256 / NCG < BM ? 256 / NCG : BM, MI = BM / NRG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the Q tile; dO follows
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
    if (threadIdx.x == 0 && nkb > 0) {
      mbar_expect_tx(full_q, 2 * S::QT);
      for (int c = 0; c < D / CW; ++c) {
        tma_load_3d(base + c * BM * SPAN, &tm_q, full_q, c * CW, q0, bh);
        tma_load_3d(base + S::QT + c * BM * SPAN, &tm_do, full_q, c * CW, q0, bh);
      }
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(empty_bar(s), ((kb / STAGES) & 1) ^ 1);  // every consumer is done with it
        const uint32_t kt = k_tile(s);
        mbar_expect_tx(full_bar(s), 2 * S::KT);
        for (int c = 0; c < D / CW; ++c) {
          tma_load_3d(kt + c * BN * SPAN, &tm_k, full_bar(s), c * CW, kb * BN, bkv);
          tma_load_3d(kt + S::KT + c * BN * SPAN, &tm_v, full_bar(s), c * CW, kb * BN, bkv);
        }
      }
    }
    return;
  }

  // ---- consumers: half 0 takes S and P, half 1 dP and dS; all take dQ
  setmaxnreg_inc<240>();
  const int ct = threadIdx.x - 128, half = ct / 128, lt = ct % 128;
  const int qg = lt / 8, kg = lt % 8;   // score step: queries qg + 16i, keys kg + 8j
  const int cg = ct % NCG, rg = ct / NCG;  // output step: queries rg + NRG i, columns 8 cg + j
  const float* qo_tile = tile_of(base + half * S::QT);  // Q for S, dO for dP
  float* ps = reinterpret_cast<float*>(sb + S::PS);
  float row[4];  // lse (half 0) or delta (half 1) of query rows q0 + qg + 16i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + qg + 16 * i;
    row[i] = qi < sq ? (half ? delta : lse)[(size_t)bh * sq + qi] : 0.f;
  }
  float acc[MI][8];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (nkb > 0) mbar_wait(full_q, 0);

  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % STAGES, k0 = kb * BN;
    const float* kt = tile_of(k_tile(s));
    mbar_wait(full_bar(s), (kb / STAGES) & 1);
    // S = Q.K^T (half 0) or dP = dO.V^T (half 1) over d
    float sc[4][8];
    mm_rows_f32<D, BM, BN, 4, 8, 16, 8>(sc, qo_tile, qg, kt + half * (S::KT / 4), kg);
    named_barrier_sync(1, 256);  // the last tile's dQ is done with dS
    if (half == 0) {  // P, rounded where the plain version rounds
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kj = k0 + kg + 8 * j;
          const bool ok = kj < sk && (!causal || kj <= q0 + qg + 16 * i);
          ps[(qg + 16 * i) * LDP + kg + 8 * j] =
              ok ? expf(__fsub_rn(__fmul_rn(sc[i][j], scale), row[i])) : 0.f;
        }
    }
    named_barrier_sync(1, 256);
    if (half == 1) {  // dS in place of P, at this thread's own positions
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& p = ps[(qg + 16 * i) * LDP + kg + 8 * j];
          p = p * (sc[i][j] - row[i]) * scale;
        }
    }
    named_barrier_sync(1, 256);
    // dQ += dS.K over the tile's keys
    if (NRG * NCG == 256 || ct < NRG * NCG) mm_pb_f32<D, BN, MI, NRG, LDP>(acc, ps, rg, kt, cg);
    mbar_arrive(empty_bar(s));  // after dS.K, the last product that read the stage
  }

  if (NRG * NCG == 256 || ct < NRG * NCG) {
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int qi = q0 + rg + NRG * i;
      if (qi >= sq) continue;
      float* out = dq + ((size_t)bh * sq + qi) * D + 8 * cg;
      *reinterpret_cast<float4*>(out) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(out + 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <int D>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int bh, int h, int hk, int sq, int sk, float scale,
              int causal, void* stream) {
  constexpr int CW = D < 32 ? D : 32;
  const int bkv = bh / h * hk;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!tensor_map_3d(&tm_q, q, bh, sq, D, DQ_F32_BM, CW, true) ||
      !tensor_map_3d(&tm_do, dout, bh, sq, D, DQ_F32_BM, CW, true) ||
      !tensor_map_3d(&tm_k, k, bkv, sk, D, DQ_F32_BN, CW, true) ||
      !tensor_map_3d(&tm_v, v, bkv, sk, D, DQ_F32_BN, CW, true))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, (sq + DQ_F32_BM - 1) / DQ_F32_BM);
  return (int)launch_block(flash_bwd_dq_kernel<D>, grid, DQ_F32_THREADS, dq_smem_bytes<D>(),
                           stream, tm_q, tm_do, tm_k, tm_v, static_cast<const float*>(lse),
                           static_cast<const float*>(delta), static_cast<float*>(dq), h, hk, sq,
                           sk, scale, causal);
}

// flash_bwd_dq_tc.cu: the bf16 kernel
int flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, int bh, int h, int hk, int sq, int sk,
                    int head_dim, float scale, int causal, void* stream);

}  // namespace rtt

// q, dout, dq [b*h, sq, d]; k, v [b*hk, sk, d]; lse, delta [b*h, sq] f32.
// dtype 0 = float32 (CUDA cores, here), 1 = bfloat16 (wgmma). q, k, v and
// dout must start on 16-byte boundaries (TMA reads them); the wrapper
// checks.
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int bh, int h,
                                int hk, int sq, int sk, int head_dim, float scale, int causal,
                                int dtype, void* stream) {
  if (dtype == 1)
    return rtt::flash_bwd_dq_tc(q, k, v, dout, lse, delta, dq, bh, h, hk, sq, sk, head_dim, scale,
                                causal, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  RTT_DISPATCH_D(head_dim, rtt::dq_launch<D>(q, k, v, dout, lse, delta, dq, bh, h, hk, sq, sk,
                                             scale, causal, stream));
}

extern "C" int rtt_flash_bwd_dq_smem_bytes(int head_dim) { RTT_SMEM_BYTES(rtt::dq_smem_bytes, head_dim); }

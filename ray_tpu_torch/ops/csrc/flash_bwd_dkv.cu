// Flash-attention backward, dk/dv pass, f32: TMA loads into an mbarrier
// ring, one producer warp and eight consumer warps, every product exact f32
// on the CUDA cores.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_bwd_dkv_kernel (second
// pallas_call of _flash_bwd) for f32 inputs; rtt_flash_bwd_dkv below hands
// bf16 inputs to the wgmma kernel of flash_bwd_dkv_tc.cu. For every
// (batch*kv_head, key row), summed over every q head of the GQA group and
// every query:
//   p  = exp(q.k * scale - lse)
//   dv += p . dO
//   dS = p o (dO.v - delta) * scale
//   dk += dS . q
// with every sum in f32, the causal mask top-left aligned, and ragged
// lengths masked.
//
// Bound: operations. 4 products of 2*b*h*pairs*d FLOP each (pairs = the
// (q, k) pairs the mask keeps): at b=2, h=32, S=2048, d=128, causal, 137.5
// GFLOP, 2.05 ms at the CUDA cores' 67 TFLOP/s; the bytes take 20x less.
// Why the CUDA cores and not split TF32 on the tensor cores (3 TF32 passes
// a product, 165 TFLOP/s): the f32 rule holds this kernel to the plain
// version, whose products are cuBLAS's sequential f32 fma chains. At S=2048
// those chains carry about 1.1e-6 of relative error against the same
// products in f64 (kernel_check --times), so any other order -- split
// TF32's too, though it reads about 2.5e-7 against f64 in emulation
// (tests/test_torch_attention_f32.py) -- reads over the rule's 1e-6 RMS
// against them; and dq's first causal row, where dS cancels to rounding
// noise, must match dP to half an ulp. So every product here is the same
// fma chain, from 0, the reduced index ascending, and the outputs equal
// the plain version's bits. What the design does about the CUDA cores'
// rate:
// - A block owns BK = 64 keys of one kv head. Warp 0 is the producer: lane
//   0 loads K and V once by TMA, then streams Q and dO tiles of BQ = 32
//   queries, (q head, q tile) after (q head, q tile), through a two-stage
//   ring; its 32 lanes copy the tile's lse and delta into the stage and
//   arrive on the stage's "full" barrier beside the TMA bytes. Every
//   consumer thread arrives on the stage's "empty" barrier after the last
//   product that reads it.
// - Warpgroups 1 and 2 consume (setmaxnreg 240; warpgroup 0, of which
//   only the producer warp works, keeps 24), in two halves. Per tile, half 0
//   computes S^T = K.Q^T and half 1 dP^T = V.dO^T (4 x 4 register tiles a
//   thread); half 0 writes P^T to shared memory, half 1 reads it back at
//   its own positions and writes dS^T; then half 0 sums dV += P^T.dO and
//   half 1 dK += dS^T.Q (8 x 8 register tiles at d = 128, the reduced
//   index over the tile's queries in order). Named barriers over the 256
//   consumers order the three steps.
// - Every operand comes by 16-byte shared reads (hopper.cuh's
//   mm_rows_f32, mm_pb_f32): per 4 steps of the reduced index a thread
//   reads one chunk of each of its rows and columns for 4 x rows x columns
//   fmas; the swizzle TMA writes keeps each warp's reads in distinct banks.
// - The GQA sum is taken in the plain version's order: each q head's sum
//   in registers, then the heads added in turn into this thread's slots of
//   a shared-memory total. No atomics, no second pass: the same bits on
//   every run.
// - Shared memory at d = 128: K and V 64 KB, two stages of Q and dO 64 KB,
//   lse and delta 512 B, P^T and dS^T 20 KB, the group total 64 KB:
//   218,664 bytes a block.
// - Causal: the q loop starts at the tile holding the block's first key;
//   masked pairs take p = 0. The grid is (b*hk, key tiles), so the low
//   key tiles, which visit the most q tiles, launch first.
// - Ragged sq/sk: 3-D tensor maps over [b*h, sq, d] and [b*hk, sk, d];
//   rows outside arrive as zeros, queries past sq are masked (p = 0), and
//   rows of keys past sk are not written.
#include "hopper.cuh"

namespace rtt {

constexpr int DKV_F32_BK = 64;       // keys a block owns
constexpr int DKV_F32_BQ = 32;       // queries per Q/dO tile of the ring
constexpr int DKV_F32_STAGES = 2;    // Q/dO ring depth
constexpr int DKV_F32_LDP = DKV_F32_BQ + 8;  // row stride of P^T and dS^T (floats)
constexpr int DKV_F32_THREADS = 384;  // warpgroup 0 produces (one warp), 1-2 consume

// Shared memory of one block, from a 1024-byte aligned base: K and V
// [BK x D], then per stage Q and dO [BQ x D] (f32 tiles as TMA writes
// them); per stage lse and delta [BQ]; P^T and dS^T [BK x LDP]; the group
// total (256 threads x D/2); the barriers.
template <int D>
struct DkvF32Smem {
  static constexpr int KV = DKV_F32_BK * D * 4;  // the K (or V) tile
  static constexpr int QT = DKV_F32_BQ * D * 4;  // one Q (or dO) tile
  static constexpr int RING = 2 * KV;
  static constexpr int ROWS = RING + 2 * DKV_F32_STAGES * QT;
  static constexpr int PT = ROWS + 2 * DKV_F32_STAGES * DKV_F32_BQ * 4;
  static constexpr int DST = PT + DKV_F32_BK * DKV_F32_LDP * 4;
  static constexpr int TOT = DST + DKV_F32_BK * DKV_F32_LDP * 4;
  static constexpr int BAR = TOT + 256 * (D / 2) * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * DKV_F32_STAGES) + 1024;  // + alignment slack
};

template <int D>
constexpr size_t dkv_smem_bytes() {
  return DkvF32Smem<D>::BYTES;
}

template <int D>
__global__ void __launch_bounds__(DKV_F32_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int h, int hk, int sq, int sk, float scale,
                     int causal) {
  using S = DkvF32Smem<D>;
  constexpr int BK = DKV_F32_BK, BQ = DKV_F32_BQ, STAGES = DKV_F32_STAGES, LDP = DKV_F32_LDP;
  constexpr int CW = D < 32 ? D : 32, SPAN = 4 * CW;
  // the output step: a thread owns 8 columns (group cg) of MI keys (rg + NRG i)
  constexpr int NCG = D / 8, NRG = 128 / NCG, MI = BK / NRG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the K tile; V follows
  const uint32_t bars = base + S::BAR;  // full_kv, full[STAGES], empty[STAGES]
  const uint32_t full_kv = bars;
  auto full_bar = [&](int s) { return bars + 8 * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto q_tile = [&](int s) { return base + S::RING + 2 * s * S::QT; };  // dO follows at + QT
  // the same shared memory through a generic pointer, for plain loads and stores
  unsigned char* const sb = smem_raw + (base - smem_u32(smem_raw));
  auto tile_of = [&](uint32_t addr) { return reinterpret_cast<const float*>(sb + (addr - base)); };
  auto rows_at = [&](int s) {  // lse, then delta
    return reinterpret_cast<float*>(sb + S::ROWS + 2 * s * BQ * 4);
  };

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
      mbar_init(full_bar(s), 32);   // the producer warp's lanes (lane 0's carries the bytes)
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
    const int lane = threadIdx.x;
    if (lane < 32 && n_it > 0) {
      if (lane == 0) {
        mbar_expect_tx(full_kv, 2 * S::KV);
        for (int c = 0; c < D / CW; ++c) {
          tma_load_3d(base + c * BK * SPAN, &tm_k, full_kv, c * CW, k0, bkv);
          tma_load_3d(base + S::KV + c * BK * SPAN, &tm_v, full_kv, c * CW, k0, bkv);
        }
      }
      int bh = qh0, qi = qb0;  // the pair's q head and q tile
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES, q0 = qi * BQ;
        mbar_wait(empty_bar(s), ((it / STAGES) & 1) ^ 1);  // every consumer is done with it
        float* rows = rows_at(s);
        const size_t row0 = (size_t)bh * sq + q0;
        for (int i = lane; i < BQ; i += 32) {
          const bool ok = q0 + i < sq;
          rows[i] = ok ? lse[row0 + i] : 0.f;
          rows[BQ + i] = ok ? delta[row0 + i] : 0.f;
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
    return;
  }

  // ---- consumers: half 0 takes S^T, P^T and dV; half 1 dP^T, dS^T and dK
  setmaxnreg_inc<240>();
  const int ct = threadIdx.x - 128, half = ct / 128, lt = ct % 128;
  const int kg = lt / 8, qg = lt % 8;        // score step: keys kg + 16i, queries qg + 8j
  const int cg = lt % NCG, rg = lt / NCG;    // output step: keys rg + NRG i, columns 8 cg + j
  const float* kv_tile = tile_of(base + half * S::KV);  // K for S^T, V for dP^T
  float* pt = reinterpret_cast<float*>(sb + S::PT);
  float* dst = reinterpret_cast<float*>(sb + S::DST);
  float* tot = reinterpret_cast<float*>(sb + S::TOT);

  float acc[MI][8];  // this q head's dV (half 0) or dK (half 1)
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (n_it > 0) mbar_wait(full_kv, 0);

  for (int it = 0, qi = qb0, head = 0; it < n_it; ++it) {
    const int s = it % STAGES, q0 = qi * BQ;
    const float* qt = tile_of(q_tile(s));
    const float* dot = qt + S::QT / 4;
    const float* rows = rows_at(s);
    mbar_wait(full_bar(s), (it / STAGES) & 1);
    // S^T = K.Q^T (half 0) or dP^T = V.dO^T (half 1) over d
    float sc[4][4];
    mm_rows_f32<D, BK, BQ, 4, 4, 16, 8>(sc, kv_tile, kg, half ? dot : qt, qg);
    named_barrier_sync(1, 256);  // the last tile's dV and dK are done with P^T and dS^T
    if (half == 0) {  // P^T, rounded where the plain version rounds
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = qg + 8 * j;
          const bool ok = q0 + q < sq && (!causal || q0 + q >= k0 + kg + 16 * i);
          pt[(kg + 16 * i) * LDP + q] =
              ok ? expf(__fsub_rn(__fmul_rn(sc[i][j], scale), rows[q])) : 0.f;
        }
    }
    named_barrier_sync(1, 256);
    if (half == 1) {  // dS^T from this thread's dP^T and the same positions of P^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = qg + 8 * j, at = (kg + 16 * i) * LDP + q;
          dst[at] = pt[at] * (sc[i][j] - rows[BQ + q]) * scale;
        }
    }
    named_barrier_sync(1, 256);
    // dV += P^T.dO (half 0) or dK += dS^T.Q (half 1) over the tile's queries
    mm_pb_f32<D, BQ, MI, NRG, LDP>(acc, half ? dst : pt, rg, half ? qt : dot, cg);
    mbar_arrive(empty_bar(s));  // after the last product that read the stage
    if (++qi == qb0 + nq) {  // this q head is done: add it to the group's total
      qi = qb0;
      if (group > 1) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float* a = tot + (8 * i + j) * 256 + ct;
            *a = head ? *a + acc[i][j] : acc[i][j];
            acc[i][j] = 0.f;
          }
      }
      ++head;
    }
  }
  if (group > 1 && n_it > 0) {  // the group's total, this thread's own slots
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = tot[(8 * i + j) * 256 + ct];
  }

  float* out = half ? dk : dv;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int kj = k0 + rg + NRG * i;
    if (kj >= sk) continue;
    float* row = out + ((size_t)bkv * sk + kj) * D + 8 * cg;
    *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

template <int D>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int bkv, int h, int hk, int sq, int sk,
               float scale, int causal, void* stream) {
  constexpr int CW = D < 32 ? D : 32;
  const int bh = bkv / hk * h;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!tensor_map_3d(&tm_q, q, bh, sq, D, DKV_F32_BQ, CW, true) ||
      !tensor_map_3d(&tm_do, dout, bh, sq, D, DKV_F32_BQ, CW, true) ||
      !tensor_map_3d(&tm_k, k, bkv, sk, D, DKV_F32_BK, CW, true) ||
      !tensor_map_3d(&tm_v, v, bkv, sk, D, DKV_F32_BK, CW, true))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(bkv, (sk + DKV_F32_BK - 1) / DKV_F32_BK);
  return (int)launch_block(flash_bwd_dkv_kernel<D>, grid, DKV_F32_THREADS, dkv_smem_bytes<D>(), stream,
                           tm_q, tm_do, tm_k, tm_v, static_cast<const float*>(lse),
                           static_cast<const float*>(delta), static_cast<float*>(dk),
                           static_cast<float*>(dv), h, hk, sq, sk, scale, causal);
}

// flash_bwd_dkv_tc.cu: the bf16 kernel
int flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int bkv, int h, int hk,
                     int sq, int sk, int head_dim, float scale, int causal, void* stream);

}  // namespace rtt

// q, dout [b*h, sq, d]; k, v, dk, dv [b*hk, sk, d]; lse, delta [b*h, sq] f32.
// dtype 0 = float32 (CUDA cores, here), 1 = bfloat16 (wgmma). q, k, v and
// dout must start on 16-byte boundaries (TMA reads them); the wrapper
// checks.
extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int bkv, int h, int hk, int sq, int sk, int head_dim,
                                 float scale, int causal, int dtype, void* stream) {
  if (dtype == 1)
    return rtt::flash_bwd_dkv_tc(q, k, v, dout, lse, delta, dk, dv, bkv, h, hk, sq, sk, head_dim,
                                 scale, causal, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  RTT_DISPATCH_D(head_dim, rtt::dkv_launch<D>(q, k, v, dout, lse, delta, dk, dv, bkv, h, hk, sq,
                                              sk, scale, causal, stream));
}

extern "C" int rtt_flash_bwd_dkv_smem_bytes(int head_dim) { RTT_SMEM_BYTES(rtt::dkv_smem_bytes, head_dim); }

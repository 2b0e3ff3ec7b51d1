// Backward of flash attention on Hopper (sm_90a) for head dimensions 8,
// 16, 32 and 64 (template instances) and every multiple of 64 from 128 up
// (the wide body): every product on wgmma (bf16 operands, f32 sums), TMA
// for the loads. The f32 backward at head
// dim 8 runs its own narrow body (flash_narrow_bwd.cu), through this
// file's entries; the template's head-dim-8 instance is built in bf16
// only.
//
// Replaces the two Pallas kernels of the TPU flash attention's backward
// that ipdm_tpu/models/unet.py:601 _flash_attention reaches when the JAX
// package trains (jax/experimental/pallas/ops/tpu/flash_attention.py:254
// _flash_attention_bwd): _flash_attention_bwd_dkv (:941, pallas_call
// :1121) and _flash_attention_bwd_dq (:1287, pallas_call :1456), and the
// di = sum(o * do) before them (:273). With c = scale2 (the one scale of
// the forward, applied to the f32 score) and lse the forward's natural-log
// normaliser per query row:
//
//   P    = exp(c * Q K^T - lse)         (rebuilt, never stored)
//   D    = rowsum(dO * O)               flash_bwd_dot_kernel
//   dV   = P^T dO                       flash_bwd_kernel<dkv>
//   dS   = P * (dO V^T - D)
//   dK   = c * dS^T Q                   flash_bwd_kernel<dkv>
//   dQ   = c * dS K                     flash_bwd_kernel<dq>
//
// q, k, v, o, do, dq, dk, dv: [BH, T, HD] of one element type E (bf16 or
// f32), contiguous, HD in {8, 16, 32, 64} (a template instance each; the
// tiles lie HDP = max(HD, 16) columns wide in shared memory, zero-padded
// at HD = 8: hopper.cuh's Head<HD>) or a multiple of 64 from
// IPDM_FLASH_BWD_WIDE_FROM (128) up (the wide body, after the template);
// other head dims reach a kernel zero-padded by the wrapper;
// lse, D: [BH, T] f32. The gradients are with respect to the unscaled q
// and k, so each carries c once.
//
// The two element types:
// - bf16: the operands go to the tensor cores as they are. S and dP are f32
//   sums; P and dS are rounded to bf16 before the products that read them,
//   as the library's kernels round them (p.T.astype(do.dtype) for dV,
//   flash_attention.py:900; ds.T.astype for dK, :918; ds.astype for dQ,
//   :1258).
// - f32: each operand is split, x ~ hi + lo with hi = bf16(x) and
//   lo = bf16(x - hi) (16 of f32's 24 bits), and each product is three bf16
//   passes hi*hi + hi*lo + lo*hi into the same f32 sums, lo*lo dropped: how
//   a TPU's matrix unit builds f32 products (XLA's precision HIGH). P and dS
//   are split in registers the same way. D is the row sum of O with the dO
//   that the products see (hi + lo), so that sum_j dS_ij = 0 holds for the
//   split operands: dQ of inputs where it is a cancellation (every key
//   alike) then keeps f32's relative accuracy (tests/test_torch_flash_bwd.py
//   holds the write-out of this body to the f32 rules, beside a one-pass
//   control that misses them).
//
// No atomics: as the JAX library splits the work, one kernel owns dK and dV
// per key tile (walking every query tile) and the other owns dQ per query
// tile (walking every key tile), so each output has one writer and a fixed
// sum order, and two launches give the same bits.
//
// What bounds them on an H100: 5 products of T*T*HD multiply-adds per
// head; the dQ kernel rebuilds S and dP (3 products), the dK/dV kernel
// too (4). At HD = 64, T = 7125 and 4 heads: dq 0.0788 ms, dkv 0.1051 ms
// at the 989 TFLOP/s bf16 tensor-core rate; three times that in f32
// (0.2365 / 0.3154 ms). The T*T exp2 of P run on the special-function
// units beside them (4.2e12/s: 0.05 ms per kernel at T = 7125). At
// HD = 8, T = 114 000 and 4 heads the exp2 leads: 12.4 ms per kernel,
// against f32 products of 3 * 3 * 2*T*T*8*4 = 7.5e12 flops (dq, 7.6 ms)
// and 4 * 3 * 2*T*T*8*4 = 1.0e13 (dkv, 10.1 ms): flash_narrow_bwd.cu's
// body in f32; the bf16 instance here runs HD = 8 at 16 columns (the
// head-dimension side of every product padded to 16). The T x T matrices
// never leave the SM.
//
// Design (one CTA = 128 resident rows of one head, both kernels):
// - The dq kernel holds 128 query rows (Q, dO) and walks the 64-key tiles
//   of K and V; the dkv kernel holds 128 keys (K, V) and walks the 64-query
//   tiles of Q and dO, with their lse and D. Resident X, Y and ring U, W
//   below: (Q, dO, K, V) for dq, (K, V, Q, dO) for dkv.
// - Loads: one lane issues each TMA (3-D tensor maps [BH, T, HD]; rows
//   past T arrive as zeros) into a ring of STAGES shared-memory slots, each
//   with a full mbarrier (the TMA's transaction count): warp 0 the first
//   STAGES tiles before the loop, then, when the 8 warps are done with a
//   slot's tile, the last of them to say so (a shared counter) refills it
//   with the tile STAGES further on, so no warp waits for another to free a
//   slot. In the dkv kernel that warp's 32 lanes also copy the slot's 64
//   query rows' lse and D with cp.async (rows past T zero-filled) and have
//   the full barrier track the copies. No producer warp: a ninth warp would
//   put three warps on one of the SM's four register files (168 registers
//   a thread, 96 with two CTAs), and the bodies need more.
// - Warps 0-7 are two warpgroups of 64 resident rows each. Per
//   ring tile: S = X U^T and dP = Y W^T are wgmma chains from shared memory
//   (all four K-major, the swizzle of the row's bytes) into 2 x 32 f32
//   registers; P =
//   exp2(c * log2(e) * S - lse2) and dS = P (dP - D) on those registers,
//   rounded (bf16) or split (f32) into register-A fragments in place (the
//   m64n64 accumulator layout is the m64k16 A layout); then register-A
//   wgmmas with the ring tile as the MN-major (transposed) B operand:
//   dQ += dS K, or dV += P^T dO and dK += dS^T Q. In dq the rows' lse and
//   D sit in registers; in dkv each thread reads the lse and D of its 16
//   query columns from the slot. Ring rows past T (keys in dq, queries in
//   dkv) get P = 0: a zero-filled key would score 0, not -inf.
// - f32 below head dim 64: each ring tile's products are summed from zero
//   and added to dQ (dK, dV) with an f32 add, as flash_attn.cu sums P V:
//   the tensor cores' f32 sums do not round to nearest, and chained over
//   the 1782 key tiles of T = 114 000 they biased dQ to 1.2x the f32 rule
//   (chip_smoke.py flash-hd). Head dim 64 and the wide body keep the
//   chain: at 128 and 256 it is within the f32 rule at T = 16 384
//   (chip_smoke.py flash-hd), and the tile sums would not fit beside the
//   chained sums in registers.
// - f32: TMA brings the ring tile's f32 rows into a staging slot (no
//   swizzle); the CTA's 256 threads split it into hi and lo bf16 tiles in
//   the tile's swizzle (a double buffer), fence the stores for the async
//   proxy and meet at a named
//   barrier before the wgmmas read them. The resident rows are loaded and
//   split once by their warpgroup.
// - Waves and registers: 128-row CTAs give 56 x 4 = 224 CTAs at T = 7125
//   and 128 at T = 4096 (BH = 4). The bf16 dq kernel keeps two CTAs on an
//   SM (99 KB of shared memory, at most 128 registers a thread); the dkv
//   kernel (four 32-register accumulators live at once) and the f32 bodies
//   (two bf16 tiles per operand, 194 KB) run one CTA per SM. No setmaxnreg
//   (flash_attn.cu's note).
// - From IPDM_FLASH_BWD_WIDE_FROM (128) up, both dtypes (the presets at
//   model_channels 96-512): the wide body
//   (flash_bwd_wide_kernel, after the template), designed for this card
//   as flash_attn.cu's wide forward is. A CTA holds 128 resident rows and
//   up to 256 columns of dQ (4 m64n64 sums a thread, 128 registers), so up
//   to hd 256 it builds S and dP once per ring tile for all of them: 3nc
//   64-column products of the 3nc the function has (the first wide body,
//   one CTA per 64-column slice: nc (2nc + 1)). dK and dV at 256 columns
//   would take 256 registers, so a dkv CTA holds 128 columns of each
//   where that covers the head dim (hd 128: 8 products, the function's
//   8), else 256 of one of them up to hd 256 (20 of the 16, the first
//   body 40) and, beyond, both warpgroups on the same 64 keys, one
//   holding dV, the other dK (the function's products). A producer
//   warpgroup gives its registers to the two consumer warpgroups
//   (setmaxnreg). Bounds at hd 256, T = 7125, 4 heads, f32
//   (three passes of 6 and 8 * T*T*256*4 flops at the bf16 rate): dq
//   0.946, dkv 1.261 ms.
#include <type_traits>

#include "hopper.cuh"

// the f32 backward at head dim 8 (flash_narrow_bwd.cu)
extern "C" int flash_narrow_bwd_launch(int dkv, const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* D,
                                       void* out0, void* out1, void* split,
                                       int BH, int T, float scale_log2,
                                       float scale2, int drop_lo,
                                       void* stream);

namespace {

using namespace ipdm::hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;                    // resident rows per warpgroup
constexpr int NWG = 2;                    // warpgroups per CTA
constexpr int BR = BM * NWG;              // resident rows per CTA
constexpr int BN = 64;                    // rows per ring tile
constexpr int NTHREADS = NWG * 128;
template <int HD>
constexpr int TILE = BN * Head<HD>::HDP;  // elements of a 64-row bf16
                                          // tile
constexpr float LOG2E = 1.4426950408889634f;
// from IPDM_FLASH_BWD_WIDE_FROM up: the wide body (the template's
// instance there is not built)
template <bool F32, int HD>
constexpr bool WIDE = HD >= IPDM_FLASH_BWD_WIDE_FROM;
// f32 at HD = 8: flash_narrow_bwd.cu's body (the template's instance at
// head dim 8 is not built in f32)
template <bool F32, int HD>
constexpr bool NARROW = F32 && HD == 8;
// f32 at HD = 16, 32, 64: f32 rows staged by TMA, split in the CTA
template <bool F32, int HD>
constexpr bool STAGED = F32 && !NARROW<F32, HD>;

// the value of x that the products see: x in bf16; hi + lo of its split
// in f32 (exact in f32)
__device__ __forceinline__ float seen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float seen(float x) {
  const float hi = ipdm::round_bf16(x);
  return hi + ipdm::round_bf16(x - hi);
}

// D[r] = sum_d o[r][d] * seen(do[r][d]) over the hd columns of a row
// (any head dim: an instance's, or a padded width of the wide body), one
// warp per row, two columns a lane per 64 (lanes past hd / 2 add 0)
template <typename E>
__global__ void __launch_bounds__(256)
    flash_bwd_dot_kernel(const E* __restrict__ o, const E* __restrict__ dout,
                         float* __restrict__ D, int rows, int hd) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t row = (size_t)r * hd;
  float acc = 0.f;
  for (int c = 2 * lane; c < hd; c += 64)
    acc += ipdm::to_f32(o[row + c]) * seen(dout[row + c]) +
           ipdm::to_f32(o[row + c + 1]) * seen(dout[row + c + 1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[r] = acc;
}

// Shared memory. bf16: the resident tiles and a 4-slot TMA ring of U, W.
// f32: hi and lo tiles of the resident rows, a 2-slot TMA staging ring of
// f32 U, W (HD columns), and a double buffer of their split tiles. Every
// bf16 tile is 1024-byte aligned (swizzle atoms), every staging tile
// 128-byte aligned (TMA).
template <bool F32, int HD>
struct Smem;
template <int HD>
struct Smem<false, HD> {
  static constexpr int STAGES = 4;
  bf16 res[NWG][2][1][TILE<HD>];      // [warpgroup][X, Y][part]
  bf16 ring[STAGES][2][1][TILE<HD>];  // [slot][U, W][part]
  float lse[STAGES][BN], Dc[STAGES][BN];  // the slot's rows (dkv)
  uint64_t resbar, full[STAGES];
  int released[STAGES];  // warps done with the slot's tile
};
template <int HD>
struct Smem<true, HD> {
  static constexpr int STAGES = 2;
  bf16 res[NWG][2][2][TILE<HD>];      // [warpgroup][X, Y][hi, lo]
  bf16 ring[2][2][2][TILE<HD>];       // [buffer][U, W][hi, lo]
  float stage[STAGES][2][BN * HD];    // [slot][U, W], f32 rows as loaded
  float lse[STAGES][BN], Dc[STAGES][BN];  // the slot's rows (dkv)
  uint64_t resbar, full[STAGES];
  int released[STAGES];
};

// 4 bytes global -> shared, asynchronous; bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// four consecutive f32 of row r, columns 4 c4 .. 4 c4 + 3, split into the
// hi and lo tiles at their swizzled place, as TMA lays a bf16 tile of
// Head<HD>'s rows out (at HD = 64: 16-byte chunk c4 / 2 of the row XOR
// r % 8, SWIZZLE_128B)
template <int HD>
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int r,
                                            int c4, float4 v) {
  constexpr int ROW = Head<HD>::ROW;
  const int off = swizzle<ROW>(r * ROW + 8 * c4);
  uint2 h, l;
  split2(v.x, v.y, h.x, l.x);
  split2(v.z, v.w, h.y, l.y);
  *reinterpret_cast<uint2*>(reinterpret_cast<char*>(hi) + off) = h;
  *reinterpret_cast<uint2*>(reinterpret_cast<char*>(lo) + off) = l;
}

// P or dS (f32 accumulator layout) to register-A fragments: rounded to
// bf16 (NP = 1), or split into hi (a[0]) and lo (a[1]) (NP = 2)
template <int NP>
__device__ __forceinline__ void to_a(uint32_t (&a)[NP][16],
                                     const float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if constexpr (NP == 1)
      a[0][i] = pack_bf16(d[2 * i], d[2 * i + 1]);
    else
      split2(d[2 * i], d[2 * i + 1], a[0][i], a[1][i]);
  }
}

// the tensor maps of X, Y, U and W: [hi, lo] of the split scratch in the
// wide f32 body, part 0 alone otherwise (bf16 maps; f32 maps of the f32
// rows in f32)
struct Maps {
  CUtensorMap x[2], y[2], u[2], w[2];
};

// A warp's loads, all 32 lanes: ring tile j into slot j % STAGES once the
// slot is free (lane 0: TMA; in dkv every lane also copies two of the
// tile's rows' lse and D with cp.async, rows past T zero-filled, and has
// the slot's full barrier track them: nothing here waits on the loads)
template <bool DKV, bool F32, int HD>
__device__ __forceinline__ void issue(Smem<F32, HD>& sm, int j,
                                      const Maps& maps,
                                      const float* lse, const float* D,
                                      int bh, int T) {
  constexpr int NP = F32 ? 2 : 1;
  // f32 rows of HD columns, or NP bf16 tiles, of U and W
  constexpr uint32_t BYTES =
      2 * (STAGED<F32, HD> ? BN * HD * 4 : NP * TILE<HD> * 2);
  const int s = j % Smem<F32, HD>::STAGES, lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_expect_tx(&sm.full[s], BYTES);
    if constexpr (STAGED<F32, HD>) {
      tma_load(sm.stage[s][0], &maps.u[0], &sm.full[s], j * BN, bh);
      tma_load(sm.stage[s][1], &maps.w[0], &sm.full[s], j * BN, bh);
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_tile<HD>(sm.ring[s][0][p], &maps.u[p], &sm.full[s], j * BN, bh);
        tma_tile<HD>(sm.ring[s][1][p], &maps.w[p], &sm.full[s], j * BN, bh);
      }
    }
  }
  if constexpr (DKV) {
    for (int i = lane; i < BN; i += 32) {
      const int row = j * BN + i;
      const size_t at = (size_t)bh * T + min(row, T - 1);
      const int bytes = row < T ? 4 : 0;
      cp_async4(&sm.lse[s][i], lse + at, bytes);
      cp_async4(&sm.Dc[s][i], D + at, bytes);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     smem_u32(&sm.full[s]))
                 : "memory");
  }
}

// One warpgroup: 64 resident rows against every ring tile.
// The sums of dq, dk and dv are m64nHDP: HDP / 2 a thread, columns
// 8n + c2 + {0, 1} for n < HDP / 8.
template <bool DKV, bool F32, int HD, typename E>
__device__ __forceinline__ void consume(
    Smem<F32, HD>& sm, int wg, const Maps& maps,
    const E* __restrict__ x, const E* __restrict__ y,
    const float* __restrict__ lse, const float* __restrict__ D,
    E* __restrict__ out0, E* __restrict__ out1, int T, float scale_log2,
    float scale2, int bh, int r0, int nt) {
  constexpr int STAGES = Smem<F32, HD>::STAGES;
  constexpr int NP = F32 ? 2 : 1;
  constexpr int HDP = Head<HD>::HDP, NO = HDP / 2;
  // f32 below head dim 64: each ring tile's dQ (dK, dV) products summed
  // from zero, then added to the sums in f32. The tensor cores' f32 sums
  // do not round to nearest, and chained onto dQ over all 1782 key tiles
  // at T = 114 000 they biased it to 1.2x the f32 rule (flash_attn.cu's
  // P V has the same fix). Head dim 64 (T <= 7125 on every path, 112
  // tiles, within the rule) keeps the chain, its bits and its registers.
  constexpr bool TILE_SUM = F32 && HD < 64;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  const int row0 = r0 + wg * BM + warp * 16 + lane / 4, row1 = row0 + 8;
  const size_t base = (size_t)bh * T * HD;

  if constexpr (STAGED<F32, HD>) {  // this warpgroup's resident rows,
                                   // split (the pad columns past HD zeros)
    const int t = threadIdx.x % 128;
    for (int i = t; i < BM * (HDP / 4); i += 128) {
      const int r = i / (HDP / 4), c4 = i % (HDP / 4);
      const int row = r0 + wg * BM + r;
      float4 vx = make_float4(0.f, 0.f, 0.f, 0.f), vy = vx;
      if (row < T && c4 < HD / 4) {
        vx = *reinterpret_cast<const float4*>(x + base + (size_t)row * HD +
                                              4 * c4);
        vy = *reinterpret_cast<const float4*>(y + base + (size_t)row * HD +
                                              4 * c4);
      }
      store_split<HD>(sm.res[wg][0][0], sm.res[wg][0][1], r, c4, vx);
      store_split<HD>(sm.res[wg][1][0], sm.res[wg][1][1], r, c4, vy);
    }
    fence_async_smem();
    bar_sync(2 + wg, 128);
  } else {
    mbar_wait(&sm.resbar, 0);
  }
  const uint64_t xH = sw_desc<HD>(sm.res[wg][0][0]);
  const uint64_t yH = sw_desc<HD>(sm.res[wg][1][0]);
  const uint64_t xL = sw_desc<HD>(sm.res[wg][0][F32 ? 1 : 0]);
  const uint64_t yL = sw_desc<HD>(sm.res[wg][1][F32 ? 1 : 0]);

  // dq: the rows' log2-domain normaliser and D (rows past T: P = 0)
  float lr[2] = {INFINITY, INFINITY}, dr[2] = {0.f, 0.f};
  if constexpr (!DKV) {
    if (row0 < T) {
      lr[0] = lse[(size_t)bh * T + row0] * LOG2E;
      dr[0] = D[(size_t)bh * T + row0];
    }
    if (row1 < T) {
      lr[1] = lse[(size_t)bh * T + row1] * LOG2E;
      dr[1] = D[(size_t)bh * T + row1];
    }
  }

  float acc0[NO], acc1[NO];  // dq; or dk, dv
#pragma unroll
  for (int i = 0; i < NO; ++i) acc0[i] = acc1[i] = 0.f;

  for (int j = 0; j < nt; ++j) {
    const int s = j % STAGES;
    mbar_wait(&sm.full[s], (j / STAGES) & 1);
    bf16 *uh, *ul, *wh, *wl;
    if constexpr (STAGED<F32, HD>) {  // split the staged f32 tile; both
                                     // warpgroups
      const int b = j & 1;
      for (int i = threadIdx.x; i < BN * (HDP / 4); i += NTHREADS) {
        const int r = i / (HDP / 4), c4 = i % (HDP / 4);
        float4 vu = make_float4(0.f, 0.f, 0.f, 0.f), vw = vu;
        if (c4 < HD / 4) {  // the pad columns past HD stay zeros
          vu = *reinterpret_cast<const float4*>(
              &sm.stage[s][0][r * HD + 4 * c4]);
          vw = *reinterpret_cast<const float4*>(
              &sm.stage[s][1][r * HD + 4 * c4]);
        }
        store_split<HD>(sm.ring[b][0][0], sm.ring[b][0][1], r, c4, vu);
        store_split<HD>(sm.ring[b][1][0], sm.ring[b][1][1], r, c4, vw);
      }
      fence_async_smem();
      bar_sync(1, NTHREADS);
      uh = sm.ring[b][0][0];
      ul = sm.ring[b][0][1];
      wh = sm.ring[b][1][0];
      wl = sm.ring[b][1][1];
    } else {
      uh = sm.ring[s][0][0];
      ul = sm.ring[s][0][NP - 1];
      wh = sm.ring[s][1][0];
      wl = sm.ring[s][1][NP - 1];
    }
    const uint64_t uH = sw_desc<HD>(uh), uL = sw_desc<HD>(ul);
    const uint64_t wH = sw_desc<HD>(wh), wL = sw_desc<HD>(wl);

    // S = X U^T, dP = Y W^T
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    reg_fence(sc);
    reg_fence(dp);
    wg_fence();
    product_ss<F32, HD>(sc, xH, xL, uH, uL);
    product_ss<F32, HD>(dp, yH, yL, wH, wL);
    wg_commit();
    reg_fence(sc);
    reg_fence(dp);
    wg_wait_all();
    reg_fence(sc);
    reg_fence(dp);

    // P into sc, dS into dp
    const int live = T - j * BN;  // ring rows < T in this tile
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + c2 + (i & 1);
      float l2, dd;
      if constexpr (DKV) {
        l2 = sm.lse[s][col] * LOG2E;
        dd = sm.Dc[s][col];
      } else {
        l2 = lr[(i >> 1) & 1];
        dd = dr[(i >> 1) & 1];
      }
      float p = fast_exp2(fmaf(sc[i], scale_log2, -l2));
      if (col >= live) p = 0.f;  // keys (dq) or queries (dkv) >= T
      sc[i] = p;
      dp[i] = p * (dp[i] - dd);
    }
    uint32_t da[NP][16];
    to_a(da, dp);
    if constexpr (DKV && TILE_SUM) {  // dV += P^T dO, dK += dS^T Q, each
                                      // tile's products summed from zero
      uint32_t pa[NP][16];
      to_a(pa, sc);
      float t0[NO], t1[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) t0[i] = t1[i] = 0.f;
      reg_fence(t0);
      reg_fence(t1);
      reg_fence_a(pa);
      reg_fence_a(da);
      wg_fence();
      product_rs<NP, HD>(t1, pa, wH, wL);
      product_rs<NP, HD>(t0, da, uH, uL);
      wg_commit();
      reg_fence(t0);
      reg_fence(t1);
      wg_wait_all();
      reg_fence(t0);
      reg_fence(t1);
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        acc0[i] += t0[i];
        acc1[i] += t1[i];
      }
    } else if constexpr (DKV) {  // dV += P^T dO, dK += dS^T Q
      uint32_t pa[NP][16];
      to_a(pa, sc);
      reg_fence(acc0);
      reg_fence(acc1);
      reg_fence_a(pa);
      reg_fence_a(da);
      wg_fence();
      product_rs<NP, HD>(acc1, pa, wH, wL);
      product_rs<NP, HD>(acc0, da, uH, uL);
      wg_commit();
      reg_fence(acc0);
      reg_fence(acc1);
      wg_wait_all();
      reg_fence(acc0);
      reg_fence(acc1);
    } else if constexpr (TILE_SUM) {  // dQ += dS K, summed from zero
      float t0[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) t0[i] = 0.f;
      reg_fence(t0);
      reg_fence_a(da);
      wg_fence();
      product_rs<NP, HD>(t0, da, uH, uL);
      wg_commit();
      reg_fence(t0);
      wg_wait_all();
      reg_fence(t0);
#pragma unroll
      for (int i = 0; i < NO; ++i) acc0[i] += t0[i];
    } else {  // dQ += dS K
      reg_fence(acc0);
      reg_fence_a(da);
      wg_fence();
      product_rs<NP, HD>(acc0, da, uH, uL);
      wg_commit();
      reg_fence(acc0);
      wg_wait_all();
      reg_fence(acc0);
    }
    // this warp is done with slot s; the last of the 8 refills it
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&sm.released[s], 1) == NWG * 4 - 1;
      if (last) sm.released[s] = 0;
      __threadfence_block();
    }
    if (__shfl_sync(0xffffffffu, last, 0) && j + STAGES < nt)
      issue<DKV, F32, HD>(sm, j + STAGES, maps, lse, D, bh, T);
  }

  // rows < T: dq = c acc0; or dk = c acc0, dv = acc1 (columns < HD)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (row >= T) continue;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int i = 4 * n + 2 * h;
      const size_t at = base + (size_t)row * HD + 8 * n + c2;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(out0 + at) =
            make_float2(acc0[i] * scale2, acc0[i + 1] * scale2);
        if constexpr (DKV)
          *reinterpret_cast<float2*>(out1 + at) =
              make_float2(acc1[i], acc1[i + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(out0 + at) =
            pack_bf16(acc0[i] * scale2, acc0[i + 1] * scale2);
        if constexpr (DKV)
          *reinterpret_cast<uint32_t*>(out1 + at) =
              pack_bf16(acc1[i], acc1[i + 1]);
      }
    }
  }
}

template <bool F32>
using Elem = std::conditional_t<F32, float, bf16>;

template <bool DKV, bool F32, int HD>
__global__ void __launch_bounds__(NTHREADS, (DKV || F32) ? 1 : 2)
    flash_bwd_kernel(const __grid_constant__ Maps maps,
                     const Elem<F32>* __restrict__ x,
                     const Elem<F32>* __restrict__ y,
                     const float* __restrict__ lse,
                     const float* __restrict__ D, Elem<F32>* __restrict__ out0,
                     Elem<F32>* __restrict__ out1, int T, float scale_log2,
                     float scale2) {
  static_assert(HD <= 64, "the template's instances stop at head dim 64");
  extern __shared__ unsigned char smem_raw[];
  using S = Smem<F32, HD>;
  S& sm = *reinterpret_cast<S*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SW_ATOM - 1) &
      ~uintptr_t(SW_ATOM - 1));
  const int bh = blockIdx.y, r0 = blockIdx.x * BR;
  const int nt = (T + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.resbar, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&sm.full[s], DKV ? 1 + 32 : 1);
      sm.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // warp 0: the resident tiles (bf16), the
                           // first STAGES ring tiles
    if constexpr (!STAGED<F32, HD>) {
      constexpr int NP = F32 ? 2 : 1;
      if (threadIdx.x == 0) {
        mbar_expect_tx(&sm.resbar, NWG * 2 * NP * TILE<HD> * 2);
        for (int w = 0; w < NWG; ++w)
          for (int p = 0; p < NP; ++p) {
            tma_tile<HD>(sm.res[w][0][p], &maps.x[p], &sm.resbar,
                         r0 + w * BM, bh);
            tma_tile<HD>(sm.res[w][1][p], &maps.y[p], &sm.resbar,
                         r0 + w * BM, bh);
          }
      }
    }
    for (int j = 0; j < S::STAGES && j < nt; ++j)
      issue<DKV, F32, HD>(sm, j, maps, lse, D, bh, T);
  }
  consume<DKV, F32, HD>(sm, threadIdx.x / 128, maps, x, y, lse, D, out0,
                        out1, T, scale_log2, scale2, bh, r0, nt);
}

// X, Y resident and U, W walked: (q, do, k, v) for dq, (k, v, q, do) for
// dkv
template <bool DKV, bool F32, int HD>
int launch(const void* x, const void* y, const void* u, const void* w,
           const void* lse, const void* D, void* out0, void* out1, int BH,
           int T, float scale_log2, float scale2, cudaStream_t st) {
  using E = Elem<F32>;
  constexpr int SMEM_BYTES = (int)sizeof(Smem<F32, HD>) + SW_ATOM;
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kernel<DKV, F32, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  Maps maps{};
  const auto map = F32 ? make_map_f32<HD> : make_map<HD>;
  if (!(map(&maps.x[0], x, BH, T) && map(&maps.y[0], y, BH, T) &&
        map(&maps.u[0], u, BH, T) && map(&maps.w[0], w, BH, T)))
    return (int)cudaErrorInvalidValue;
  dim3 grid((T + BR - 1) / BR, BH);
  flash_bwd_kernel<DKV, F32, HD><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      maps, static_cast<const E*>(x), static_cast<const E*>(y),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<E*>(out0), static_cast<E*>(out1), T, scale_log2, scale2);
  return (int)cudaGetLastError();
}

// The wide body: every head dim from IPDM_FLASH_BWD_WIDE_FROM (128) up as
// hdw = WIDE_CHUNK * nc columns, nc a runtime count of 64-column chunks
// (the wrapper zero-pads the head dim to a multiple of 64). Two consumer
// warpgroups of 64 resident rows each (X, Y: q, dO in dq; k, v in dkv)
// and a producer warpgroup. Per 64-row ring tile j (U, W: k, v in dq;
// q, dO in dkv) a consumer builds S = X U^T and dP = Y W^T chunk by chunk
// over the whole head dim, then P, dS and the products into the chunks
// of the outputs its CTA holds, slice z = blockIdx.z from chunk c0
// (WbMode):
// - WB_DQ: 128 rows, WB_DQ_SLICE chunks of dQ (4: 256 columns, 128 f32
//   registers a thread): dQ_h += dS U_h. Up to hd 256 S and dP are built
//   once per ring tile for every column: 3nc products of 64 columns, the
//   function's 3nc (the first wide body, one CTA per 64-column slice:
//   nc (2nc + 1)).
// - WB_PAIR (dkv where WB_DKV_SLICE chunks cover the head dim: hd 128):
//   128 rows, 2 chunks of dK and of dV (dK_h += dS^T U_h, dV_h += P^T
//   W_h): 8 products of the function's 8.
// - Above (dK and dV at 256 columns would take 256 registers), while X
//   and Y (f32: their hi halves) stay resident in 128 rows (hd 256):
//   WB_BYOUT, CTAs of 128 rows and WB_DQ_SLICE chunks of dV alone (even
//   z; S alone) or of dK alone (odd z): hd 256 20 products of the 16.
// - Beyond: WB_SHARE, CTAs of 64 keys whose warpgroup 0 builds S and
//   holds dV, warpgroup 1 dP and dK, P handed from the first to the
//   second through shared memory: the function's 4nc products a slice,
//   X and Y (f32: hi) resident for the 64 keys up to hd 512. It is
//   slower than WB_BYOUT up to hd 256 (64 keys share each ring tile, and
//   each warpgroup waits on its own products step by step) and faster
//   where WB_BYOUT's 128 rows would stream X and Y (PERF.md §6).
// The sums take ~210 registers with S, dP and the split dS, so the
// producer gives its registers back (setmaxnreg: WB_PREGS, the consumers
// WB_CREGS), and the consumers' branch comes first in the kernel (ptxas
// kept them at the launch's registers and spilled otherwise;
// flash_attn.cu flash_wide_kernel).
// Shared memory: X's and Y's chunks of the CTA's rows stay resident where
// they fit in 128 KB (RES 2: f32 hi and lo, bf16 up to 8 chunks of 64
// rows); f32 beyond keeps their hi halves resident and streams the lo
// halves (RES 1), once per ring tile; above, both stream (RES 0). One TMA
// ring of 64 x 64 chunk slots (hi and lo in f32: 16 KB; bf16 8 KB; as
// many as the rest of the 227 KB holds) carries, per ring tile, 2nc S
// steps (U's chunk c, then W's; each after the slots of X's or Y's chunk c
// that stream: RES 1 one slot of the CTA's lo tiles, RES 0 one slot per
// 64 rows of hi and lo) and the slice's output steps (U's chunk c0 + h;
// dkv W's), so the producer loads ahead across steps and tiles while the
// products run. dkv's ring tiles bring their rows' lse and D (cp.async)
// through a 2-slot ring. A step's slots are released once the next
// step's products are issued and its own have completed (the output
// steps' at the tile's end; in WB_SHARE, where each warpgroup owns every
// other step, as soon as its own have completed, and at once by the
// other). f32 takes hi and lo tiles from the split pre-pass and runs
// three bf16 passes a product, the sums chained over the ring tiles as
// the template's are from head dim 64.
#ifndef IPDM_WBWD_DQ_SLICE
#define IPDM_WBWD_DQ_SLICE 4   // 64-column chunks of dQ a CTA holds
#endif
#ifndef IPDM_WBWD_DKV_SLICE
#define IPDM_WBWD_DKV_SLICE 2  // chunks of dK, and of dV, a paired CTA
#endif                         // holds
#ifndef IPDM_WBWD_CREGS
#define IPDM_WBWD_CREGS 240    // the consumers' registers a thread
#endif
constexpr int WB_DQ_SLICE = IPDM_WBWD_DQ_SLICE;
constexpr int WB_DKV_SLICE = IPDM_WBWD_DKV_SLICE;
constexpr int WB_THREADS = 128 * (NWG + 1);  // + the producer warpgroup
// registers a thread at launch (__launch_bounds__(WB_THREADS, 1)), the
// consumers' after setmaxnreg.inc, the producer's after .dec
constexpr int WB_LREGS = 65536 / WB_THREADS / 8 * 8;
constexpr int WB_CREGS = IPDM_WBWD_CREGS;
constexpr int WB_PREGS = (WB_LREGS - (WB_CREGS - WB_LREGS) * NWG) / 8 * 8;
static_assert(WB_DQ_SLICE >= 1 && WB_DQ_SLICE <= 4 && WB_DKV_SLICE >= 1 &&
                  WB_DKV_SLICE <= 2,
              "wide backward: 1-4 chunks of dQ (and of one of dK and dV), "
              "1-2 of both");
static_assert(WB_PREGS >= 24 && WB_CREGS % 8 == 0 && WB_CREGS <= 256 &&
                  WB_CREGS >= WB_LREGS,
              "wide backward: the register split does not fit the SM");
// how a CTA splits the outputs (see above)
enum WbMode { WB_DQ, WB_PAIR, WB_BYOUT, WB_SHARE };
// the chunks of each of its outputs a CTA (WB_SHARE: a warpgroup) holds
template <int MODE>
constexpr int WB_SL = MODE == WB_PAIR ? WB_DKV_SLICE : WB_DQ_SLICE;
// 64-row blocks of resident rows a CTA holds: one a warpgroup, or one
// for both (WB_SHARE)
template <int MODE>
constexpr int WB_RB = MODE == WB_SHARE ? 1 : NWG;
constexpr int WB_LST = 2;          // slots of the ring tiles' lse and D
constexpr int WB_SMEM = 232448;    // a CTA's shared memory
constexpr int WB_TB = TILE<64> * 2;  // bytes of a 64 x 64 bf16 tile

// Shared memory at residency RES (2: X and Y; 1: their hi halves; 0:
// none) for RB 64-row blocks of resident rows: XCH resident chunks of X
// and Y, NPR tiles a chunk (hi, lo), the ring of TST chunk slots that
// fills the rest (3 KB kept for the alignment pad, lse and D and the
// barriers) and, at RB = 1 (WB_SHARE), P of a ring tile, 32 f32 a
// consumer thread
template <bool F32, int RES, int RB>
struct WbSmem {
  static constexpr int NP = F32 ? 2 : 1;              // [hi, lo]
  static constexpr int NPR = RES == 2 ? NP : 1;       // resident tiles
  static constexpr int XCH = RES == 0 ? 1 : 8 / (RB * NPR);
  static constexpr int XT = RES == 0 ? 8 : TILE<64>;  // (none at RES 0)
  static constexpr int RES_BYTES = 2 * XCH * RB * NPR * XT * 2;
  static constexpr int PX = RB == 1 ? 32 * 128 : 1;   // P's floats
  static constexpr int TST =
      (WB_SMEM - RES_BYTES - (RB == 1 ? PX * 4 : 0) - 3072) / (NP * WB_TB);
  // slots of an S step: the streamed rows' (RES 1: the RB blocks' lo in
  // one slot; RES 0: a slot a block), then U's or W's chunk
  static constexpr int SSTEP = RES == 2 ? 1 : RES == 1 ? 2 : 1 + RB;
  bf16 ring[TST][NP][TILE<64>];  // first: 1024-byte aligned tiles
  bf16 x[XCH][RB][NPR][XT], y[XCH][RB][NPR][XT];
  float pex[PX];  // [e][thread] (WB_SHARE)
  float lse[WB_LST][BN], Dc[WB_LST][BN];
  uint64_t xbar, full[TST], empty[TST], lfull[WB_LST], lempty[WB_LST];
  uint64_t pfull, pempty;  // P written, P read (WB_SHARE)
};
template <bool F32, int RES, int MODE>
using WbSmemOf = WbSmem<F32, RES, WB_RB<MODE>>;

// the next slot (s) of a ring of N and the parity (ph) of its next phase
template <int N>
__device__ __forceinline__ void wb_advance(int& s, uint32_t& ph) {
  if (++s == N) {
    s = 0;
    ph ^= 1;
  }
}

// this warp is done with a slot
__device__ __forceinline__ void wb_release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty);
}

// The producer, one warp: the resident X and Y (RES > 0) once, then per
// ring tile j its lse and D (dkv: every lane copies two rows with
// cp.async), the 2nc S steps (the streamed rows of X's or Y's chunk c,
// then U's or W's chunk c; a CTA of dV alone S's alone) and the slice's
// output steps (U's chunk c0 + h, or W's for dV alone; a pair then W's;
// WB_SHARE W's nz chunks, then U's), a slot a chunk
template <int MODE, bool F32, int RES>
__device__ __forceinline__ void wb_produce(WbSmemOf<F32, RES, MODE>& sm,
                                           const Maps& maps,
                                           const float* lse, const float* D,
                                           int bh, int T, int nc, int c0,
                                           int nz, int r0, int nt, bool dv) {
  using S = WbSmemOf<F32, RES, MODE>;
  constexpr int NP = S::NP, NPR = S::NPR, TST = S::TST;
  constexpr int RB = WB_RB<MODE>;
  const int lane = threadIdx.x % 32;
  if constexpr (RES > 0) {  // X's and Y's hi (and lo at RES 2) chunks
    if (lane == 0) {
      mbar_expect_tx(&sm.xbar, 2 * nc * RB * NPR * WB_TB);
      for (int c = 0; c < nc; ++c)
        for (int w = 0; w < RB; ++w)
          for (int p = 0; p < NPR; ++p) {
            tma_load(sm.x[c][w][p], &maps.x[p], &sm.xbar, r0 + w * BM, bh,
                     c * WIDE_CHUNK);
            tma_load(sm.y[c][w][p], &maps.y[p], &sm.xbar, r0 + w * BM, bh,
                     c * WIDE_CHUNK);
          }
    }
  }
  int ts = 0, ls = 0;
  uint32_t tph = 1, lph = 1;  // a fresh barrier's previous phase counts as
                              // complete
  // the next slot: ``n`` 64 x 64 tiles of ``map`` (parts p0 .. p0 + n - 1)
  // at rows ``row``, column chunk c, into its tiles 0 .. n - 1
  auto slot = [&](const CUtensorMap* map, int p0, int n, int row, int c) {
    mbar_wait(&sm.empty[ts], tph);
    if (lane == 0) {
      mbar_expect_tx(&sm.full[ts], n * WB_TB);
      for (int p = 0; p < n; ++p)
        tma_load(sm.ring[ts][p], map + p0 + p, &sm.full[ts], row, bh,
                 c * WIDE_CHUNK);
    }
    wb_advance<TST>(ts, tph);
  };
  for (int j = 0; j < nt; ++j) {
    if constexpr (MODE != WB_DQ) {
      mbar_wait(&sm.lempty[ls], lph);
      for (int r = lane; r < BN; r += 32) {
        const int row = j * BN + r;
        const size_t at = (size_t)bh * T + min(row, T - 1);
        const int bytes = row < T ? 4 : 0;
        cp_async4(&sm.lse[ls][r], lse + at, bytes);
        cp_async4(&sm.Dc[ls][r], D + at, bytes);
      }
      asm volatile(
          "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
              smem_u32(&sm.lfull[ls]))
          : "memory");
      wb_advance<WB_LST>(ls, lph);
    }
    for (int c = 0; c < nc; ++c)
      for (int t = 0; t < (dv ? 1 : 2); ++t) {
        const CUtensorMap* xy = t ? maps.y : maps.x;
        if constexpr (RES == 1) {  // the blocks' lo of the chunk
          mbar_wait(&sm.empty[ts], tph);
          if (lane == 0) {
            mbar_expect_tx(&sm.full[ts], RB * WB_TB);
            for (int w = 0; w < RB; ++w)
              tma_load(sm.ring[ts][w], xy + 1, &sm.full[ts], r0 + w * BM,
                       bh, c * WIDE_CHUNK);
          }
          wb_advance<TST>(ts, tph);
        } else if constexpr (RES == 0) {  // a slot a block
          for (int w = 0; w < RB; ++w) slot(xy, 0, NP, r0 + w * BM, c);
        }
        slot(t ? maps.w : maps.u, 0, NP, j * BN, c);
      }
    if constexpr (MODE == WB_SHARE) {
      for (int h = 0; h < nz; ++h) slot(maps.w, 0, NP, j * BN, c0 + h);
      for (int h = 0; h < nz; ++h) slot(maps.u, 0, NP, j * BN, c0 + h);
    } else {
      for (int h = 0; h < nz; ++h) {
        slot(dv ? maps.w : maps.u, 0, NP, j * BN, c0 + h);
        if constexpr (MODE == WB_PAIR) slot(maps.w, 0, NP, j * BN, c0 + h);
      }
    }
  }
}

// One consumer warpgroup: its 64 resident rows against every ring tile;
// the sums of the slice's nz chunks (dQ; dK and dV; or, ``dv``, dV alone,
// else dK alone) from column chunk c0
template <int MODE, bool F32, int RES>
__device__ __forceinline__ void wb_consume(
    WbSmemOf<F32, RES, MODE>& sm, int wg, const float* __restrict__ lse,
    const float* __restrict__ D, Elem<F32>* __restrict__ out0,
    Elem<F32>* __restrict__ out1, int T, int nc, int c0, int nz,
    float scale_log2, float scale2, int bh, int r0, int nt, bool dv) {
  using S = WbSmemOf<F32, RES, MODE>;
  constexpr int NP = S::NP, TST = S::TST, SSTEP = S::SSTEP;
  constexpr int SL = WB_SL<MODE>;
  constexpr bool DKV = MODE != WB_DQ;
  constexpr bool PAIR = MODE == WB_PAIR;  // dK and dV in one CTA
  constexpr bool SHARE = MODE == WB_SHARE;
  constexpr int NOUT = PAIR ? 2 : 1;  // output steps a chunk of the slice
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int tid = threadIdx.x % 128;
  const int c2 = (lane % 4) * 2;
  const int blk = WB_RB<MODE> == 1 ? 0 : wg;  // its block of resident rows
  const int row0 = r0 + blk * BM + warp * 16 + lane / 4, row1 = row0 + 8;

  // dq: the rows' log2-domain normaliser and D (rows past T: P = 0)
  float lr[2] = {INFINITY, INFINITY}, dr[2] = {0.f, 0.f};
  if constexpr (!DKV) {
    if (row0 < T) {
      lr[0] = lse[(size_t)bh * T + row0] * LOG2E;
      dr[0] = D[(size_t)bh * T + row0];
    }
    if (row1 < T) {
      lr[1] = lse[(size_t)bh * T + row1] * LOG2E;
      dr[1] = D[(size_t)bh * T + row1];
    }
  }

  float acc0[SL][32], acc1[PAIR ? SL : 1][32];  // dQ (dK, dV); or dK, dV
#pragma unroll
  for (int h = 0; h < SL; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc0[h][e] = 0.f;
#pragma unroll
  for (int h = 0; h < (PAIR ? SL : 1); ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc1[h][e] = 0.f;

  if constexpr (RES > 0) mbar_wait(&sm.xbar, 0);
  int ts = 0, ls = 0;
  uint32_t tph = 0, lph = 0;
  for (int j = 0; j < nt; ++j) {
    // S = X U^T (t = 0) and dP = Y W^T (t = 1), summed over the nc chunks;
    // a step's slots are released once the next step's products are
    // issued and its own have completed (WB_SHARE: once its own have
    // completed; the other warpgroup's steps at once)
    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    reg_fence(sc);
    reg_fence(dp);
    int prev = -1;  // the previous step's first slot
    for (int c = 0; c < nc; ++c) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (MODE == WB_BYOUT && t == 1 && dv) continue;  // dV alone: no dP
        const int s0 = ts;
#pragma unroll
        for (int i = 0; i < SSTEP; ++i) {
          mbar_wait(&sm.full[ts], tph);
          wb_advance<TST>(ts, tph);
        }
        if (SHARE && (t == 0) != dv) {  // the other warpgroup's step
#pragma unroll
          for (int i = 0; i < SSTEP; ++i)
            wb_release(&sm.empty[(s0 + i) % TST]);
          continue;
        }
        const int sb = s0 + SSTEP - 1 < TST ? s0 + SSTEP - 1
                                            : s0 + SSTEP - 1 - TST;
        uint64_t aH, aL;
        if constexpr (RES == 2) {
          const auto& xt = t ? sm.y[c][blk] : sm.x[c][blk];
          aH = sw_desc<64>(xt[0]);
          aL = sw_desc<64>(xt[NP - 1]);
        } else if constexpr (RES == 1) {  // hi resident, lo in slot s0
          aH = sw_desc<64>(t ? sm.y[c][blk][0] : sm.x[c][blk][0]);
          aL = sw_desc<64>(sm.ring[s0][blk]);
        } else {  // the block's slot
          const int sw = s0 + blk < TST ? s0 + blk : s0 + blk - TST;
          aH = sw_desc<64>(sm.ring[sw][0]);
          aL = sw_desc<64>(sm.ring[sw][NP - 1]);
        }
        const uint64_t bH = sw_desc<64>(sm.ring[sb][0]);
        const uint64_t bL = sw_desc<64>(sm.ring[sb][NP - 1]);
        wg_fence();
        if (t == 0)
          product_ss<F32, 64>(sc, aH, aL, bH, bL, c > 0);
        else
          product_ss<F32, 64>(dp, aH, aL, bH, bL, c > 0);
        wg_commit();
        reg_fence(sc);
        reg_fence(dp);
        if constexpr (SHARE) {
          wg_wait_all();
          reg_fence(sc);
          reg_fence(dp);
#pragma unroll
          for (int i = 0; i < SSTEP; ++i)
            wb_release(&sm.empty[(s0 + i) % TST]);
        } else {
          if (prev >= 0) {
            wg_wait<1>();
#pragma unroll
            for (int i = 0; i < SSTEP; ++i)
              wb_release(&sm.empty[(prev + i) % TST]);
          }
          prev = s0;
        }
      }
    }
    if constexpr (!SHARE) {
      wg_wait_all();
      reg_fence(sc);
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < SSTEP; ++i)
        wb_release(&sm.empty[(prev + i) % TST]);
    }

    // P into sc, dS into dp (WB_SHARE: warpgroup 0 P, handed to
    // warpgroup 1 for dS)
    if constexpr (DKV) mbar_wait(&sm.lfull[ls], lph);
    const int live = T - j * BN;  // ring rows < T in this tile
    if (SHARE && !dv) {
      mbar_wait(&sm.pfull, j & 1);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + c2 + (e & 1);
        dp[e] = sm.pex[SHARE ? e * 128 + tid : 0] *
                (dp[e] - sm.Dc[ls][col]);
      }
      mbar_arrive(&sm.pempty);
    } else {
      if (SHARE && j > 0) mbar_wait(&sm.pempty, (j - 1) & 1);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = 8 * (e / 4) + c2 + (e & 1);
        float l2, dd;
        if constexpr (DKV) {
          l2 = sm.lse[ls][col] * LOG2E;
          dd = sm.Dc[ls][col];
        } else {
          l2 = lr[(e >> 1) & 1];
          dd = dr[(e >> 1) & 1];
        }
        float p = fast_exp2(fmaf(sc[e], scale_log2, -l2));
        if (col >= live) p = 0.f;  // keys (dq) or queries (dkv) >= T
        sc[e] = p;
        dp[e] = p * (dp[e] - dd);
        if constexpr (SHARE) sm.pex[e * 128 + tid] = p;
      }
      if constexpr (SHARE) mbar_arrive(&sm.pfull);
    }
    if constexpr (DKV) {
      wb_release(&sm.lempty[ls]);
      wb_advance<WB_LST>(ls, lph);
    }
    uint32_t da[NP][16], pa[PAIR ? NP : 1][16];
    if (dv)
      to_a(da, sc);
    else
      to_a(da, dp);
    if constexpr (PAIR) to_a(pa, sc);

    // the slice's products: dQ_h += dS U_h; or dK_h += dS^T U_h and
    // dV_h += P^T W_h (one of them where a CTA or warpgroup holds one
    // output), every one in one group once their chunks are in; WB_SHARE
    // passes the other warpgroup's chunks (W's for dV first, then U's)
#pragma unroll
    for (int g = 0; g < (SHARE ? 2 : 1); ++g) {
      if (SHARE && (g == 0) != dv) {
        for (int h = 0; h < nz; ++h) {
          mbar_wait(&sm.full[ts], tph);
          wb_release(&sm.empty[ts]);
          wb_advance<TST>(ts, tph);
        }
        continue;
      }
      int s1 = ts;
      uint32_t p1 = tph;
#pragma unroll
      for (int h = 0; h < SL; ++h)
        if (h < nz)
#pragma unroll
          for (int t = 0; t < NOUT; ++t) {
            mbar_wait(&sm.full[s1], p1);
            wb_advance<TST>(s1, p1);
          }
#pragma unroll
      for (int h = 0; h < SL; ++h) {
        reg_fence(acc0[h]);
        if constexpr (PAIR) reg_fence(acc1[h]);
      }
      reg_fence_a(da);
      if constexpr (PAIR) reg_fence_a(pa);
      wg_fence();
      s1 = ts;
#pragma unroll
      for (int h = 0; h < SL; ++h) {
        if (h < nz) {
          product_rs<NP, 64>(acc0[h], da, sw_desc<64>(sm.ring[s1][0]),
                             sw_desc<64>(sm.ring[s1][NP - 1]));
          s1 = s1 + 1 == TST ? 0 : s1 + 1;
          if constexpr (PAIR) {
            product_rs<NP, 64>(acc1[h], pa, sw_desc<64>(sm.ring[s1][0]),
                               sw_desc<64>(sm.ring[s1][NP - 1]));
            s1 = s1 + 1 == TST ? 0 : s1 + 1;
          }
        }
      }
      wg_commit();
#pragma unroll
      for (int h = 0; h < SL; ++h) {
        reg_fence(acc0[h]);
        if constexpr (PAIR) reg_fence(acc1[h]);
      }
      wg_wait_all();
#pragma unroll
      for (int h = 0; h < SL; ++h) {
        reg_fence(acc0[h]);
        if constexpr (PAIR) reg_fence(acc1[h]);
      }
#pragma unroll
      for (int h = 0; h < SL; ++h)
        if (h < nz)
#pragma unroll
          for (int t = 0; t < NOUT; ++t) {
            wb_release(&sm.empty[ts]);
            wb_advance<TST>(ts, tph);
          }
    }
  }

  // rows < T: dq = c acc0; or dk = c acc0, dv = acc1 (the slice's
  // chunks); dV alone writes acc0 to dv
  const int hdw = nc * WIDE_CHUNK;
  const size_t base = (size_t)bh * T * hdw + c0 * WIDE_CHUNK;
  if (dv) {
    out0 = out1;
    scale2 = 1.f;
  }
#pragma unroll
  for (int h = 0; h < SL; ++h) {
    if (h >= nz) continue;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = hr ? row1 : row0;
      if (row >= T) continue;
#pragma unroll
      for (int n = 0; n < WIDE_CHUNK / 8; ++n) {
        const int e = 4 * n + 2 * hr;
        const size_t at =
            base + (size_t)row * hdw + h * WIDE_CHUNK + 8 * n + c2;
        if constexpr (F32) {
          *reinterpret_cast<float2*>(out0 + at) =
              make_float2(acc0[h][e] * scale2, acc0[h][e + 1] * scale2);
          if constexpr (PAIR)
            *reinterpret_cast<float2*>(out1 + at) =
                make_float2(acc1[h][e], acc1[h][e + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(out0 + at) =
              pack_bf16(acc0[h][e] * scale2, acc0[h][e + 1] * scale2);
          if constexpr (PAIR)
            *reinterpret_cast<uint32_t*>(out1 + at) =
                pack_bf16(acc1[h][e], acc1[h][e + 1]);
        }
      }
    }
  }
}

template <int MODE, bool F32, int RES>
__global__ void __launch_bounds__(WB_THREADS, 1)
    flash_bwd_wide_kernel(const __grid_constant__ Maps maps,
                          const float* __restrict__ lse,
                          const float* __restrict__ D,
                          Elem<F32>* __restrict__ out0,
                          Elem<F32>* __restrict__ out1, int T, int nc,
                          float scale_log2, float scale2) {
  using S = WbSmemOf<F32, RES, MODE>;
  constexpr int SL = WB_SL<MODE>;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SW_ATOM - 1) &
      ~uintptr_t(SW_ATOM - 1));
  const int bh = blockIdx.y, r0 = blockIdx.x * WB_RB<MODE> * BM;
  // a CTA of one output: slice z / 2, dV at even z, dK at odd
  const bool dv_cta = MODE == WB_BYOUT && blockIdx.z % 2 == 0;
  const int c0 = (MODE == WB_BYOUT ? blockIdx.z / 2 : blockIdx.z) * SL;
  const int nz = min(SL, nc - c0);  // the outputs' chunks in this slice
  const int nt = (T + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.xbar, 1);
    for (int s = 0; s < S::TST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NWG * 4);
    }
    for (int s = 0; s < WB_LST; ++s) {
      mbar_init(&sm.lfull[s], 32);  // the producer's lanes' cp.async
      mbar_init(&sm.lempty[s], NWG * 4);
    }
    mbar_init(&sm.pfull, 128);   // warpgroup 0's threads (WB_SHARE)
    mbar_init(&sm.pempty, 128);  // warpgroup 1's
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one branch a role to the end, on a warp-uniform role, the consumers'
  // first (flash_attn.cu flash_wide_kernel)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role < NWG) {
    regs_inc<WB_CREGS>();
    wb_consume<MODE, F32, RES>(sm, role, lse, D, out0, out1, T, nc, c0, nz,
                               scale_log2, scale2, bh, r0, nt,
                               MODE == WB_SHARE ? role == 0 : dv_cta);
  } else {  // the producer warpgroup: its first warp loads
    regs_dec<WB_PREGS>();
    if (threadIdx.x < NWG * 128 + 32)
      wb_produce<MODE, F32, RES>(sm, maps, lse, D, bh, T, nc, c0, nz, r0,
                                 nt, dv_cta);
  }
}

template <int MODE, bool F32, int RES>
int launch_wide_body(const Maps& maps, const void* lse, const void* D,
                     void* out0, void* out1, int BH, int T, int nc,
                     float scale_log2, float scale2, cudaStream_t st) {
  using S = WbSmemOf<F32, RES, MODE>;
  constexpr int SMEM_BYTES = (int)sizeof(S) + SW_ATOM;
  static_assert(SMEM_BYTES <= WB_SMEM, "wide backward: over 227 KB of "
                                       "shared memory");
  constexpr int SL = WB_SL<MODE>, RB = WB_RB<MODE>;
  static_assert(S::TST >= (MODE == WB_PAIR ? 2 : 1) * SL + 1 &&
                    S::TST >= 2 * S::SSTEP + 1,
                "wide backward: too few ring slots for a tile's steps");
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_wide_kernel<MODE, F32, RES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((T + RB * BM - 1) / (RB * BM), BH,
            (nc + SL - 1) / SL * (MODE == WB_BYOUT ? 2 : 1));
  flash_bwd_wide_kernel<MODE, F32, RES><<<grid, WB_THREADS, SMEM_BYTES, st>>>(
      maps, static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<Elem<F32>*>(out0), static_cast<Elem<F32>*>(out1), T, nc,
      scale_log2, scale2);
  return (int)cudaGetLastError();
}

// mode MODE at the residency its shared memory allows at nc chunks:
// X and Y resident, their hi halves (f32), or neither
template <int MODE, bool F32>
int launch_mode(const Maps& maps, const void* lse, const void* D,
                void* out0, void* out1, int BH, int T, int nc,
                float scale_log2, float scale2, cudaStream_t st) {
  if (nc <= WbSmemOf<F32, 2, MODE>::XCH)
    return launch_wide_body<MODE, F32, 2>(maps, lse, D, out0, out1, BH, T,
                                          nc, scale_log2, scale2, st);
  if constexpr (F32) {
    if (nc <= WbSmemOf<F32, 1, MODE>::XCH)
      return launch_wide_body<MODE, F32, 1>(maps, lse, D, out0, out1, BH, T,
                                            nc, scale_log2, scale2, st);
  }
  return launch_wide_body<MODE, F32, 0>(maps, lse, D, out0, out1, BH, T, nc,
                                        scale_log2, scale2, st);
}

// the wide body of dq (DKV = false) or dkv: X, Y resident and U, W walked
// ((q, do, k, v) for dq, (k, v, q, do) for dkv); f32 from the split
// pre-pass (hi of each tensor, its lo BH * T * hdw elements on), bf16 the
// tensors themselves; dkv by the rule of WbMode
template <bool DKV, bool F32>
int launch_wide(const void* x, const void* y, const void* u, const void* w,
                const void* lse, const void* D, void* out0, void* out1,
                int BH, int T, int hdw, float scale_log2, float scale2,
                cudaStream_t st) {
  const size_t n = (size_t)BH * T * hdw;
  const bf16* t[4] = {
      static_cast<const bf16*>(x), static_cast<const bf16*>(y),
      static_cast<const bf16*>(u), static_cast<const bf16*>(w)};
  Maps maps{};
  CUtensorMap* m[4] = {maps.x, maps.y, maps.u, maps.w};
  for (int i = 0; i < 4; ++i)
    for (int p = 0; p < (F32 ? 2 : 1); ++p)
      if (!make_map_wide(&m[i][p], t[i] + p * n, BH, T, hdw))
        return (int)cudaErrorInvalidValue;
  const int nc = hdw / WIDE_CHUNK;
  if constexpr (!DKV) {
    return launch_mode<WB_DQ, F32>(maps, lse, D, out0, out1, BH, T, nc,
                                   scale_log2, scale2, st);
  } else {
    // pairs where they cover the head dim (X and Y resident); CTAs of one
    // output while X and Y (f32: their hi halves) stay resident in 128
    // rows; beyond, both warpgroups on the same 64 keys
    constexpr int BRES = F32 ? 1 : 2;
    if (nc <= WB_DKV_SLICE)
      return launch_wide_body<WB_PAIR, F32, 2>(maps, lse, D, out0, out1, BH,
                                               T, nc, scale_log2, scale2, st);
    if (nc <= WbSmemOf<F32, BRES, WB_BYOUT>::XCH)
      return launch_wide_body<WB_BYOUT, F32, BRES>(
          maps, lse, D, out0, out1, BH, T, nc, scale_log2, scale2, st);
    return launch_mode<WB_SHARE, F32>(maps, lse, D, out0, out1, BH, T, nc,
                                      scale_log2, scale2, st);
  }
}

// the split pre-pass of the wide f32 body: hi and lo of q, k, v and dO
// (n elements each) into split ([8][n] bf16, tensor i's hi at 2i, its lo
// at 2i + 1) unless ``ready`` (another launch filled it from the same
// tensors), and hi[i] = tensor i's hi part
int presplit(const void* q, const void* k, const void* v, const void* dout,
             void* split, size_t n, int ready, const void* (&hi)[4],
             cudaStream_t st) {
  const void* src[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    hi[i] = static_cast<const bf16*>(split) + 2 * i * n;
  return ready ? 0 : split_launch(src, 4, split, n, st);
}

template <bool F32, int HD>
int dq_launch(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* D, void* dq,
              void* split, int BH, int T, float scale_log2, float scale2,
              cudaStream_t st) {
  if constexpr (WIDE<F32, HD>) {  // the wide body's (the entry sends it
                                  // there first)
    return (int)cudaErrorInvalidValue;
  } else {
    using E = Elem<F32>;
    const int rows = BH * T;
    flash_bwd_dot_kernel<E><<<(rows + 7) / 8, 256, 0, st>>>(
        static_cast<const E*>(o), static_cast<const E*>(dout),
        static_cast<float*>(D), rows, HD);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if constexpr (NARROW<F32, HD>)
      return flash_narrow_bwd_launch(0, q, k, v, dout, lse, D, dq, nullptr,
                                     split, BH, T, scale_log2, scale2, 0,
                                     st);
    else
      return launch<false, F32, HD>(q, dout, k, v, lse, D, dq, nullptr, BH,
                                    T, scale_log2, scale2, st);
  }
}

template <bool F32, int HD>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* D, void* dk, void* dv,
               void* split, int BH, int T, float scale_log2, float scale2,
               cudaStream_t st) {
  if constexpr (WIDE<F32, HD>)
    return (int)cudaErrorInvalidValue;
  else if constexpr (NARROW<F32, HD>)
    return flash_narrow_bwd_launch(1, q, k, v, dout, lse, D, dk, dv, split,
                                   BH, T, scale_log2, scale2, 0, st);
  else
    return launch<true, F32, HD>(k, v, q, dout, lse, D, dk, dv, BH, T,
                                 scale_log2, scale2, st);
}

template <int HD>
int dq_entry(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* D, void* dq,
             void* split, int BH, int T, float scale_log2, float scale2,
             int is_bf16, cudaStream_t st) {
  return is_bf16 ? dq_launch<false, HD>(q, k, v, o, dout, lse, D, dq, split,
                                        BH, T, scale_log2, scale2, st)
                 : dq_launch<true, HD>(q, k, v, o, dout, lse, D, dq, split,
                                       BH, T, scale_log2, scale2, st);
}

template <int HD>
int dkv_entry(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* D, void* dk, void* dv,
              void* split, int BH, int T, float scale_log2, float scale2,
              int is_bf16, cudaStream_t st) {
  return is_bf16 ? dkv_launch<false, HD>(q, k, v, dout, lse, D, dk, dv,
                                         split, BH, T, scale_log2, scale2, st)
                 : dkv_launch<true, HD>(q, k, v, dout, lse, D, dk, dv, split,
                                        BH, T, scale_log2, scale2, st);
}

// the wide body's dq: D (over hdw columns), the split pre-pass (f32),
// then dQ
template <bool F32>
int dq_wide(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* D, void* dq, void* split,
            int BH, int T, int hdw, float scale_log2, float scale2,
            cudaStream_t st) {
  using E = Elem<F32>;
  const int rows = BH * T;
  flash_bwd_dot_kernel<E><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const E*>(o), static_cast<const E*>(dout),
      static_cast<float*>(D), rows, hdw);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (F32) {
    const void* hi[4];
    const int es =
        presplit(q, k, v, dout, split, (size_t)rows * hdw, 0, hi, st);
    if (es != 0) return es;
    return launch_wide<false, true>(hi[0], hi[3], hi[1], hi[2], lse, D, dq,
                                    nullptr, BH, T, hdw, scale_log2, scale2,
                                    st);
  } else {
    return launch_wide<false, false>(q, dout, k, v, lse, D, dq, nullptr, BH,
                                     T, hdw, scale_log2, scale2, st);
  }
}

template <bool F32>
int dkv_wide(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* D, void* dk, void* dv, void* split,
             int split_ready, int BH, int T, int hdw, float scale_log2,
             float scale2, cudaStream_t st) {
  if constexpr (F32) {
    const void* hi[4];
    const int es = presplit(q, k, v, dout, split, (size_t)BH * T * hdw,
                            split_ready, hi, st);
    if (es != 0) return es;
    return launch_wide<true, true>(hi[1], hi[2], hi[0], hi[3], lse, D, dk,
                                   dv, BH, T, hdw, scale_log2, scale2, st);
  } else {
    return launch_wide<true, false>(k, v, q, dout, lse, D, dk, dv, BH, T,
                                    hdw, scale_log2, scale2, st);
  }
}

// a head dim the wide body runs: from IPDM_FLASH_BWD_WIDE_FROM up, whole
// chunks
inline bool wide_hd(int hd) {
  return hd >= IPDM_FLASH_BWD_WIDE_FROM && hd % WIDE_CHUNK == 0;
}

}  // namespace

// D = rowsum(o * do) (f32: with do's hi + lo, see above), then dQ. q, k, v,
// o, do, dq: [BH, T, hd] bf16 (is_bf16 = 1) or f32, contiguous, 16-byte
// aligned, hd in {8, 16, 32, 64} or a multiple of 64 from
// IPDM_FLASH_BWD_WIDE_FROM (128) up (the wide body); lse, D: [BH, T] f32
// (D written here, read by flash_bwd_dkv_launch); split: for f32 on the
// wide body a [8, BH, T, hd] bf16 scratch (16-byte aligned) for hi and lo
// of q, k, v and do (written here; flash_bwd_dkv_launch may take it as it
// is), at hd 8 the narrow body's, else unused (may be null).
// scale_log2 = scale2 * log2(e). Returns cudaGetLastError()
// (cudaErrorInvalidValue for bad sizes, another hd, or a tensor map that
// cuTensorMapEncodeTiled refuses).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse, void* D,
                                   void* dq, void* split, int BH, int T,
                                   int hd,
                                   float scale_log2, float scale2,
                                   int is_bf16, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide_hd(hd))
    return is_bf16 ? dq_wide<false>(q, k, v, o, dout, lse, D, dq, split, BH,
                                    T, hd, scale_log2, scale2, st)
                   : dq_wide<true>(q, k, v, o, dout, lse, D, dq, split, BH,
                                   T, hd, scale_log2, scale2, st);
  switch (hd) {
#define IPDM_DQ(H)                                                        \
  case H:                                                                 \
    return dq_entry<H>(q, k, v, o, dout, lse, D, dq, split, BH, T,        \
                       scale_log2, scale2, is_bf16, st);
    IPDM_FLASH_HEAD_DIMS(IPDM_DQ)
#undef IPDM_DQ
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dK and dV from the same inputs and the D of flash_bwd_dq_launch (split
// as there; with split_ready, on the wide f32 body, split already holds
// hi and lo of these q, k, v and do, as flash_bwd_dq_launch left it, and
// the pre-pass is not run again).
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* D, void* dk,
                                    void* dv, void* split, int split_ready,
                                    int BH, int T, int hd,
                                    float scale_log2, float scale2,
                                    int is_bf16, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide_hd(hd))
    return is_bf16
               ? dkv_wide<false>(q, k, v, dout, lse, D, dk, dv, split, 0, BH,
                                 T, hd, scale_log2, scale2, st)
               : dkv_wide<true>(q, k, v, dout, lse, D, dk, dv, split,
                                split_ready, BH, T, hd, scale_log2, scale2,
                                st);
  switch (hd) {
#define IPDM_DKV(H)                                                       \
  case H:                                                                 \
    return dkv_entry<H>(q, k, v, dout, lse, D, dk, dv, split, BH, T,      \
                        scale_log2, scale2, is_bf16, st);
    IPDM_FLASH_HEAD_DIMS(IPDM_DKV)
#undef IPDM_DKV
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Backward of flash attention for head dimension 64 on Hopper (sm_90a):
// every product on wgmma (bf16 operands, f32 sums), TMA for the loads.
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
// q, k, v, o, do, dq, dk, dv: [BH, T, 64] of one element type E (bf16 or
// f32), contiguous; lse, D: [BH, T] f32. The gradients are with respect to
// the unscaled q and k, so each carries c once.
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
// What bounds them on an H100: 5 products of T*T*64 multiply-adds per head;
// the dQ kernel rebuilds S and dP (3 products), the dK/dV kernel too (4).
// At T = 7125 and 4 heads: dq 0.0788 ms, dkv 0.1051 ms at the 989 TFLOP/s
// bf16 tensor-core rate; three times that in f32 (0.2365 / 0.3154 ms). The
// T*T exp2 of P run on the special-function units beside them (0.05 ms per
// kernel at T = 7125). The T x T matrices never leave the SM.
//
// Design (one CTA = 128 resident rows of one head, both kernels):
// - The dq kernel holds 128 query rows (Q, dO) and walks the 64-key tiles
//   of K and V; the dkv kernel holds 128 keys (K, V) and walks the 64-query
//   tiles of Q and dO, with their lse and D. Resident X, Y and ring U, W
//   below: (Q, dO, K, V) for dq, (K, V, Q, dO) for dkv.
// - Loads: one lane issues each TMA (3-D tensor maps [BH, T, 64]; rows
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
//   (all four K-major, 128-byte swizzle) into 2 x 32 f32 registers; P =
//   exp2(c * log2(e) * S - lse2) and dS = P (dP - D) on those registers,
//   rounded (bf16) or split (f32) into register-A fragments in place (the
//   m64n64 accumulator layout is the m64k16 A layout); then register-A
//   wgmmas with the ring tile as the MN-major (transposed) B operand:
//   dQ += dS K, or dV += P^T dO and dK += dS^T Q. In dq the rows' lse and
//   D sit in registers; in dkv each thread reads the lse and D of its 16
//   query columns from the slot. Ring rows past T (keys in dq, queries in
//   dkv) get P = 0: a zero-filled key would score 0, not -inf.
// - f32: TMA brings the ring tile's f32 rows into a staging slot (no
//   swizzle); the CTA's 256 threads split it into hi and lo bf16 tiles in
//   the 128-byte swizzle (a double buffer), fence the stores for the async
//   proxy and meet at a named barrier before the wgmmas read them. The
//   resident rows are loaded and split once by their warpgroup.
// - Waves and registers: 128-row CTAs give 56 x 4 = 224 CTAs at T = 7125
//   and 128 at T = 4096 (BH = 4). The bf16 dq kernel keeps two CTAs on an
//   SM (99 KB of shared memory, at most 128 registers a thread); the dkv
//   kernel (four 32-register accumulators live at once) and the f32 bodies
//   (two bf16 tiles per operand, 194 KB) run one CTA per SM. No setmaxnreg
//   (flash_attn.cu's note).
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace ipdm::hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;                    // resident rows per warpgroup
constexpr int NWG = 2;                    // warpgroups per CTA
constexpr int BR = BM * NWG;              // resident rows per CTA
constexpr int BN = 64;                    // rows per ring tile
constexpr int NTHREADS = NWG * 128;
constexpr int TILE = BN * HD;             // elements of a 64-row tile
constexpr float LOG2E = 1.4426950408889634f;

// the value of x that the products see: x in bf16; hi + lo of its split
// in f32 (exact in f32)
__device__ __forceinline__ float seen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float seen(float x) {
  const float hi = ipdm::round_bf16(x);
  return hi + ipdm::round_bf16(x - hi);
}

// D[r] = sum_d o[r][d] * seen(do[r][d]), one warp per row
template <typename E>
__global__ void __launch_bounds__(256)
    flash_bwd_dot_kernel(const E* __restrict__ o, const E* __restrict__ dout,
                         float* __restrict__ D, int rows) {
  const int r = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t at = (size_t)r * HD + 2 * lane;
  float acc = ipdm::to_f32(o[at]) * seen(dout[at]) +
              ipdm::to_f32(o[at + 1]) * seen(dout[at + 1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[r] = acc;
}

// Shared memory. bf16: the resident tiles and a 4-slot TMA ring of U, W.
// f32: hi and lo tiles of the resident rows, a 2-slot TMA staging ring of
// f32 U, W, and a double buffer of their split tiles. Every bf16 tile is
// 1024-byte aligned (128-byte swizzle atoms).
template <bool F32>
struct Smem;
template <>
struct Smem<false> {
  static constexpr int STAGES = 4;
  bf16 res[NWG][2][1][TILE];      // [warpgroup][X, Y][part]
  bf16 ring[STAGES][2][1][TILE];  // [slot][U, W][part]
  float lse[STAGES][BN], Dc[STAGES][BN];  // the slot's rows (dkv)
  uint64_t resbar, full[STAGES];
  int released[STAGES];  // warps done with the slot's tile
};
template <>
struct Smem<true> {
  static constexpr int STAGES = 2;
  bf16 res[NWG][2][2][TILE];      // [warpgroup][X, Y][hi, lo]
  bf16 ring[2][2][2][TILE];       // [buffer][U, W][hi, lo]
  float stage[STAGES][2][TILE];   // [slot][U, W], f32 rows as loaded
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
// hi and lo tiles at their 128-byte-swizzle place (16-byte chunk c4 / 2 of
// the row XOR r % 8, as TMA's SWIZZLE_128B lays a 64-column bf16 tile out)
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int r,
                                            int c4, float4 v) {
  const int off = r * 128 + ((((c4 >> 1) ^ (r & 7))) << 4) + ((c4 & 1) << 3);
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

// A warp's loads, all 32 lanes: ring tile j into slot j % STAGES once the
// slot is free (lane 0: TMA; in dkv every lane also copies two of the
// tile's rows' lse and D with cp.async, rows past T zero-filled, and has
// the slot's full barrier track them: nothing here waits on the loads)
template <bool DKV, bool F32>
__device__ __forceinline__ void issue(Smem<F32>& sm, int j,
                                      const CUtensorMap* tu,
                                      const CUtensorMap* tw,
                                      const float* lse, const float* D,
                                      int bh, int T) {
  constexpr uint32_t BYTES = 2 * TILE * (F32 ? 4 : 2);
  const int s = j % Smem<F32>::STAGES, lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_expect_tx(&sm.full[s], BYTES);
    if constexpr (F32) {
      tma_load(sm.stage[s][0], tu, &sm.full[s], j * BN, bh);
      tma_load(sm.stage[s][1], tw, &sm.full[s], j * BN, bh);
    } else {
      tma_load(sm.ring[s][0][0], tu, &sm.full[s], j * BN, bh);
      tma_load(sm.ring[s][1][0], tw, &sm.full[s], j * BN, bh);
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
template <bool DKV, bool F32, typename E>
__device__ __forceinline__ void consume(
    Smem<F32>& sm, int wg, const CUtensorMap* tu, const CUtensorMap* tw,
    const E* __restrict__ x, const E* __restrict__ y,
    const float* __restrict__ lse, const float* __restrict__ D,
    E* __restrict__ out0, E* __restrict__ out1, int T, float scale_log2,
    float scale2, int bh, int r0, int nt) {
  constexpr int STAGES = Smem<F32>::STAGES;
  constexpr int NP = F32 ? 2 : 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  const int row0 = r0 + wg * BM + warp * 16 + lane / 4, row1 = row0 + 8;
  const size_t base = (size_t)bh * T * HD;

  if constexpr (F32) {  // this warpgroup's resident rows, split
    const int t = threadIdx.x % 128;
    for (int i = t; i < BM * (HD / 4); i += 128) {
      const int r = i / (HD / 4), c4 = i % (HD / 4);
      const int row = r0 + wg * BM + r;
      float4 vx = make_float4(0.f, 0.f, 0.f, 0.f), vy = vx;
      if (row < T) {
        vx = *reinterpret_cast<const float4*>(x + base + (size_t)row * HD +
                                              4 * c4);
        vy = *reinterpret_cast<const float4*>(y + base + (size_t)row * HD +
                                              4 * c4);
      }
      store_split(sm.res[wg][0][0], sm.res[wg][0][1], r, c4, vx);
      store_split(sm.res[wg][1][0], sm.res[wg][1][1], r, c4, vy);
    }
    fence_async_smem();
    bar_sync(2 + wg, 128);
  } else {
    mbar_wait(&sm.resbar, 0);
  }
  const uint64_t xH = sw128_desc(sm.res[wg][0][0]);
  const uint64_t yH = sw128_desc(sm.res[wg][1][0]);
  const uint64_t xL = sw128_desc(sm.res[wg][0][F32 ? 1 : 0]);
  const uint64_t yL = sw128_desc(sm.res[wg][1][F32 ? 1 : 0]);

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

  float acc0[32], acc1[32];  // dq; or dk, dv
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;

  for (int j = 0; j < nt; ++j) {
    const int s = j % STAGES;
    mbar_wait(&sm.full[s], (j / STAGES) & 1);
    bf16 *uh, *ul, *wh, *wl;
    if constexpr (F32) {  // split the staged f32 tile; both warpgroups
      const int b = j & 1;
      for (int i = threadIdx.x; i < BN * (HD / 4); i += NTHREADS) {
        const int r = i / (HD / 4), c4 = i % (HD / 4);
        store_split(sm.ring[b][0][0], sm.ring[b][0][1], r, c4,
                    *reinterpret_cast<const float4*>(
                        &sm.stage[s][0][r * HD + 4 * c4]));
        store_split(sm.ring[b][1][0], sm.ring[b][1][1], r, c4,
                    *reinterpret_cast<const float4*>(
                        &sm.stage[s][1][r * HD + 4 * c4]));
      }
      fence_async_smem();
      bar_sync(1, NTHREADS);
      uh = sm.ring[b][0][0];
      ul = sm.ring[b][0][1];
      wh = sm.ring[b][1][0];
      wl = sm.ring[b][1][1];
    } else {
      uh = ul = sm.ring[s][0][0];
      wh = wl = sm.ring[s][1][0];
    }
    const uint64_t uH = sw128_desc(uh), uL = sw128_desc(ul);
    const uint64_t wH = sw128_desc(wh), wL = sw128_desc(wl);

    // S = X U^T, dP = Y W^T
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    reg_fence(sc);
    reg_fence(dp);
    wg_fence();
    product_ss<F32>(sc, xH, xL, uH, uL);
    product_ss<F32>(dp, yH, yL, wH, wL);
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
    if constexpr (DKV) {  // dV += P^T dO, dK += dS^T Q
      uint32_t pa[NP][16];
      to_a(pa, sc);
      reg_fence(acc0);
      reg_fence(acc1);
      reg_fence_a(pa);
      reg_fence_a(da);
      wg_fence();
      product_rs(acc1, pa, wH, wL);
      product_rs(acc0, da, uH, uL);
      wg_commit();
      reg_fence(acc0);
      reg_fence(acc1);
      wg_wait_all();
      reg_fence(acc0);
      reg_fence(acc1);
    } else {  // dQ += dS K
      reg_fence(acc0);
      reg_fence_a(da);
      wg_fence();
      product_rs(acc0, da, uH, uL);
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
      issue<DKV, F32>(sm, j + STAGES, tu, tw, lse, D, bh, T);
  }

  // rows < T: dq = c acc0; or dk = c acc0, dv = acc1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (row >= T) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
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

template <bool DKV, bool F32>
__global__ void __launch_bounds__(NTHREADS, (DKV || F32) ? 1 : 2)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap ty,
                     const __grid_constant__ CUtensorMap tu,
                     const __grid_constant__ CUtensorMap tw,
                     const Elem<F32>* __restrict__ x,
                     const Elem<F32>* __restrict__ y,
                     const float* __restrict__ lse,
                     const float* __restrict__ D, Elem<F32>* __restrict__ out0,
                     Elem<F32>* __restrict__ out1, int T, float scale_log2,
                     float scale2) {
  extern __shared__ unsigned char smem_raw[];
  Smem<F32>& sm = *reinterpret_cast<Smem<F32>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SW_ATOM - 1) &
      ~uintptr_t(SW_ATOM - 1));
  const int bh = blockIdx.y, r0 = blockIdx.x * BR;
  const int nt = (T + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(&sm.resbar, 1);
    for (int s = 0; s < Smem<F32>::STAGES; ++s) {
      mbar_init(&sm.full[s], DKV ? 1 + 32 : 1);
      sm.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // warp 0: the resident tiles (bf16), the first
                           // STAGES ring tiles
    if constexpr (!F32) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(&sm.resbar, NWG * 2 * TILE * 2);
        for (int w = 0; w < NWG; ++w) {
          tma_load(sm.res[w][0][0], &tx, &sm.resbar, r0 + w * BM, bh);
          tma_load(sm.res[w][1][0], &ty, &sm.resbar, r0 + w * BM, bh);
        }
      }
    }
    for (int j = 0; j < Smem<F32>::STAGES && j < nt; ++j)
      issue<DKV, F32>(sm, j, &tu, &tw, lse, D, bh, T);
  }
  consume<DKV, F32>(sm, threadIdx.x / 128, &tu, &tw, x, y, lse, D, out0,
                    out1, T, scale_log2, scale2, bh, r0, nt);
}

// X, Y resident and U, W walked: (q, do, k, v) for dq, (k, v, q, do) for
// dkv
template <bool DKV, bool F32>
int launch(const void* x, const void* y, const void* u, const void* w,
           const void* lse, const void* D, void* out0, void* out1, int BH,
           int T, float scale_log2, float scale2, cudaStream_t st) {
  using E = Elem<F32>;
  constexpr int SMEM_BYTES = (int)sizeof(Smem<F32>) + SW_ATOM;
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kernel<DKV, F32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const auto map = F32 ? make_map_f32 : make_map;
  CUtensorMap tx, ty, tu, tw;
  if (!map(&tx, x, BH, T) || !map(&ty, y, BH, T) || !map(&tu, u, BH, T) ||
      !map(&tw, w, BH, T))
    return (int)cudaErrorInvalidValue;
  dim3 grid((T + BR - 1) / BR, BH);
  flash_bwd_kernel<DKV, F32><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      tx, ty, tu, tw, static_cast<const E*>(x), static_cast<const E*>(y),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<E*>(out0), static_cast<E*>(out1), T, scale_log2, scale2);
  return (int)cudaGetLastError();
}

template <bool F32>
int dq_launch(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* D, void* dq, int BH,
              int T, float scale_log2, float scale2, cudaStream_t st) {
  using E = Elem<F32>;
  const int rows = BH * T;
  flash_bwd_dot_kernel<E><<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const E*>(o), static_cast<const E*>(dout),
      static_cast<float*>(D), rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch<false, F32>(q, dout, k, v, lse, D, dq, nullptr, BH, T,
                            scale_log2, scale2, st);
}

}  // namespace

// D = rowsum(o * do) (f32: with do's hi + lo, see above), then dQ. q, k, v,
// o, do, dq: [BH, T, 64] bf16 (is_bf16 = 1) or f32, contiguous, 16-byte
// aligned; lse, D: [BH, T] f32 (D written here, read by
// flash_bwd_dkv_launch). scale_log2 = scale2 * log2(e). Returns
// cudaGetLastError() (cudaErrorInvalidValue for bad sizes or a tensor map
// that cuTensorMapEncodeTiled refuses).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse, void* D,
                                   void* dq, int BH, int T, float scale_log2,
                                   float scale2, int is_bf16, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dq_launch<false>(q, k, v, o, dout, lse, D, dq, BH, T,
                                    scale_log2, scale2, st)
                 : dq_launch<true>(q, k, v, o, dout, lse, D, dq, BH, T,
                                   scale_log2, scale2, st);
}

// dK and dV from the same inputs and the D of flash_bwd_dq_launch.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* D, void* dk,
                                    void* dv, int BH, int T, float scale_log2,
                                    float scale2, int is_bf16, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<true, false>(k, v, q, dout, lse, D, dk, dv, BH, T,
                                       scale_log2, scale2, st)
                 : launch<true, true>(k, v, q, dout, lse, D, dk, dv, BH, T,
                                      scale_log2, scale2, st);
}

// The f32 flash backward at head dimension 8 on Hopper (sm_90a): the body
// that flash_bwd_dq_launch and flash_bwd_dkv_launch run at (hd 8, f32)
// (the ablation UNets' middle block: 4 heads over 128² and 500×228
// tokens), in place of flash_bwd.cu's template instance at head dim 8.
// Same outputs (dq; dk and dv), same contract as flash_bwd.cu:
//
//   P  = exp2(c log2(e) Q K^T - lse log2(e))   (rebuilt, never stored)
//   dS = P (dO V^T - D),  D = rowsum(dO O) (flash_bwd_dot_kernel)
//   dQ = c dS K,  dK = c dS^T Q,  dV = P^T dO
//
// and the same f32 rule: every product from bf16 hi / lo splits of its
// operands (hi*hi + hi*lo + lo*hi), D with the dO the products see, each
// ring tile's N = 8 products summed from zero and added to the outputs
// with an f32 add, one writer per output and a fixed sum order (two
// launches give the same bits).
//
// Replaces, with flash_bwd.cu, the TPU flash backward's two Pallas kernels
// behind ipdm_tpu/models/unet.py:601 _flash_attention:
// _flash_attention_bwd_dq (jax/experimental/pallas/ops/tpu/
// flash_attention.py:1287, pallas_call :1456) and _flash_attention_bwd_dkv
// (:941, pallas_call :1121).
//
// What bounds it on an H100: the T*T exp2 a head of P, rebuilt in each
// kernel, on the special-function units (16 a clock per SM): 12.4 ms a
// kernel at T = 114 000 and 4 heads. The function's f32 products take 7.6
// (dq) and 10.1 ms (dkv) at the bf16 tensor-core peak. The template's
// body ran at 3.9x (dq) and 6.8x (dkv) that bound: it staged f32 ring rows
// and split them into bf16 tiles in the CTA each tile, behind a barrier of
// both warpgroups; it ran S and dP in three k16 passes and the N = 8
// products in three N = 16 passes; one CTA an SM. On an H100 this body's
// time follows the instructions a score issues (PERF.md rows 3q8 / 3k8):
// each one a score costs ~3 ms at T = 114 000, so the design counts them.
//
// Design (one CTA = NWG warpgroups of 64 resident rows, no producer warp;
// ring tiles of KT x 64 rows through a ring of 8 / KT slots):
// - A pre-pass writes the ring side once a launch as packed bf16 rows of
//   32 columns (the Head<32> tile layout, 64-byte rows): for u, w = k, v
//   in dq and q, dO in dkv, [hi(u) | lo(u) | hi(u) | f], with f = (1, 1,
//   1, 0, ..) in dq and in dkv the row's lse log2 e (u = q) or D (w = dO)
//   as three bf16 (hi, mid, lo: its 24 bits), then zeros. The ring
//   TMA-loads those rows: no f32 staging, no split in the CTA, no barrier
//   between the warpgroups.
// - The resident rows (q, dO in dq; k, v in dkv) never touch shared
//   memory: each thread loads its two rows' two columns of each and splits
//   them into register-A fragments, [hi(x) | hi(x)] for the ring row's
//   first 16 columns and [lo(x) | e] for its last 16, with x = c log2(e) q
//   (dq) or c log2(e) k (dkv) for S and x = dO or v for dP, and e = -lse
//   log2 e or -D as three bf16 (dq) or (-1, -1, -1) (dkv). Two m64n64k16
//   wgmmas then give S' = c log2(e) S - lse log2(e) (x_hi u_hi + x_hi u_lo
//   + x_lo u_hi + e f) and dP - D: the exp2 takes S' as it is and dS is
//   one multiply, where the scale, the lse and D cost three instructions a
//   score on the CUDA cores.
// - The N = 8 products at n16 + n8: dS_hi [K_hi | K_lo] is one N = 16
//   wgmma (the ring row's first 16 columns), dS_lo K_hi one N = 8 wgmma
//   into the first 8 columns of the same sums (2-4% faster than an N = 16
//   lo pass); the two 8-column halves are added when the ring tile's sums
//   join the outputs. dQ = dS K, dV = P^T dO, dK = dS^T Q alike. In dkv,
//   S^T = K Q^T puts P^T and dS^T in the accumulator layout (rows =
//   resident keys), which packed to bf16 pairs is the register-A layout.
// - P and dS split by truncation (hopper.cuh split_trunc): hi = the top
//   16 bits, lo = bf16(x - hi); x = hi + lo to 2^-16 of x. The key mask
//   runs on the last ring tile only.
// - No register is zeroed in the loop: the first wgmma of each chain
//   overwrites its sums. The last warp to release a slot refills it
//   (flash_narrow.cu's scheme). NWG and KT are build constants
//   (IPDM_NARROW_BWD_NWG, IPDM_NARROW_BWD_KT): 2 CTAs of 2 warpgroups an
//   SM take at most 128 registers a thread; the KT sub-tiles of a ring
//   tile run one after the other inside one wait and one release, so S
//   and dP of one 64-row sub-tile (64 registers) are live at a time.
//   `scripts/torch_kernels_ab.py --narrow-bwd-variants` builds this file
//   at other (NWG, KT) and times each against the shipped build
//   (PERF.md rows 3q8 / 3k8 keep the times, and those of the versions
//   tried on the way).
#include "hopper.cuh"

namespace {

using namespace ipdm::hopper;
using bf16 = __nv_bfloat16;

// warpgroups a CTA and 64-row sub-tiles a ring tile (see the header)
#ifndef IPDM_NARROW_BWD_NWG
#define IPDM_NARROW_BWD_NWG 2
#endif
#ifndef IPDM_NARROW_BWD_KT
#define IPDM_NARROW_BWD_KT 2
#endif
constexpr int NWG = IPDM_NARROW_BWD_NWG;
constexpr int KT = IPDM_NARROW_BWD_KT;
// CTAs an SM should hold: the registers a thread may take are those of
// 16 warps (128), or of the CTA's warps where one CTA holds more
constexpr int MIN_CTAS = NWG < 4 ? 4 / NWG : 1;
static_assert(NWG >= 1 && NWG <= 8 && (KT == 1 || KT == 2),
              "flash_narrow_bwd: 1-8 warpgroups, 1 or 2 sub-tiles a tile");

constexpr int BM = 64;                 // resident rows per warpgroup
constexpr int BK = 64 * KT;            // ring rows per tile
constexpr int COLS = 32;               // a ring row: 32 bf16, Head<32>
constexpr int TILE = 64 * COLS;        // elements of a 64-row tile
constexpr int TILE_BYTES = TILE * 2;
constexpr int STAGES = 8 / KT;         // ring slots: 512 rows in flight
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t BF16_ONE = 0x3F80u;  // 1.0 in bf16
constexpr uint32_t BF16_MINUS_ONE = 0xBF80u;

struct Smem {
  bf16 ring[STAGES][KT][2][TILE];  // [slot][sub-tile][U, W]
  uint64_t full[STAGES];
  int released[STAGES];            // warps done with the slot's tile
};

struct Maps {
  CUtensorMap u, w;
};

// x (f32) as three bf16 whose sum is x to its 24 bits: (hi, mid) and
// (lo, 0) as bf16 pairs
__device__ __forceinline__ void split3(float x, uint32_t& hm, uint32_t& l0) {
  const float hi = ipdm::round_bf16(x), r = x - hi;
  const float mid = ipdm::round_bf16(r);
  hm = pack_bf16(hi, mid);
  l0 = pack_bf16(r - mid, 0.f);
}

// 8 f32 of a row (two float4) as the ring row [hi | lo | hi | f] (4 uint4)
// with f's first 3 columns given as two bf16 pairs (the rest zeros);
// drop_lo writes lo as zeros
__device__ __forceinline__ void ring_row(const float4* src, uint32_t f01,
                                         uint32_t f2, int drop_lo,
                                         uint4* dst) {
  uint4 hi, lo;
  split8(src, hi, lo);
  dst[0] = hi;
  dst[1] = drop_lo ? make_uint4(0u, 0u, 0u, 0u) : lo;
  dst[2] = hi;
  dst[3] = make_uint4(f01, f2, 0u, 0u);
}

// row r of u and w ([rows, 8] f32) as ring rows of the scratch's two
// [rows, 32] bf16 tensors (4 uint4 a row); f = (1, 1, 1) in dq, in dkv
// (lse log2 e) of row r for u and D of row r for w, each as three bf16.
// drop_lo (a planted fault for chip_smoke.py, never set on a main path)
// writes the lo columns as zeros.
__global__ void __launch_bounds__(256)
    narrow_bwd_split_kernel(const float4* __restrict__ u,
                            const float4* __restrict__ w,
                            const float* __restrict__ lse,
                            const float* __restrict__ D,
                            uint4* __restrict__ dst, size_t rows, int dkv,
                            int drop_lo) {
  const uint32_t ones = BF16_ONE | BF16_ONE << 16;
  for (size_t r = blockIdx.x * 256 + threadIdx.x; r < rows;
       r += (size_t)gridDim.x * 256) {
    uint32_t fu01 = ones, fu2 = BF16_ONE, fw01 = ones, fw2 = BF16_ONE;
    if (dkv) {
      split3(lse[r] * LOG2E, fu01, fu2);
      split3(D[r], fw01, fw2);
    }
    ring_row(u + 2 * r, fu01, fu2, drop_lo, dst + 4 * r);
    ring_row(w + 2 * r, fw01, fw2, drop_lo, dst + 4 * (rows + r));
  }
}

// ring tile j into slot j % STAGES: U and W of each sub-tile (one lane;
// rows past T read TMA's zeros)
__device__ __forceinline__ void load_tile(Smem& sm, const Maps& maps, int j,
                                          int bh) {
  const int s = j % STAGES;
  mbar_expect_tx(&sm.full[s], KT * 2 * TILE_BYTES);
  for (int h = 0; h < KT; ++h) {
    tma_load(sm.ring[s][h][0], &maps.u, &sm.full[s], j * BK + h * 64, bh);
    tma_load(sm.ring[s][h][1], &maps.w, &sm.full[s], j * BK + h * 64, bh);
  }
}

// The resident register-A fragments of one operand: (h0, h1, h0, h1) is
// [hi(x) | hi(x)], (l0, l1, e0, e1) is [lo(x) | e], for the thread's rows
// r0 (h0, l0, e0) and r1 = r0 + 8
struct Frag {
  uint32_t h0, h1, l0, l1, e0, e1;
};

// row ``row`` of x ([T, 8] f32 at xb), columns c2, c2 + 1, times ``mul``,
// split into a hi and a lo bf16 pair (zeros past T)
__device__ __forceinline__ void res_pair(const float* xb, int row, int T,
                                         int c2, float mul, uint32_t& hi,
                                         uint32_t& lo) {
  float2 v = make_float2(0.f, 0.f);
  if (row < T)
    v = *reinterpret_cast<const float2*>(xb + (size_t)row * 8 + c2);
  split2(v.x * mul, v.y * mul, hi, lo);
}

// e's columns c2, c2 + 1 of one row: -(t as three bf16), then zeros
__device__ __forceinline__ uint32_t e_pair(float t, int c2) {
  uint32_t hm, l0;
  split3(-t, hm, l0);
  return c2 == 0 ? hm : c2 == 2 ? l0 : 0u;
}

// d (= or +=) A B over one 64-row sub-tile (K = 64), A = hi + lo register
// fragments, B the sub-tile at ``b`` (MN-major: its first 16 columns
// [hi | lo]): hi B as one N = 16 chain, lo B_hi at N = 8 into the first
// 8 columns; ``first`` overwrites d
__device__ __forceinline__ void product8(float (&d)[8],
                                         const uint32_t (&hi)[16],
                                         const uint32_t (&lo)[16], uint32_t b,
                                         bool first) {
  constexpr int MN = Head<COLS>::MN_STEP;
  float(&d4)[4] = *reinterpret_cast<float(*)[4]>(&d[0]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<16>(d, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                 hi[4 * kk + 3], desc_at<COLS>(b + kk * MN), !first || kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<8>(d4, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                lo[4 * kk + 3], desc_at<COLS>(b + kk * MN));
}

// d = A B^T over the ring row's 32 columns (two k16 steps), A the
// resident fragments f, B the sub-tile at ``b`` (K-major)
__device__ __forceinline__ void score(float (&d)[32], const Frag& f,
                                      uint32_t b) {
  wgmma_rs<64, 0>(d, f.h0, f.h1, f.h0, f.h1, desc_at<COLS>(b), 0);
  wgmma_rs<64, 0>(d, f.l0, f.l1, f.e0, f.e1,
                  desc_at<COLS>(b + Head<COLS>::k_step(1)));
}

// the accumulator's 16 pairs as hi and lo register-A fragments
__device__ __forceinline__ void split_a(const float (&x)[32],
                                        uint32_t (&hi)[16],
                                        uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    split_trunc(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
}

// a product group's wgmmas issued: waits for them, keeping the compiler
// from moving the sums' or the A fragments' registers across the wait
__device__ __forceinline__ void wait_products(float (&t)[8],
                                              uint32_t (&hi)[16],
                                              uint32_t (&lo)[16]) {
  reg_fence(t);
  wg_wait_all();
  reg_fence(t);
  reg_fence(hi);
  reg_fence(lo);
}

// One warpgroup: 64 resident rows (queries in dq, keys in dkv) against
// every ring tile. S' and dP - D are m64n64 (sc, dp: the sub-tile's row
// 64 h + 8 (i / 4) + c2 + (i & 1) in register i); the tile sums t0 (dQ;
// dK) and t1 (dV) m64n16, whose column c and c + 8 join the output's
// column c.
template <bool DKV>
__device__ __forceinline__ void consume(
    Smem& sm, const Maps& maps, int wg, const float* __restrict__ x,
    const float* __restrict__ y, const float* __restrict__ lse,
    const float* __restrict__ D, float* __restrict__ out0,
    float* __restrict__ out1, int T, float scale_log2, float scale2, int bh,
    int r0, int nk) {
  constexpr uint32_t PART = TILE_BYTES >> 4;  // a tile, descriptor units
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  const int row0 = r0 + wg * BM + warp * 16 + lane / 4, row1 = row0 + 8;
  const size_t base = (size_t)bh * T;

  Frag fx, fy;  // S's (x = c log2 e times q or k) and dP's (dO or v)
  res_pair(x + base * 8, row0, T, c2, scale_log2, fx.h0, fx.l0);
  res_pair(x + base * 8, row1, T, c2, scale_log2, fx.h1, fx.l1);
  res_pair(y + base * 8, row0, T, c2, 1.f, fy.h0, fy.l0);
  res_pair(y + base * 8, row1, T, c2, 1.f, fy.h1, fy.l1);
  if constexpr (DKV) {  // the ring row's (lse log2 e, D) times -1
    const uint32_t m1 = BF16_MINUS_ONE | BF16_MINUS_ONE << 16;
    const uint32_t e = c2 == 0 ? m1 : c2 == 2 ? BF16_MINUS_ONE : 0u;
    fx.e0 = fx.e1 = fy.e0 = fy.e1 = e;
  } else {  // -(lse log2 e) and -D of the rows; past T a score of -2^100
    const float l0 = row0 < T ? lse[base + row0] * LOG2E : 0x1p100f;
    const float l1 = row1 < T ? lse[base + row1] * LOG2E : 0x1p100f;
    fx.e0 = e_pair(l0, c2);
    fx.e1 = e_pair(l1, c2);
    fy.e0 = e_pair(row0 < T ? D[base + row0] : 0.f, c2);
    fy.e1 = e_pair(row1 < T ? D[base + row1] : 0.f, c2);
  }

  float acc0[4], acc1[4], sc[32], dp[32], t0[8], t1[8];
  uint32_t ah[16], al[16];  // P or dS as m64k16 A fragments, hi and lo
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = dp[i] = 0.f;
    if (i < 16) ah[i] = al[i] = 0u;
    if (i < 8) t0[i] = t1[i] = 0.f;
    if (i < 4) acc0[i] = acc1[i] = 0.f;
  }
  const uint32_t ring = (uint32_t)sw_desc<COLS>(sm.ring[0][0][0]);
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    mbar_wait(&sm.full[s], (j / STAGES) & 1);
    const int live = T - j * BK;  // ring rows < T in this tile
#pragma unroll
    for (int h = 0; h < KT; ++h) {
      if (h * 64 >= live) break;  // a sub-tile wholly past T
      const uint32_t u = ring + (s * KT + h) * 2 * PART, w = u + PART;

      // S' = c log2(e) X U^T - lse log2(e), dP - D = Y W^T - D
      reg_fence(sc);
      reg_fence(dp);
      wg_fence();
      score(sc, fx, u);
      score(dp, fy, w);
      wg_commit();
      reg_fence(sc);
      reg_fence(dp);
      wg_wait_all();
      reg_fence(sc);
      reg_fence(dp);

      // P into sc, dS into dp; ring rows >= T: P = dS = 0
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = fast_exp2(sc[i]);
        dp[i] *= sc[i];
      }
      if (live < 64 * (h + 1)) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (64 * h + 8 * (i / 4) + c2 + (i & 1) >= live)
            sc[i] = dp[i] = 0.f;
      }

      if constexpr (DKV) {  // dV += P^T dO
        split_a(sc, ah, al);
        reg_fence(t1);
        reg_fence(ah);
        reg_fence(al);
        wg_fence();
        product8(t1, ah, al, w, h == 0);
        wg_commit();
        wait_products(t1, ah, al);
      }
      split_a(dp, ah, al);  // dQ += dS K, or dK += dS^T Q
      reg_fence(t0);
      reg_fence(ah);
      reg_fence(al);
      wg_fence();
      product8(t0, ah, al, u, h == 0);
      wg_commit();
      wait_products(t0, ah, al);
    }
    // this warp is done with slot s; the last of the CTA's warps refills
    // it with tile j + STAGES
    __syncwarp();
    if (lane == 0 && count_release(&sm.released[s]) == NWG * 4 - 1) {
      sm.released[s] = 0;
      if (j + STAGES < nk) load_tile(sm, maps, j + STAGES, bh);
    }
    // the tile's sums, columns c and c + 8, into the outputs in f32
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc0[i] += t0[i] + t0[i + 4];
      if constexpr (DKV) acc1[i] += t1[i] + t1[i + 4];
    }
  }

  // rows < T: dq = c acc0; or dk = c acc0, dv = acc1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= T) continue;
    const size_t at = (base + row) * 8 + c2;
    *reinterpret_cast<float2*>(out0 + at) =
        make_float2(acc0[2 * r] * scale2, acc0[2 * r + 1] * scale2);
    if constexpr (DKV)
      *reinterpret_cast<float2*>(out1 + at) =
          make_float2(acc1[2 * r], acc1[2 * r + 1]);
  }
}

template <bool DKV>
__global__ void __launch_bounds__(NWG * 128, MIN_CTAS)
    flash_narrow_bwd_kernel(const __grid_constant__ Maps maps,
                            const float* __restrict__ x,
                            const float* __restrict__ y,
                            const float* __restrict__ lse,
                            const float* __restrict__ D,
                            float* __restrict__ out0,
                            float* __restrict__ out1, int T,
                            float scale_log2, float scale2) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SW_ATOM - 1) &
      ~uintptr_t(SW_ATOM - 1));
  const int bh = blockIdx.y, r0 = blockIdx.x * BM * NWG;
  const int nk = (T + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      sm.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)  // the first STAGES ring tiles
    for (int j = 0; j < STAGES && j < nk; ++j) load_tile(sm, maps, j, bh);
  consume<DKV>(sm, maps, threadIdx.x / 128, x, y, lse, D, out0, out1, T,
               scale_log2, scale2, bh, r0, nk);
}

constexpr int SMEM_BYTES = (int)sizeof(Smem) + SW_ATOM;

template <bool DKV>
int launch(const void* x, const void* y, const void* u, const void* w,
           const void* lse, const void* D, void* out0, void* out1,
           void* split, int BH, int T, float scale_log2, float scale2,
           int drop_lo, cudaStream_t st) {
  const size_t rows = (size_t)BH * T;
  bf16* sp = static_cast<bf16*>(split);
  const unsigned gx =
      (unsigned)((rows + 255) / 256 < 132 * 8 ? (rows + 255) / 256 : 132 * 8);
  narrow_bwd_split_kernel<<<gx, 256, 0, st>>>(
      static_cast<const float4*>(u), static_cast<const float4*>(w),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      reinterpret_cast<uint4*>(sp), rows, DKV, drop_lo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Maps maps;
  if (!make_map<COLS>(&maps.u, sp, BH, T) ||
      !make_map<COLS>(&maps.w, sp + rows * COLS, BH, T))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process
      flash_narrow_bwd_kernel<DKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + BM * NWG - 1) / (BM * NWG), BH);
  flash_narrow_bwd_kernel<DKV><<<grid, NWG * 128, SMEM_BYTES, st>>>(
      maps, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<float*>(out0), static_cast<float*>(out1), T, scale_log2,
      scale2);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward at (hd 8, f32): dkv = 0, dq into out0 (q, k, v, do, lse,
// D: the D of flash_bwd_dot_kernel); dkv = 1, dk into out0 and dv into
// out1. q, k, v, do, out0, out1: [BH, T, 8] f32, contiguous, 16-byte
// aligned; lse, D: [BH, T] f32. split: the scratch (16-byte aligned) of
// 2 * BH * T * 32 bf16 for the ring's packed rows (ops/cuda/attention.py
// _bwd_split). drop_lo != 0 writes the ring rows' lo columns as zeros (a
// planted fault; flash_bwd_dq_launch and flash_bwd_dkv_launch pass 0).
// Returns cudaGetLastError() of the first launch that fails
// (cudaErrorInvalidValue for bad sizes or a tensor map that
// cuTensorMapEncodeTiled refuses).
extern "C" int flash_narrow_bwd_launch(int dkv, const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* D,
                                       void* out0, void* out1, void* split,
                                       int BH, int T, float scale_log2,
                                       float scale2, int drop_lo,
                                       void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dkv ? launch<true>(k, v, q, dout, lse, D, out0, out1, split, BH, T,
                            scale_log2, scale2, drop_lo, st)
             : launch<false>(q, dout, k, v, lse, D, out0, nullptr, split, BH,
                             T, scale_log2, scale2, drop_lo, st);
}

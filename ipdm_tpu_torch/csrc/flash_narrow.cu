// The f32 flash forward at head dimension 8 on Hopper (sm_90a): the body
// that flash_attn_f32_launch runs at hd 8 (the ablation UNets' middle
// block: 4 heads over 128² and 500×228 tokens), in place of the template's
// head-dim-8 instance (flash_attn.cu). Same function, same outputs (out
// and the natural-log lse), same f32 rule: every product is three bf16
// passes of split operands (hi*hi + hi*lo + lo*hi), each key tile's P V
// summed from zero and added to O with an f32 FMA.
//
// Replaces, with flash_attn.cu, the TPU flash kernel behind
// ipdm_tpu/models/unet.py:601 _flash_attention.
//
// What bounds it on an H100: the softmax's T*T exp2 a head on the
// special-function units (16 a clock per SM: 12.4 ms at T = 114 000 and
// 4 heads); the function's f32 products take 5.0 ms at the bf16
// tensor-core peak. At head dim 8 every other per-score instruction
// competes with the exp2 for issue slots: the template's body spent ~9 a
// score (the scale FMA, the max, the exp2, the row sum, the hi / lo split
// of P in four conversions, zeroing the sums for each tile) on 8 consumer
// warps an SM, and ran at 3.5x the exp2 bound.
//
// Design (one CTA = NWG warpgroups of 64 query rows, no producer warp;
// key tiles of KT x 64 keys through a ring of 8 / KT slots):
// - A pre-pass writes five [BH, T, 16] bf16 tensors (32-byte rows, the
//   Head<16> tile layout) from q, k, v: QP = [hi(q) | lo(q)],
//   K1 = [hi(k) | hi(k)], K2 = [lo(k) | 0], VH = [hi(v) | 1 0 .. 0],
//   VL = [lo(v) | 0]. S = QP K1^T + QP K2^T is then two wgmma m64n64k16
//   (q_hi k_hi + q_lo k_hi, then q_hi k_lo): the three passes in two k16
//   steps, where the padded template took three.
// - V's column 8 holds ones, so P V's column 8 is the row sum of P: the
//   sum rides the P V wgmmas (N = 16, whose pad columns were idle) and
//   costs no add a score; O and l are then sums of the same split P.
// - P splits by truncation: hi = the top 16 bits of p (one AND, packed in
//   pairs by one byte permute), lo = bf16(p - hi) (one FADD, one
//   conversion a pair): p = hi + lo to 2^-16 of p, against 2^-17 for a
//   rounded hi, with half the float-to-bf16 conversions.
// - No register is zeroed in the key loop: the first wgmma of each chain
//   overwrites its sums (scale-d = 0). Tile descriptors move in their low
//   32-bit word only.
// - More warps resident: no producer warp (a producer warp beside 4
//   warpgroups puts a fifth warp on one SM sub-partition and caps every
//   thread at 96 registers, where the body needs ~87); the last warp to
//   release a slot refills it (flash_bwd.cu's scheme). NWG warpgroups a
//   CTA and KT 64-key sub-tiles a key tile are constants of the build
//   (IPDM_NARROW_NWG, IPDM_NARROW_KT): one body runs every T.
// - 128-key tiles (KT = 2): one ring wait, one row max of shuffles, one
//   rescale of O and one slot release per 128 keys, where 64-key tiles
//   paid each twice. S of both sub-tiles is 64 registers, so the body
//   takes 128 (8 bytes spilled) at 2 CTAs of 2 warpgroups an SM; 6
//   warpgroups a CTA cap it at 80 and spill 108 bytes.
//   `scripts/torch_kernels_ab.py --narrow-variants` builds this file at
//   other (NWG, KT) and times each against the shipped build, A B B A:
//   on an H100 (2, 2) ran fastest at T = 114 000 and within 2% of the
//   fastest at 16 384 (PERF.md row 3f8 keeps the times).
// Tried on an H100 and dropped, each slower at T = 114 000 than the
// 64-key body it was built on, with development code that is not kept
// (so no time is given for them): a producer warp; the next tile's S issued
// before this tile's softmax (two score buffers: 96-126 registers, spills
// at 4 warpgroups); P V at N = 32 from one [hi(v) | lo(v) | 1] tile (8
// wgmmas, 20% more products); each 16-key fragment's P V issued as soon
// as it is split; an empty mbarrier a slot, refilled by one warp a few
// tiles behind.
#include "hopper.cuh"

namespace {

using namespace ipdm::hopper;
using bf16 = __nv_bfloat16;

// warpgroups a CTA and 64-key sub-tiles a key tile (see the header)
#ifndef IPDM_NARROW_NWG
#define IPDM_NARROW_NWG 2
#endif
#ifndef IPDM_NARROW_KT
#define IPDM_NARROW_KT 2
#endif
constexpr int NWG = IPDM_NARROW_NWG;
constexpr int KT = IPDM_NARROW_KT;
// CTAs an SM should hold: the registers a thread may take are those of
// 16 warps (128), or of the CTA's warps where one CTA holds more
constexpr int MIN_CTAS = NWG < 4 ? 4 / NWG : 1;
static_assert(NWG >= 1 && NWG <= 8 && (KT == 1 || KT == 2),
              "flash_narrow: 1-8 warpgroups, 1 or 2 sub-tiles a key tile");

constexpr int BM = 64;                 // query rows per warpgroup
constexpr int BK = 64 * KT;            // keys per tile
constexpr int COLS = 16;               // a tile row: 16 bf16, Head<16>
constexpr int TILE = 64 * COLS;        // elements of a 64-row tile
constexpr int TILE_BYTES = TILE * 2;
constexpr int STAGES = 8 / KT;         // ring slots: 512 keys in flight
// the pre-pass's tensors, in their order in the split scratch
enum { QP, K1, K2, VH, VL, NPARTS };
constexpr uint32_t BF16_ONE = 0x3F80u;  // 1.0 in bf16

struct Smem {
  bf16 q[NWG][TILE];                 // QP, each warpgroup's 64 rows
  bf16 ring[STAGES][KT][4][TILE];    // K1, K2, VH, VL of each sub-tile
  uint64_t qbar, full[STAGES];
  int released[STAGES];              // warps done with the slot's tile
};

struct Maps {
  CUtensorMap m[NPARTS];
};

// row r of q, k, v ([rows, 8] f32) into row r of the five [rows, 16] bf16
// tensors of dst (2 uint4 a row, 2 * rows a tensor)
__global__ void __launch_bounds__(256)
    narrow_split_kernel(const float4* __restrict__ q,
                        const float4* __restrict__ k,
                        const float4* __restrict__ v,
                        uint4* __restrict__ dst, size_t rows) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const size_t n = 2 * rows;
  for (size_t r = blockIdx.x * 256 + threadIdx.x; r < rows;
       r += (size_t)gridDim.x * 256) {
    uint4 qh, ql, kh, kl, vh, vl;
    split8(q + 2 * r, qh, ql);
    split8(k + 2 * r, kh, kl);
    split8(v + 2 * r, vh, vl);
    uint4* d = dst + 2 * r;
    d[QP * n] = qh;
    d[QP * n + 1] = ql;
    d[K1 * n] = kh;
    d[K1 * n + 1] = kh;
    d[K2 * n] = kl;
    d[K2 * n + 1] = zero;
    d[VH * n] = vh;
    d[VH * n + 1] = make_uint4(BF16_ONE, 0u, 0u, 0u);  // column 8: ones
    d[VL * n] = vl;
    d[VL * n + 1] = zero;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// key tile j into slot j % STAGES: K1, K2, VH, VL of each sub-tile (one
// lane; a sub-tile wholly past T reads TMA's zeros)
__device__ __forceinline__ void load_tile(Smem& sm, const Maps& maps, int j,
                                          int bh) {
  const int s = j % STAGES;
  mbar_expect_tx(&sm.full[s], KT * 4 * TILE_BYTES);
  for (int h = 0; h < KT; ++h)
    for (int t = 0; t < 4; ++t)
      tma_load(sm.ring[s][h][t], &maps.m[K1 + t], &sm.full[s],
               j * BK + h * 64, bh);
}

// One consumer warpgroup: 64 query rows against every key tile. O is
// m64n16: columns 8n + c2 + {0, 1} (n = 0, 1) in o[4n], o[4n + 1] (row
// r0) and o[4n + 2], o[4n + 3] (row r1); column 8, the row sum of P, in
// o[4] and o[6] of the lanes with c2 = 0. Sub-tile h of a key tile holds
// its keys 64 h + 8 (i / 4) + c2 + (i & 1) in sc[h][i].
__device__ __forceinline__ void consume(Smem& sm, const Maps& maps, int wg,
                                        float* out, float* lse, int T,
                                        float scale_log2, int bh, int q0,
                                        int nk) {
  constexpr int MN = Head<16>::MN_STEP;
  constexpr uint32_t PART = TILE_BYTES >> 4;  // a tile, descriptor units
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  float o[8], pv[8], sc[KT][32];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = pv[i] = 0.f;
#pragma unroll
  for (int h = 0; h < KT; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[h][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  uint32_t ph[KT][16], pl[KT][16];  // P's hi and lo as m64k16 A fragments

  mbar_wait(&sm.qbar, 0);
  const uint32_t qd = (uint32_t)sw_desc<16>(sm.q[wg]);
  const uint32_t ring = (uint32_t)sw_desc<16>(sm.ring[0][0][0]);
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    const uint32_t slot = ring + KT * 4 * PART * s;
    mbar_wait(&sm.full[s], (j / STAGES) & 1);

    // S = QP K1^T + QP K2^T: q_hi k_hi + q_lo k_hi + q_hi k_lo
#pragma unroll
    for (int h = 0; h < KT; ++h) reg_fence(sc[h]);
    wg_fence();
#pragma unroll
    for (int h = 0; h < KT; ++h) {
      const uint32_t k1 = slot + 4 * PART * h;
      wgmma_ss(sc[h], desc_at<16>(qd), desc_at<16>(k1), 0);
      wgmma_ss(sc[h], desc_at<16>(qd), desc_at<16>(k1 + PART), 1);
    }
    wg_commit();
#pragma unroll
    for (int h = 0; h < KT; ++h) reg_fence(sc[h]);
    wg_wait_all();
#pragma unroll
    for (int h = 0; h < KT; ++h) reg_fence(sc[h]);

    if (j == nk - 1 && T % BK) {  // keys >= T score -inf, not 0
      const int live = T - j * BK;
#pragma unroll
      for (int h = 0; h < KT; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (64 * h + 8 * (i / 4) + c2 + (i & 1) >= live)
            sc[h][i] = -INFINITY;
    }

    // the online softmax, two rows a thread; the row sums come from P V
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int h = 0; h < KT; ++h)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[h][4 * n], sc[h][4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[h][4 * n + 2], sc[h][4 * n + 3]));
      }
    // finite: every tile holds at least one key < T
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    const float cr0 = fast_exp2(m0 - mn0), cr1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int h = 0; h < KT; ++h)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        split_trunc(fast_exp2(fmaf(sc[h][4 * n], scale_log2, -mn0)),
                    fast_exp2(fmaf(sc[h][4 * n + 1], scale_log2, -mn0)),
                    ph[h][2 * n], pl[h][2 * n]);
        split_trunc(fast_exp2(fmaf(sc[h][4 * n + 2], scale_log2, -mn1)),
                    fast_exp2(fmaf(sc[h][4 * n + 3], scale_log2, -mn1)),
                    ph[h][2 * n + 1], pl[h][2 * n + 1]);
      }

    // the tile's P V from zero (per sub-tile hi hi, hi lo, lo hi; column
    // 8: P's row sums), then O = O corr + P V in f32
    reg_fence(pv);
#pragma unroll
    for (int h = 0; h < KT; ++h) {
      reg_fence(ph[h]);
      reg_fence(pl[h]);
    }
    wg_fence();
#pragma unroll
    for (int h = 0; h < KT; ++h) {
      const uint32_t vh = slot + 4 * PART * h + 2 * PART;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<16>(pv, ph[h][4 * kk], ph[h][4 * kk + 1], ph[h][4 * kk + 2],
                     ph[h][4 * kk + 3], desc_at<16>(vh + kk * MN), h | kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<16>(pv, ph[h][4 * kk], ph[h][4 * kk + 1], ph[h][4 * kk + 2],
                     ph[h][4 * kk + 3], desc_at<16>(vh + PART + kk * MN));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<16>(pv, pl[h][4 * kk], pl[h][4 * kk + 1], pl[h][4 * kk + 2],
                     pl[h][4 * kk + 3], desc_at<16>(vh + kk * MN));
    }
    wg_commit();
    reg_fence(pv);
    wg_wait_all();
    reg_fence(pv);
#pragma unroll
    for (int h = 0; h < KT; ++h) {
      reg_fence(ph[h]);
      reg_fence(pl[h]);
    }
    // this warp is done with slot s; the last of the CTA's warps refills
    // it with tile j + STAGES
    __syncwarp();
    if (lane == 0 && count_release(&sm.released[s]) == NWG * 4 - 1) {
      sm.released[s] = 0;
      if (j + STAGES < nk) load_tile(sm, maps, j + STAGES, bh);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      o[4 * n] = fmaf(o[4 * n], cr0, pv[4 * n]);
      o[4 * n + 1] = fmaf(o[4 * n + 1], cr0, pv[4 * n + 1]);
      o[4 * n + 2] = fmaf(o[4 * n + 2], cr1, pv[4 * n + 2]);
      o[4 * n + 3] = fmaf(o[4 * n + 3], cr1, pv[4 * n + 3]);
    }
  }

  // the row sums from column 8 (lane 4 * (lane / 4) holds it)
  const float sum0 = __shfl_sync(0xffffffffu, o[4], lane & ~3);
  const float sum1 = __shfl_sync(0xffffffffu, o[6], lane & ~3);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  const int r0 = q0 + wg * BM + warp * 16 + lane / 4, r1 = r0 + 8;
  if (lse != nullptr && lane % 4 == 0) {  // m is in log2 units of the score
    constexpr float LN2 = 0.6931471805599453f;
    if (r0 < T) lse[(size_t)bh * T + r0] = (m0 + log2f(sum0)) * LN2;
    if (r1 < T) lse[(size_t)bh * T + r1] = (m1 + log2f(sum1)) * LN2;
  }
  float* base = out + (size_t)bh * T * 8 + c2;
  if (r0 < T)
    *reinterpret_cast<float2*>(base + (size_t)r0 * 8) =
        make_float2(o[0] * inv0, o[1] * inv0);
  if (r1 < T)
    *reinterpret_cast<float2*>(base + (size_t)r1 * 8) =
        make_float2(o[2] * inv1, o[3] * inv1);
}

__global__ void __launch_bounds__(NWG * 128, MIN_CTAS)
    flash_narrow_kernel(const __grid_constant__ Maps maps,
                        float* __restrict__ out, float* __restrict__ lse,
                        int T, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SW_ATOM - 1) &
      ~uintptr_t(SW_ATOM - 1));
  const int bh = blockIdx.y, q0 = blockIdx.x * BM * NWG;
  const int nk = (T + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      sm.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the Q tiles, the first STAGES key tiles
    mbar_expect_tx(&sm.qbar, NWG * TILE_BYTES);
    for (int w = 0; w < NWG; ++w)
      tma_load(sm.q[w], &maps.m[QP], &sm.qbar, q0 + w * BM, bh);
    for (int j = 0; j < STAGES && j < nk; ++j) load_tile(sm, maps, j, bh);
  }
  consume(sm, maps, threadIdx.x / 128, out, lse, T, scale_log2, bh, q0, nk);
}

constexpr int SMEM_BYTES = (int)sizeof(Smem) + SW_ATOM;

}  // namespace

// q, k, v, out: [BH, T, 8] f32, contiguous, 16-byte aligned; split: a
// [5, BH, T, 16] bf16 scratch (16-byte aligned) for the pre-pass's QP, K1,
// K2, VH, VL; lse: [BH, T] f32 or null. Returns cudaGetLastError() of the
// first launch that fails (cudaErrorInvalidValue for a tensor map that
// cuTensorMapEncodeTiled refuses).
int flash_narrow_f32(const void* q, const void* k, const void* v, void* split,
                     void* out, void* lse, int BH, int T, float scale_log2,
                     cudaStream_t st) {
  const size_t rows = (size_t)BH * T;
  const bf16* sp = static_cast<const bf16*>(split);
  Maps maps;
  for (int t = 0; t < NPARTS; ++t)
    if (!make_map<16>(&maps.m[t], sp + t * rows * COLS, BH, T))
      return (int)cudaErrorInvalidValue;
  const unsigned gx =
      (unsigned)((rows + 255) / 256 < 132 * 8 ? (rows + 255) / 256 : 132 * 8);
  narrow_split_kernel<<<gx, 256, 0, st>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<const float4*>(v), static_cast<uint4*>(split), rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process
      flash_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((T + BM * NWG - 1) / (BM * NWG), BH);
  flash_narrow_kernel<<<grid, NWG * 128, SMEM_BYTES, st>>>(
      maps, static_cast<float*>(out), static_cast<float*>(lse), T,
      scale_log2);
  return (int)cudaGetLastError();
}

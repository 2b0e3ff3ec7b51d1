// Forward flash attention on Hopper (sm_90a) for head dimensions 8, 16,
// 32 and 64 (template instances; bf16 also 128) and every multiple of 64
// from 128 up (the wide body; bf16 from 192): wgmma for both products,
// TMA for the loads; bf16 or f32 in and out. The f32 forward at head dim
// 8 runs flash_narrow.cu's body.
//
// Replaces the TPU flash kernel that ipdm_tpu/models/unet.py:601
// _flash_attention calls (jax.experimental.pallas.ops.tpu.flash_attention)
// for self-attention over >= 4096 tokens, for bf16 and for f32 activations
// (the shipped presets' dtype, unet.py:655-657):
//
//   out[bh,t,:] = sum_s softmax_s(scale2 * q[bh,t,:] . k[bh,s,:]) v[bh,s,:]
//
// q, k, v, out: [BH, T, HD] of one element type, contiguous, HD in
// {8, 16, 32, 64} (one template instance each; hopper.cuh's Head<HD>: at
// HD = 8 the operands lie zero-padded to 16 columns in shared memory; in
// bf16 also 128, as two 64-column sub-tiles) or a multiple of 64 from
// IPDM_FLASH_FWD_WIDE_FROM_<dtype> up (the wide body, below); other head
// dims reach a kernel zero-padded by the wrapper, ops/cuda/attention.py.
// With lse !=
// nullptr (the autograd path asks for it) the kernel also writes the f32
// natural-log softmax normaliser lse[bh, t] = log(sum_s exp(scale2 * q.k))
// that the backward kernels (flash_bwd.cu) rebuild P from, the counterpart
// of the TPU kernel's saved l and m residuals. The scale is applied ONCE,
// to the f32 score: the caller passes scale2 * log2(e) with
// scale2 = (1/sqrt(sqrt(hd)))^2 = 1/sqrt(hd), the product of the two
// per-operand scales of the plain formula (unet.py:659-662, which scales
// q and k by 1/sqrt(sqrt(hd)) each in the activation dtype).
//
// The two element types:
// - bf16: the operands go to the tensor cores as they are; P is rounded to
//   bf16 for P V.
// - f32: each operand is split, x ~ hi + lo with hi = bf16(x) and
//   lo = bf16(x - hi), and each product is three bf16 passes hi*hi +
//   hi*lo + lo*hi into the same f32 sums, lo*lo dropped (hopper.cuh; the
//   scheme of flash_bwd.cu). P is split in registers the same way; the row
//   sum l and the lse come from the f32 P. TF32 wgmma would take one pass,
//   but only with K-major operands, and P V reads V transposed.
//   tests/test_torch_flash_fwd.py holds the write-out of this body to the
//   f32 rule, beside a one-pass control that misses it.
//
// What bounds it on an H100: the two products, 4*T*T*HD flops per head
// per pass (52 GFLOP at HD = 64, T = 7125 and 4 heads: 0.053 ms at the
// 989 TFLOP/s bf16 tensor-core peak; 0.158 ms for f32's three passes), and
// the T*T exp2 of the softmax on the special-function units (16 per clock
// per SM, 4.2e12/s: 0.049 ms there, as long as the bf16 products). Below
// HD = 64 the exp2 leads: at HD = 8 (the middle attention of the ablation
// UNets), T = 114 000 and 4 heads the softmax takes T*T*4 = 5.2e10 exp2,
// 12.4 ms, and the f32 products 2 * 3 * 2*T*T*8*4 = 5.0e12 flops, 5.0 ms
// (the f32 forward there is flash_narrow.cu's). This kernel runs HD = 8
// at 16 columns (K padded to 16 in Q K^T, N = 16 in P V): twice the
// products the function needs, a gap from the bound and not a part of
// it. The T x T score matrix never leaves the SM.
//
// Design (one CTA = 128 query rows of one head):
// - Warp 8 is the producer: one thread loads the CTA's Q tiles once and
//   then walks the 64-key tiles of K and V through a ring of STAGES
//   shared-memory slots with TMA (3-D tensor maps [BH, T, HD] with the
//   swizzle of the tile's row bytes; rows past T arrive as zeros). Each slot has a full
//   mbarrier (TMA's transaction count) and an empty one (one arrival per
//   consumer warp), so up to STAGES tiles are in flight while the tensor
//   cores work.
// - f32: split_kernel first writes hi and lo of Q, K and V once into a
//   bf16 scratch tensor (as many bytes as the f32 inputs, ~13 us at
//   T = 7125), so the main kernel TMA-loads bf16 hi and lo tiles exactly
//   as the bf16 body loads its tiles, and no thread splits an operand in
//   the key loop. Split in the CTA instead (f32 tiles staged by TMA, split
//   by the consumers, a barrier per tile), every CTA would split all of
//   its head's K and V, as many splits as the softmax has exp2: such a
//   body took 1.48x as long at T = 7125 on an H100.
// - Warps 0-7 are two consumer warpgroups of 64 query rows each.
//   S = Q K^T is a wgmma m64n64k16 chain (three in f32) from shared memory
//   (Q and K both K-major, the swizzle of their row bytes) into 32 f32
//   registers per thread. The online softmax runs on those registers: a
//   thread holds 16 scores of two rows, the row max and sum are reduced
//   over the quad of lanes that shares a row, exp2 takes the scale folded
//   into one FMA, and keys >= T in the last tile are set to -inf (a
//   zero-filled key would score 0, not -inf). P goes in place into the
//   wgmma A-fragment layout (the m64n64 accumulator layout is the m64k16
//   A layout, tile by tile), rounded to bf16 or split into hi and lo, and P V is a register-A
//   wgmma chain (three in f32) with V read from shared memory as an
//   MN-major (transposed) operand. O is rescaled in registers; bf16 sums
//   P V onto it in the tensor cores, f32 sums each tile's P V from zero
//   and adds it to O with an f32 FMA (the tensor cores' f32 sums do not
//   round to nearest: chained over all key tiles they bias out). S, P and
//   O never touch shared memory.
// - The overlap of the softmax's exp2 with the tensor cores comes from
//   the other warpgroup of the CTA and, in bf16, the second CTA on the SM:
//   while one warpgroup waits on its wgmma chain, the others run their
//   softmax.
// - Waves: 128-row CTAs give 56 x 4 = 224 CTAs at T = 7125 and 128 at
//   T = 4096. bf16: 4 ring slots, ~83 KB of shared memory, two CTAs on
//   each of the 132 SMs at at most 112 registers a thread
//   (__launch_bounds__(288, 2); the body takes 94), so every CTA of both
//   shapes is resident at once. f32: 4 slots of hi and lo tiles, ~161 KB,
//   one CTA per SM at at most 168 registers: beside O and P's two fragment
//   sets the zeroed P V sum does not fit in 112 (at two CTAs per SM it
//   spilled and took 1.16x / 1.30x as long at T = 7125 / 4096 on an H100;
//   2 slots at two CTAs ran as fast as this before that sum, with no
//   spill). 128 rows rather than 64 halve the K/V traffic from L2 (each
//   CTA reads all of its head's K and V).
// - HD = 128 in bf16 (no main path: the presets are f32): Q, K and V
//   tiles are two 128-byte-swizzled sub-tiles each (two TMA boxes a tile),
//   Q K^T steps into the second after four k16 steps, and P V runs as two
//   N = 64 halves onto O's two halves of 32 sums; 4 slots, 160 KB, one
//   CTA per SM, 167 registers. It stays because the wide body is slower
//   there: 0.3114-0.3162 ms against its 0.2455-0.2466 at T = 7125, 4
//   heads (NVIDIA H100 80GB HBM3, 700 W; scripts/torch_kernels_ab.py).
//   The f32 instance it had (2 slots, 408 B spilled a thread at 168
//   registers) is gone: the wide body runs f32 from 128 up.
// - From 128 (f32) / 192 (bf16) up: the wide body (flash_wide_kernel,
//   below) takes the head dim as a runtime count nc of 64-column chunks.
//   A CTA holds 128 query rows and up to 256 columns of O, so up to
//   hd 256 it builds S once per key tile for all of O: 2 products of the
//   2 the function has (its first body built S once per 64-column
//   slice, nc + 1), and above 256 once per 256-column slice (hd 512: 3).
//   O at 256 columns is 128 f32 registers a thread; with the scores, P's
//   two fragment sets and addressing the consumers need ~210, so the
//   producer is a warpgroup that gives its registers back (setmaxnreg:
//   producer 24, consumers 240). Bound at hd 256, T = 7125, 4 heads: the
//   products, 4*T*T*256*4 flops, 0.210 ms at the bf16 peak, 0.631 ms for
//   f32's three passes. Measured there (NVIDIA H100 80GB HBM3, 700 W;
//   scripts/torch_kernels_ab.py --parent): f32 0.962 ms (the first body
//   2.745), bf16 0.483 (SDPA 0.782); hd 512, f32 3.39-3.49 (10.1-10.2);
//   hd 128, f32 0.543 (the retired instance 0.697). 168 registers at
//   launch, no spill (scripts/ptxas_report.py).
// The TPU kernel's 512/1024 blocks and segment-id padding (unet.py:611-
// 630) are VMEM tiling and do not carry over: keys past T are masked to
// -inf, queries past T are not written.
#include <type_traits>

#include "hopper.cuh"

// the f32 forward at head dim 8 (flash_narrow.cu)
int flash_narrow_f32(const void* q, const void* k, const void* v, void* split,
                     void* out, void* lse, int BH, int T, float scale_log2,
                     cudaStream_t st);

namespace {

using namespace ipdm::hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;                     // query rows per warpgroup
constexpr int NWG = 2;                     // consumer warpgroups per CTA
constexpr int BQ = BM * NWG;               // query rows per CTA
constexpr int BK = 64;                     // keys per tile
constexpr int NTHREADS = NWG * 128 + 32;   // + the producer warp
// elements of a 64-row bf16 tile (8 KB at HD = 64)
template <int HD>
constexpr int TILE = 64 * Head<HD>::HDP;
template <int HD>
constexpr int TILE_BYTES = TILE<HD> * 2;

template <bool F32>
using Out = std::conditional_t<F32, float, bf16>;

// Shared memory: the Q tiles and a ring of K and V tiles, each operand
// one bf16 tile (bf16) or two, hi and lo (f32); every tile is 1024-byte
// aligned (swizzle atoms)
template <bool F32, int HD>
struct Smem {
  static constexpr int STAGES = 4;  // ring slots
  static constexpr int NP = F32 ? 2 : 1;      // [hi, lo]
  bf16 q[NWG][NP][TILE<HD>];
  bf16 k[STAGES][NP][TILE<HD>];
  bf16 v[STAGES][NP][TILE<HD>];
  uint64_t qbar;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// the tensor maps of Q, K and V: [hi, lo] of the split operands in f32,
// part 0 alone in bf16
struct Maps {
  CUtensorMap q[2], k[2], v[2];
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// o = o corr + P V for one key tile (f32 body): P V summed from zero in
// pv, then added to the rescaled o with an f32 FMA
// (o and pv: one sub-tile's N = SUB sums; vH, vL: that sub-tile of V)
template <int NP, int HD>
__device__ __forceinline__ void add_pv(float (&o)[Head<HD>::SUB / 2],
                                       float (&pv)[Head<HD>::SUB / 2],
                                       uint32_t (&p)[NP][16],
                                       float cr0, float cr1, uint64_t vH,
                                       uint64_t vL) {
  constexpr int HDP = Head<HD>::SUB;
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) pv[i] = 0.f;
  reg_fence(pv);
  reg_fence_a(p);
  wg_fence();
  product_rs<NP, HD>(pv, p, vH, vL);
  wg_commit();
  reg_fence(pv);
  wg_wait_all();
  reg_fence(pv);
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
    o[4 * n] = fmaf(o[4 * n], cr0, pv[4 * n]);
    o[4 * n + 1] = fmaf(o[4 * n + 1], cr0, pv[4 * n + 1]);
    o[4 * n + 2] = fmaf(o[4 * n + 2], cr1, pv[4 * n + 2]);
    o[4 * n + 3] = fmaf(o[4 * n + 3], cr1, pv[4 * n + 3]);
  }
}

// The wide body's steps of one key tile (consume_wide), the same
// arithmetic as consume's above, which keeps its own inline copy: routed
// through these helpers, the template's bf16 head-dim-64 forward kept its
// bits but ran 9% slower at T = 4096 on an H100
// (scripts/torch_kernels_ab.py).

// The online softmax of one key tile on one warpgroup's registers: sc
// holds the tile's scores (keys >= T already -inf); the rows' running max
// m0, m1 (log2 units of the scaled score) and the thread's partial row
// sums l0, l1 are updated, O's rescale factors come back in cr0, cr1, and
// P goes into the register-A fragments p (p[.][4kk .. 4kk+3] is the
// m64k16 fragment of keys 16kk ..): rounded to bf16 (NP = 1) or split
// into hi and lo (NP = 2). A thread holds 16 scores of two rows; the row
// max and sum are reduced over the quad of lanes that shares a row.
template <int NP>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float scale_log2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, uint32_t (&p)[NP][16],
                                             float& cr0, float& cr1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  // finite: every tile holds at least one key < T
  const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
  const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
  cr0 = fast_exp2(m0 - mn0);
  cr1 = fast_exp2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float p00 = fast_exp2(fmaf(sc[4 * n], scale_log2, -mn0));
    const float p01 = fast_exp2(fmaf(sc[4 * n + 1], scale_log2, -mn0));
    const float p10 = fast_exp2(fmaf(sc[4 * n + 2], scale_log2, -mn1));
    const float p11 = fast_exp2(fmaf(sc[4 * n + 3], scale_log2, -mn1));
    sum0 += p00 + p01;
    sum1 += p10 + p11;
    if constexpr (NP == 2) {
      split2(p00, p01, p[0][2 * n], p[1][2 * n]);
      split2(p10, p11, p[0][2 * n + 1], p[1][2 * n + 1]);
    } else {
      p[0][2 * n] = pack_bf16(p00, p01);
      p[0][2 * n + 1] = pack_bf16(p10, p11);
    }
  }
  l0 = l0 * cr0 + sum0;  // per-thread partial sums, reduced at the end
  l1 = l1 * cr1 + sum1;
}

// The rows' lse (where lse != nullptr; m is in log2 units of the score)
// and O / l: NCOLS columns of rows r0, r0 + 8 at out (column 0 of row 0;
// ld elements a row). Rows >= T are not written.
template <bool F32, int NCOLS, int NO>
__device__ __forceinline__ void finish(const float (&o)[NO], float m0,
                                       float m1, float l0, float l1,
                                       Out<F32>* out, size_t ld, float* lse,
                                       int r0, int T) {
  const int lane = threadIdx.x % 32, c2 = (lane % 4) * 2, r1 = r0 + 8;
  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  if (lse != nullptr && lane % 4 == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    if (r0 < T) lse[r0] = (m0 + log2f(sum0)) * LN2;
    if (r1 < T) lse[r1] = (m1 + log2f(sum1)) * LN2;
  }
#pragma unroll
  for (int n = 0; n < NCOLS / 8; ++n) {  // the pad columns are not written
    const int col = 8 * n + c2;
    if constexpr (F32) {
      if (r0 < T)
        *reinterpret_cast<float2*>(out + (size_t)r0 * ld + col) =
            make_float2(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (r1 < T)
        *reinterpret_cast<float2*>(out + (size_t)r1 * ld + col) =
            make_float2(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    } else {
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(out + (size_t)r0 * ld + col) =
            pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(out + (size_t)r1 * ld + col) =
            pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// keys >= T of the last key tile score -inf, not 0 (a zero-filled key)
__device__ __forceinline__ void mask_keys(float (&sc)[32], int live) {
  const int c2 = (threadIdx.x % 4) * 2;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (8 * (i / 4) + c2 + (i & 1) >= live) sc[i] = -INFINITY;
}

// One consumer warpgroup: 64 query rows against every key tile.
// Accumulator layout (m64nN f32): warp w of the group holds rows
// 16w + lane/4 (registers 4n, 4n+1) and 16w + lane/4 + 8 (4n+2, 4n+3), at
// columns 8n + 2*(lane%4) + {0, 1}, n = 0..7.
// O is m64nHDP: HDP / 2 sums a thread, columns 8n + c2 + {0, 1} for
// n < HDP / 8.
template <bool F32, int HD>
__device__ __forceinline__ void consume(Smem<F32, HD>& sm, int wg,
                                        Out<F32>* out, float* lse, int T,
                                        float scale_log2, int bh, int q0,
                                        int nk) {
  using S = Smem<F32, HD>;
  constexpr int STAGES = S::STAGES, NP = S::NP;
  constexpr int HDP = Head<HD>::HDP, NO = HDP / 2;
  constexpr int SUB = Head<HD>::SUB, NSUB = Head<HD>::NSUB;
  constexpr int SU = Head<HD>::SUB_UNITS;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(&sm.qbar, 0);
  const uint64_t qH = sw_desc<HD>(sm.q[wg][0]);
  const uint64_t qL = sw_desc<HD>(sm.q[wg][NP - 1]);
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    mbar_wait(&sm.full[s], (j / STAGES) & 1);
    const uint64_t kH = sw_desc<HD>(sm.k[s][0]);
    const uint64_t kL = sw_desc<HD>(sm.k[s][NP - 1]);
    const uint64_t vH = sw_desc<HD>(sm.v[s][0]);
    const uint64_t vL = sw_desc<HD>(sm.v[s][NP - 1]);

    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    reg_fence(sc);
    wg_fence();
    product_ss<F32, HD>(sc, qH, qL, kH, kL);
    wg_commit();
    reg_fence(sc);
    wg_wait_all();
    reg_fence(sc);

    if (j == nk - 1 && T % BK) {  // keys >= T score -inf, not 0
      const int live = T - j * BK;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i / 4) + c2 + (i & 1) >= live) sc[i] = -INFINITY;
    }

    // online softmax on the registers, two rows per thread
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    // finite: every tile holds at least one key < T
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    const float cr0 = fast_exp2(m0 - mn0), cr1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    uint32_t p[NP][16];  // P as m64k16 A fragments: p[.][4kk .. 4kk+3]
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p00 = fast_exp2(fmaf(sc[4 * n], scale_log2, -mn0));
      const float p01 = fast_exp2(fmaf(sc[4 * n + 1], scale_log2, -mn0));
      const float p10 = fast_exp2(fmaf(sc[4 * n + 2], scale_log2, -mn1));
      const float p11 = fast_exp2(fmaf(sc[4 * n + 3], scale_log2, -mn1));
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      if constexpr (F32) {
        split2(p00, p01, p[0][2 * n], p[NP - 1][2 * n]);
        split2(p10, p11, p[0][2 * n + 1], p[NP - 1][2 * n + 1]);
      } else {
        p[0][2 * n] = pack_bf16(p00, p01);
        p[0][2 * n + 1] = pack_bf16(p10, p11);
      }
    }
    l0 = l0 * cr0 + sum0;  // per-thread partial sums, reduced at the end
    l1 = l1 * cr1 + sum1;

    if constexpr (F32) {
      // O = O corr + P V, the tile's P V summed from zero (at N = 64 in
      // sc, dead now; one sub-tile of V at a time): the tensor cores' f32
      // sums do not round to nearest, and P V onto O over every key tile
      // (terms of one sign) left out ~4e-5 low at T = 4097, which D
      // carries into the backward's cancelling dQ
#pragma unroll
      for (int h = 0; h < NSUB; ++h) {
        if constexpr (SUB == 64) {
          add_pv<NP, HD>(sub_of<HD>(o, h), sc, p, cr0, cr1, vH + h * SU,
                         vL + h * SU);
        } else {
          float pv[SUB / 2];
          add_pv<NP, HD>(sub_of<HD>(o, h), pv, p, cr0, cr1, vH + h * SU,
                         vL + h * SU);
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        o[4 * n] *= cr0;
        o[4 * n + 1] *= cr0;
        o[4 * n + 2] *= cr1;
        o[4 * n + 3] *= cr1;
      }

      // O += P V, one sub-tile of V at a time
      reg_fence(o);
      reg_fence_a(p);
      wg_fence();
#pragma unroll
      for (int h = 0; h < NSUB; ++h)
        product_rs<NP, HD>(sub_of<HD>(o, h), p, vH + h * SU, vL + h * SU);
      wg_commit();
      reg_fence(o);
      wg_wait_all();
      reg_fence(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);  // this warp is done with s
  }

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  const int r0 = q0 + wg * BM + warp * 16 + lane / 4, r1 = r0 + 8;
  if (lse != nullptr && lane % 4 == 0) {  // m is in log2 units of the score
    constexpr float LN2 = 0.6931471805599453f;
    if (r0 < T) lse[(size_t)bh * T + r0] = (m0 + log2f(sum0)) * LN2;
    if (r1 < T) lse[(size_t)bh * T + r1] = (m1 + log2f(sum1)) * LN2;
  }
  Out<F32>* base = out + (size_t)bh * T * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {  // the pad columns are not written
    const int col = 8 * n + c2;
    if constexpr (F32) {
      if (r0 < T)
        *reinterpret_cast<float2*>(base + (size_t)r0 * HD + col) =
            make_float2(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (r1 < T)
        *reinterpret_cast<float2*>(base + (size_t)r1 * HD + col) =
            make_float2(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    } else {
      if (r0 < T)
        *reinterpret_cast<uint32_t*>(base + (size_t)r0 * HD + col) =
            pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      if (r1 < T)
        *reinterpret_cast<uint32_t*>(base + (size_t)r1 * HD + col) =
            pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

template <bool F32, int HD>
__global__ void __launch_bounds__(NTHREADS, F32 || HD == 128 ? 1 : 2)
    flash_attn_kernel(const __grid_constant__ Maps maps,
                      Out<F32>* __restrict__ out, float* __restrict__ lse,
                      int T, float scale_log2) {
  using S = Smem<F32, HD>;
  constexpr int STAGES = S::STAGES, NP = S::NP;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SW_ATOM - 1) &
      ~uintptr_t(SW_ATOM - 1));
  const int warp = threadIdx.x / 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int nk = (T + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(&sm.qbar, NWG * NP * TILE_BYTES<HD>);
      for (int w = 0; w < NWG; ++w)
        for (int p = 0; p < NP; ++p)
          tma_tile<HD>(sm.q[w][p], &maps.q[p], &sm.qbar, q0 + w * BM, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        mbar_wait(&sm.empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * NP * TILE_BYTES<HD>);
        for (int p = 0; p < NP; ++p) {
          tma_tile<HD>(sm.k[s][p], &maps.k[p], &sm.full[s], j * BK, bh);
          tma_tile<HD>(sm.v[s][p], &maps.v[p], &sm.full[s], j * BK, bh);
        }
      }
    }
  } else {
    consume<F32, HD>(sm, warp / 4, out, lse, T, scale_log2, bh, q0, nk);
  }
}

// The wide body: every head dim from IPDM_FLASH_FWD_WIDE_FROM_<dtype> up
// (f32 128, bf16 192),
// as hdw = WIDE_CHUNK * nc columns, nc a runtime count of 64-column chunks
// (the wrapper zero-pads the head dim to a multiple of 64). A CTA owns
// W_ROWS = 64 * W_NWG query rows of one head (a consumer warpgroup of 64
// each) and W_SLICE chunks of O's columns, slice z = blockIdx.z: at
// W_SLICE = 4, 256 columns, so up to hd 256 one CTA builds S once per key
// tile for every column of O; above, ceil(nc / 4) slices (hd 320 and 448
// end on a partial slice), S built once per slice. O is W_SLICE m64n64
// accumulators a thread, 128 f32 registers at 256 columns: beside the
// scores (32), P's hi and lo fragments (32) and addressing that is ~210,
// so the producer is a whole warpgroup that gives its registers back
// (setmaxnreg: 24 a thread) and the consumers rise to W_CREGS (240):
// 128 * 24 + 256 * 240 = 64 512 of the SM's 65 536.
// Shared memory: where Q's nc chunks fit in 128 KB (nc <= QCH: f32 hi and
// lo up to hd 256, bf16 up to 512) they are resident, one TMA load a CTA,
// and the ring carries 64-key tiles of K's chunk c (nc steps a key tile,
// whose products sum S over the head dim) then of V's chunk c0 + h (nz
// steps, one per output chunk); f32 5 slots of 16 KB beside Q's 128 KB,
// bf16 8 of 8 KB. Above QCH every K step carries Q's chunk c of the CTA's
// rows too (re-read from L2 each key tile), 4 slots. f32 keeps the
// template's rule: three bf16 passes, each key tile's P V summed from
// zero per chunk and added to O with an f32 FMA; bf16 sums P V onto O in
// the tensor cores, every output chunk's wgmmas in one group.
#ifndef IPDM_WIDE_SLICE
#define IPDM_WIDE_SLICE 4        // 64-column chunks of O a CTA holds
#endif
#ifndef IPDM_WIDE_NWG
#define IPDM_WIDE_NWG 2          // consumer warpgroups a CTA (64 rows each)
#endif
#ifndef IPDM_WIDE_STAGES_F32
#define IPDM_WIDE_STAGES_F32 5   // ring slots beside a resident Q, f32
#endif
#ifndef IPDM_WIDE_STAGES_BF16
#define IPDM_WIDE_STAGES_BF16 8  // the same, bf16
#endif
#ifndef IPDM_WIDE_CREGS
#define IPDM_WIDE_CREGS 240      // the consumers' registers a thread
#endif
constexpr int W_SLICE = IPDM_WIDE_SLICE;
constexpr int W_NWG = IPDM_WIDE_NWG;
constexpr int W_ROWS = BM * W_NWG;
constexpr int W_THREADS = 128 * (W_NWG + 1);
// the registers a thread at launch (__launch_bounds__(W_THREADS, 1): the
// SM's 65 536 over the threads, in steps of 8, at most 255), the
// consumers' count after setmaxnreg.inc, and the producer's after .dec:
// what the consumers' increase leaves of the launch's registers
constexpr int W_LREGS = 65536 / W_THREADS / 8 * 8 > 255
                            ? 255 : 65536 / W_THREADS / 8 * 8;
constexpr int W_CREGS = IPDM_WIDE_CREGS;
constexpr int W_PREGS = (W_LREGS - (W_CREGS - W_LREGS) * W_NWG) / 8 * 8;
static_assert(W_SLICE >= 1 && W_SLICE <= 4 && (W_NWG == 1 || W_NWG == 2),
              "wide body: 1-4 output chunks, 1 or 2 consumer warpgroups");
static_assert(W_NWG == 1 || (W_PREGS >= 24 && W_CREGS % 8 == 0 &&
                             W_CREGS <= 256 && W_CREGS >= W_LREGS),
              "wide body: the register split does not fit the SM");

template <bool F32, bool QRES>
struct WideSmem;

// Q resident: its nc <= QCH chunks of the CTA's rows (128 KB at most),
// and a ring of K's and V's 64-key chunk tiles
template <bool F32>
struct WideSmem<F32, true> {
  static constexpr int NP = F32 ? 2 : 1;  // [hi, lo]
  static constexpr int QCH = 16 / (W_NWG * NP);
  static constexpr int STAGES =
      F32 ? IPDM_WIDE_STAGES_F32 : IPDM_WIDE_STAGES_BF16;
  bf16 q[QCH][W_NWG][NP][TILE<64>];
  struct Slot {
    bf16 kv[NP][TILE<64>];
  } slot[STAGES];
  uint64_t qbar;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// Q streamed: a K step's slot carries Q's chunk c of the CTA's rows too
template <bool F32>
struct WideSmem<F32, false> {
  static constexpr int NP = F32 ? 2 : 1;
  static constexpr int STAGES = 4;
  struct Slot {
    bf16 q[W_NWG][NP][TILE<64>];
    bf16 kv[NP][TILE<64>];
  } slot[STAGES];
  uint64_t qbar;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// this warp is done with slot s
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty);
}

// the next ring slot (s) and the parity (ph) of its next phase
template <int STAGES>
__device__ __forceinline__ void advance(int& s, uint32_t& ph) {
  if (++s == STAGES) {
    s = 0;
    ph ^= 1;
  }
}

// The producer: one thread loads Q once (resident) and walks the ring:
// for each key tile, nc steps of K's chunk c (with Q's chunk c where Q is
// streamed), then nz steps of V's chunk c0 + h
template <bool F32, bool QRES>
__device__ __forceinline__ void produce_wide(WideSmem<F32, QRES>& sm,
                                             const Maps& maps, int nc,
                                             int c0, int nz, int bh, int q0,
                                             int nk) {
  using S = WideSmem<F32, QRES>;
  constexpr int STAGES = S::STAGES, NP = S::NP;
  constexpr uint32_t TB = TILE_BYTES<64>;
  constexpr int QT = QRES ? 0 : W_NWG;  // Q tiles a K step carries
  if constexpr (QRES) {
    mbar_expect_tx(&sm.qbar, nc * W_NWG * NP * TB);
    for (int c = 0; c < nc; ++c)
      for (int w = 0; w < W_NWG; ++w)
        for (int p = 0; p < NP; ++p)
          tma_load(sm.q[c][w][p], &maps.q[p], &sm.qbar, q0 + w * BM, bh,
                   c * WIDE_CHUNK);
  }
  int s = 0;
  uint32_t ph = 1;  // a fresh barrier's previous phase counts as complete
  for (int j = 0; j < nk; ++j) {
    for (int c = 0; c < nc + nz; ++c) {
      auto& sl = sm.slot[s];
      mbar_wait(&sm.empty[s], ph);
      if (c < nc) {
        mbar_expect_tx(&sm.full[s], (QT + 1) * NP * TB);
        for (int p = 0; p < NP; ++p) {
          if constexpr (!QRES)
            for (int w = 0; w < W_NWG; ++w)
              tma_load(sl.q[w][p], &maps.q[p], &sm.full[s], q0 + w * BM, bh,
                       c * WIDE_CHUNK);
          tma_load(sl.kv[p], &maps.k[p], &sm.full[s], j * BK, bh,
                   c * WIDE_CHUNK);
        }
      } else {
        mbar_expect_tx(&sm.full[s], NP * TB);
        for (int p = 0; p < NP; ++p)
          tma_load(sl.kv[p], &maps.v[p], &sm.full[s], j * BK, bh,
                   (c0 + c - nc) * WIDE_CHUNK);
      }
      advance<STAGES>(s, ph);
    }
  }
}

// One consumer warpgroup: 64 query rows, O's nz <= W_SLICE chunks from
// column chunk c0, against every key tile
template <bool F32, bool QRES>
__device__ __forceinline__ void consume_wide(WideSmem<F32, QRES>& sm,
                                             int wg, Out<F32>* out,
                                             float* lse, int T, int nc,
                                             int c0, int nz,
                                             float scale_log2, int bh,
                                             int q0, int nk) {
  using S = WideSmem<F32, QRES>;
  constexpr int STAGES = S::STAGES, NP = S::NP;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float o[W_SLICE][32];
#pragma unroll
  for (int h = 0; h < W_SLICE; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[h][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if constexpr (QRES) mbar_wait(&sm.qbar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int j = 0; j < nk; ++j) {
    // S = Q K^T, summed over the nc chunks of the head dimension; a
    // chunk's slot is released once the next chunk's products are issued
    // and its own have completed
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    reg_fence(sc);
    int prev = 0;
    for (int c = 0; c < nc; ++c) {
      mbar_wait(&sm.full[s], ph);
      const auto& sl = sm.slot[s];
      const bf16(*qt)[TILE<64>];
      if constexpr (QRES)
        qt = sm.q[c][wg];
      else
        qt = sl.q[wg];
      wg_fence();
      product_ss<F32, 64>(sc, sw_desc<64>(qt[0]), sw_desc<64>(qt[NP - 1]),
                          sw_desc<64>(sl.kv[0]), sw_desc<64>(sl.kv[NP - 1]),
                          c > 0);
      wg_commit();
      reg_fence(sc);
      if (c > 0) {
        wg_wait<1>();
        release(&sm.empty[prev]);
      }
      prev = s;
      advance<STAGES>(s, ph);
    }
    wg_wait_all();
    reg_fence(sc);
    release(&sm.empty[prev]);

    if (j == nk - 1 && T % BK) mask_keys(sc, T - j * BK);
    uint32_t p[NP][16];
    float cr0, cr1;
    softmax_tile<NP>(sc, scale_log2, m0, m1, l0, l1, p, cr0, cr1);

    // O = O corr + P V over V's chunks c0 .. c0 + nz - 1
    if constexpr (F32) {  // each chunk's P V from zero in sc (dead after
                          // the softmax), added with an f32 FMA
#pragma unroll
      for (int h = 0; h < W_SLICE; ++h) {
        if (h < nz) {
          mbar_wait(&sm.full[s], ph);
          add_pv<NP, 64>(o[h], sc, p, cr0, cr1,
                         sw_desc<64>(sm.slot[s].kv[0]),
                         sw_desc<64>(sm.slot[s].kv[1]));
          release(&sm.empty[s]);
          advance<STAGES>(s, ph);
        }
      }
    } else {  // every chunk's wgmmas onto O in one group
      int s1 = s;
      uint32_t ph1 = ph;
#pragma unroll
      for (int h = 0; h < W_SLICE; ++h) {
        if (h < nz) {
          mbar_wait(&sm.full[s1], ph1);
          advance<STAGES>(s1, ph1);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            o[h][4 * n] *= cr0;
            o[h][4 * n + 1] *= cr0;
            o[h][4 * n + 2] *= cr1;
            o[h][4 * n + 3] *= cr1;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < W_SLICE; ++h) reg_fence(o[h]);
      reg_fence_a(p);
      wg_fence();
      s1 = s;
#pragma unroll
      for (int h = 0; h < W_SLICE; ++h) {
        if (h < nz) {
          const uint64_t vd = sw_desc<64>(sm.slot[s1].kv[0]);
          product_rs<1, 64>(o[h], p, vd, vd);
          s1 = s1 + 1 == STAGES ? 0 : s1 + 1;
        }
      }
      wg_commit();
#pragma unroll
      for (int h = 0; h < W_SLICE; ++h) reg_fence(o[h]);
      wg_wait_all();
#pragma unroll
      for (int h = 0; h < W_SLICE; ++h) reg_fence(o[h]);
#pragma unroll
      for (int h = 0; h < W_SLICE; ++h) {
        if (h < nz) {
          release(&sm.empty[s]);
          advance<STAGES>(s, ph);
        }
      }
    }
  }

  const int hdw = nc * WIDE_CHUNK;
  const int r0 = q0 + wg * BM + warp * 16 + lane / 4;
  Out<F32>* base = out + (size_t)bh * T * hdw + c0 * WIDE_CHUNK;
#pragma unroll
  for (int h = 0; h < W_SLICE; ++h)
    if (h < nz)
      finish<F32, WIDE_CHUNK>(
          o[h], m0, m1, l0, l1, base + h * WIDE_CHUNK, hdw,
          lse == nullptr || c0 || h ? nullptr : lse + (size_t)bh * T, r0,
          T);
}

template <bool F32, bool QRES>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_wide_kernel(const __grid_constant__ Maps maps,
                      Out<F32>* __restrict__ out, float* __restrict__ lse,
                      int T, int nc, float scale_log2) {
  using S = WideSmem<F32, QRES>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SW_ATOM - 1) &
      ~uintptr_t(SW_ATOM - 1));
  const int bh = blockIdx.y, q0 = blockIdx.x * W_ROWS;
  const int c0 = blockIdx.z * W_SLICE;
  const int nz = min(W_SLICE, nc - c0);  // O's chunks in this slice
  const int nk = (T + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(&sm.qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], W_NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one branch a role to the end, on a warp-uniform role, the consumers'
  // first: with the producer's branch first, ptxas allocated the
  // consumers' code within the launch's 168 registers, not setmaxnreg's
  // 240 (~500 B spilled a thread; the mbarrier waits' trap, which both
  // roles reach, was the other change that lifted it)
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role < W_NWG) {
    if constexpr (W_NWG > 1) regs_inc<W_CREGS>();
    consume_wide<F32, QRES>(sm, role, out, lse, T, nc, c0, nz, scale_log2,
                            bh, q0, nk);
  } else {  // the producer warpgroup
    if constexpr (W_NWG > 1) regs_dec<W_PREGS>();
    if (threadIdx.x == W_NWG * 128)
      produce_wide<F32, QRES>(sm, maps, nc, c0, nz, bh, q0, nk);
  }
}

template <bool F32, bool QRES>
int launch_wide_body(const Maps& maps, void* out, void* lse, int BH, int T,
                     int nc, float scale_log2, cudaStream_t st) {
  constexpr int SMEM_BYTES = (int)sizeof(WideSmem<F32, QRES>) + SW_ATOM;
  static_assert(SMEM_BYTES <= 232448, "wide body: over 227 KB of shared "
                                      "memory");
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wide_kernel<F32, QRES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((T + W_ROWS - 1) / W_ROWS, BH, (nc + W_SLICE - 1) / W_SLICE);
  flash_wide_kernel<F32, QRES><<<grid, W_THREADS, SMEM_BYTES, st>>>(
      maps, static_cast<Out<F32>*>(out), static_cast<float*>(lse), T, nc,
      scale_log2);
  return (int)cudaGetLastError();
}

template <bool F32>
int launch_wide(const Maps& maps, void* out, void* lse, int BH, int T,
                int hdw, float scale_log2, cudaStream_t st) {
  const int nc = hdw / WIDE_CHUNK;
  return nc <= WideSmem<F32, true>::QCH
             ? launch_wide_body<F32, true>(maps, out, lse, BH, T, nc,
                                           scale_log2, st)
             : launch_wide_body<F32, false>(maps, out, lse, BH, T, nc,
                                            scale_log2, st);
}

// a head dim the wide body runs: from IPDM_FLASH_FWD_WIDE_FROM_<dtype>
// up, whole chunks
inline bool wide_hd(int hd, bool f32) {
  return hd >= (f32 ? IPDM_FLASH_FWD_WIDE_FROM_F32
                    : IPDM_FLASH_FWD_WIDE_FROM_BF16) &&
         hd % WIDE_CHUNK == 0;
}

int forward_wide_bf16(const void* q, const void* k, const void* v, void* out,
                      void* lse, int BH, int T, int hdw, float scale_log2,
                      cudaStream_t st) {
  Maps maps;
  if (!make_map_wide(&maps.q[0], q, BH, T, hdw) ||
      !make_map_wide(&maps.k[0], k, BH, T, hdw) ||
      !make_map_wide(&maps.v[0], v, BH, T, hdw))
    return (int)cudaErrorInvalidValue;
  return launch_wide<false>(maps, out, lse, BH, T, hdw, scale_log2, st);
}

int forward_wide_f32(const void* q, const void* k, const void* v, void* split,
                     void* out, void* lse, int BH, int T, int hdw,
                     float scale_log2, cudaStream_t st) {
  const size_t n = (size_t)BH * T * hdw;
  const bf16* sp = static_cast<const bf16*>(split);
  Maps maps;
  for (int p = 0; p < 2; ++p)
    if (!make_map_wide(&maps.q[p], sp + p * n, BH, T, hdw) ||
        !make_map_wide(&maps.k[p], sp + (2 + p) * n, BH, T, hdw) ||
        !make_map_wide(&maps.v[p], sp + (4 + p) * n, BH, T, hdw))
      return (int)cudaErrorInvalidValue;
  const void* src[3] = {q, k, v};
  const int e = split_launch(src, 3, split, n, st);
  if (e != 0) return e;
  return launch_wide<true>(maps, out, lse, BH, T, hdw, scale_log2, st);
}

template <bool F32, int HD>
int launch(const Maps& maps, void* out, void* lse, int BH, int T,
           float scale_log2, cudaStream_t st) {
  constexpr int SMEM_BYTES = (int)sizeof(Smem<F32, HD>) + SW_ATOM;
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<F32, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((T + BQ - 1) / BQ, BH);
  flash_attn_kernel<F32, HD><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      maps, static_cast<Out<F32>*>(out), static_cast<float*>(lse), T,
      scale_log2);
  return (int)cudaGetLastError();
}

// the bf16 maps of hi (part 0) and lo (part 1) of q, k and v in split
template <int HD>
bool split_maps(Maps* maps, const void* split, int BH, int T) {
  const size_t n = (size_t)BH * T * HD;
  const bf16* s = static_cast<const bf16*>(split);
  return make_map<HD>(&maps->q[0], s, BH, T) &&
         make_map<HD>(&maps->q[1], s + n, BH, T) &&
         make_map<HD>(&maps->k[0], s + 2 * n, BH, T) &&
         make_map<HD>(&maps->k[1], s + 3 * n, BH, T) &&
         make_map<HD>(&maps->v[0], s + 4 * n, BH, T) &&
         make_map<HD>(&maps->v[1], s + 5 * n, BH, T);
}

// the template instances stop below IPDM_FLASH_FWD_WIDE_FROM_<dtype> (the
// entry points send those head dims to the wide body first)
template <int HD>
int forward_bf16(const void* q, const void* k, const void* v, void* out,
                 void* lse, int BH, int T, float scale_log2,
                 cudaStream_t st) {
  if constexpr (HD >= IPDM_FLASH_FWD_WIDE_FROM_BF16) {
    return (int)cudaErrorInvalidValue;
  } else {
    Maps maps;
    if (!make_map<HD>(&maps.q[0], q, BH, T) ||
        !make_map<HD>(&maps.k[0], k, BH, T) ||
        !make_map<HD>(&maps.v[0], v, BH, T))
      return (int)cudaErrorInvalidValue;
    return launch<false, HD>(maps, out, lse, BH, T, scale_log2, st);
  }
}

template <int HD>
int forward_f32(const void* q, const void* k, const void* v, void* split,
                void* out, void* lse, int BH, int T, float scale_log2,
                cudaStream_t st) {
  if constexpr (HD == 8) {  // the narrow body (flash_narrow.cu)
    return flash_narrow_f32(q, k, v, split, out, lse, BH, T, scale_log2, st);
  } else if constexpr (HD >= IPDM_FLASH_FWD_WIDE_FROM_F32) {
    return (int)cudaErrorInvalidValue;
  } else {
    Maps maps;
    if (!split_maps<HD>(&maps, split, BH, T))
      return (int)cudaErrorInvalidValue;
    const void* src[3] = {q, k, v};
    const int e = split_launch(src, 3, split, (size_t)BH * T * HD, st);
    if (e != 0) return e;
    return launch<true, HD>(maps, out, lse, BH, T, scale_log2, st);
  }
}

}  // namespace

// q, k, v, out: [BH, T, hd] bf16, contiguous, 16-byte aligned, hd in
// {8, 16, 32, 64} or a multiple of 64 from 128 up (the wide body); lse:
// [BH, T] f32 or null. scale_log2 = (scale applied to q.k) * log2(e).
// Returns cudaGetLastError() (cudaErrorInvalidValue for bad sizes, another
// hd, or a tensor map that cuTensorMapEncodeTiled refuses).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int BH, int T, int hd,
                                 float scale_log2, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide_hd(hd, false))
    return forward_wide_bf16(q, k, v, out, lse, BH, T, hd, scale_log2, st);
  switch (hd) {
#define IPDM_BF16(H) \
  case H:            \
    return forward_bf16<H>(q, k, v, out, lse, BH, T, scale_log2, st);
    IPDM_FLASH_HEAD_DIMS(IPDM_BF16)
#undef IPDM_BF16
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same for f32 q, k, v, out, with split: a [6, BH, T, hd] bf16
// scratch tensor (16-byte aligned; at hd 8 the narrow body's
// [5, BH, T, 16]) that the split pre-pass fills with hi and lo of q, k and
// v before the main kernel reads them. Returns cudaGetLastError() of the
// first launch that fails.
extern "C" int flash_attn_f32_launch(const void* q, const void* k,
                                     const void* v, void* split, void* out,
                                     void* lse, int BH, int T, int hd,
                                     float scale_log2, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide_hd(hd, true))
    return forward_wide_f32(q, k, v, split, out, lse, BH, T, hd, scale_log2,
                            st);
  switch (hd) {
#define IPDM_F32(H)                                                       \
  case H:                                                                 \
    return forward_f32<H>(q, k, v, split, out, lse, BH, T, scale_log2, st);
    IPDM_FLASH_HEAD_DIMS(IPDM_F32)
#undef IPDM_F32
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Forward flash attention for head dimension 64 on Hopper (sm_90a): wgmma
// for both products, TMA for the loads; bf16 or f32 in and out.
//
// Replaces the TPU flash kernel that ipdm_tpu/models/unet.py:601
// _flash_attention calls (jax.experimental.pallas.ops.tpu.flash_attention)
// for self-attention over >= 4096 tokens, for bf16 and for f32 activations
// (the shipped presets' dtype, unet.py:655-657):
//
//   out[bh,t,:] = sum_s softmax_s(scale2 * q[bh,t,:] . k[bh,s,:]) v[bh,s,:]
//
// q, k, v, out: [BH, T, 64] of one element type, contiguous. With lse !=
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
// What bounds it on an H100: the two products, 4*T*T*64 flops per head
// per pass (52 GFLOP at T = 7125 and 4 heads: 0.053 ms at the 989 TFLOP/s
// bf16 tensor-core peak; 0.158 ms for f32's three passes), and, as long at
// head dimension 64 in bf16, the T*T exp2 of the softmax on the
// special-function units (16 per clock per SM: 0.049 ms). The T x T score
// matrix never leaves the SM.
//
// Design (one CTA = 128 query rows of one head):
// - Warp 8 is the producer: one thread loads the CTA's Q tiles once and
//   then walks the 64-key tiles of K and V through a ring of STAGES
//   shared-memory slots with TMA (3-D tensor maps [BH, T, 64] with
//   128-byte swizzle; rows past T arrive as zeros). Each slot has a full
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
//   (Q and K both K-major, 128-byte swizzle) into 32 f32 registers per
//   thread. The online softmax runs on those registers: a thread holds 16
//   scores of two rows, the row max and sum are reduced over the quad of
//   lanes that shares a row, exp2 takes the scale folded into one FMA, and
//   keys >= T in the last tile are set to -inf (a zero-filled key would
//   score 0, not -inf). P goes in place into the wgmma A-fragment layout
//   (the m64n64 accumulator layout is the m64k16 A layout, tile by tile),
//   rounded to bf16 or split into hi and lo, and P V is a register-A
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
// - No setmaxnreg: an increase asks for registers that some warp has
//   given back (setmaxnreg.inc blocks until they are free), and the one
//   producer warp frees 72 x 32, too few to lift 256 consumer threads by
//   even one step of 8.
// The TPU kernel's 512/1024 blocks and segment-id padding (unet.py:611-
// 630) are VMEM tiling and do not carry over: keys past T are masked to
// -inf, queries past T are not written.
#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace ipdm::hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;                     // query rows per warpgroup
constexpr int NWG = 2;                     // consumer warpgroups per CTA
constexpr int BQ = BM * NWG;               // query rows per CTA
constexpr int BK = 64;                     // keys per tile
constexpr int NTHREADS = NWG * 128 + 32;   // + the producer warp
constexpr int TILE = 64 * HD;              // elements of a 64-row tile
constexpr int TILE_BYTES = TILE * 2;       // one bf16 tile, 8 KB

template <bool F32>
using Out = std::conditional_t<F32, float, bf16>;

// Shared memory: the Q tiles and a ring of K and V tiles, each operand
// one bf16 tile (bf16) or two, hi and lo (f32); every tile is 1024-byte
// aligned (128-byte swizzle atoms)
template <bool F32>
struct Smem {
  static constexpr int STAGES = 4;            // ring slots
  static constexpr int NP = F32 ? 2 : 1;      // [hi, lo]
  bf16 q[NWG][NP][TILE];
  bf16 k[STAGES][NP][TILE];
  bf16 v[STAGES][NP][TILE];
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

// hi and lo of n4 float4s of q, k and v (blockIdx.y) into dst: [6][n] bf16,
// tensor t's hi at 2t, its lo at 2t + 1
__global__ void __launch_bounds__(256)
    split_kernel(const float4* __restrict__ q, const float4* __restrict__ k,
                 const float4* __restrict__ v, uint2* __restrict__ dst,
                 size_t n4) {
  const float4* src = blockIdx.y == 0 ? q : blockIdx.y == 1 ? k : v;
  uint2* hi = dst + 2 * blockIdx.y * n4;
  uint2* lo = hi + n4;
  for (size_t i = blockIdx.x * 256 + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * 256) {
    const float4 x = src[i];
    uint2 h, l;
    split2(x.x, x.y, h.x, l.x);
    split2(x.z, x.w, h.y, l.y);
    hi[i] = h;
    lo[i] = l;
  }
}

// One consumer warpgroup: 64 query rows against every key tile.
// Accumulator layout (m64nN f32): warp w of the group holds rows
// 16w + lane/4 (registers 4n, 4n+1) and 16w + lane/4 + 8 (4n+2, 4n+3), at
// columns 8n + 2*(lane%4) + {0, 1}, n = 0..7.
template <bool F32>
__device__ __forceinline__ void consume(Smem<F32>& sm, int wg, Out<F32>* out,
                                        float* lse, int T, float scale_log2,
                                        int bh, int q0, int nk) {
  constexpr int STAGES = Smem<F32>::STAGES, NP = Smem<F32>::NP;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(&sm.qbar, 0);
  const uint64_t qH = sw128_desc(sm.q[wg][0]);
  const uint64_t qL = sw128_desc(sm.q[wg][NP - 1]);
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    mbar_wait(&sm.full[s], (j / STAGES) & 1);
    const uint64_t kH = sw128_desc(sm.k[s][0]);
    const uint64_t kL = sw128_desc(sm.k[s][NP - 1]);
    const uint64_t vH = sw128_desc(sm.v[s][0]);
    const uint64_t vL = sw128_desc(sm.v[s][NP - 1]);

    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    reg_fence(sc);
    wg_fence();
    product_ss<F32>(sc, qH, qL, kH, kL);
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
      // O = O corr + P V, the tile's P V summed from zero in sc (dead now):
      // the tensor cores' f32 sums do not round to nearest, and P V onto
      // O over every key tile (terms of one sign) left out ~4e-5 low at
      // T = 4097, which D carries into the backward's cancelling dQ
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      reg_fence(sc);
      reg_fence_a(p);
      wg_fence();
      product_rs(sc, p, vH, vL);
      wg_commit();
      reg_fence(sc);
      wg_wait_all();
      reg_fence(sc);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] = fmaf(o[4 * n], cr0, sc[4 * n]);
        o[4 * n + 1] = fmaf(o[4 * n + 1], cr0, sc[4 * n + 1]);
        o[4 * n + 2] = fmaf(o[4 * n + 2], cr1, sc[4 * n + 2]);
        o[4 * n + 3] = fmaf(o[4 * n + 3], cr1, sc[4 * n + 3]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n] *= cr0;
        o[4 * n + 1] *= cr0;
        o[4 * n + 2] *= cr1;
        o[4 * n + 3] *= cr1;
      }

      // O += P V
      reg_fence(o);
      reg_fence_a(p);
      wg_fence();
      product_rs(o, p, vH, vL);
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
  for (int n = 0; n < 8; ++n) {
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

template <bool F32>
__global__ void __launch_bounds__(NTHREADS, F32 ? 1 : 2)
    flash_attn_kernel(const __grid_constant__ Maps maps,
                      Out<F32>* __restrict__ out, float* __restrict__ lse,
                      int T, float scale_log2) {
  using S = Smem<F32>;
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
      mbar_expect_tx(&sm.qbar, NWG * NP * TILE_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int p = 0; p < NP; ++p)
          tma_load(sm.q[w][p], &maps.q[p], &sm.qbar, q0 + w * BM, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        mbar_wait(&sm.empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * NP * TILE_BYTES);
        for (int p = 0; p < NP; ++p) {
          tma_load(sm.k[s][p], &maps.k[p], &sm.full[s], j * BK, bh);
          tma_load(sm.v[s][p], &maps.v[p], &sm.full[s], j * BK, bh);
        }
      }
    }
  } else {
    consume<F32>(sm, warp / 4, out, lse, T, scale_log2, bh, q0, nk);
  }
}

template <bool F32>
int launch(const Maps& maps, void* out, void* lse, int BH, int T,
           float scale_log2, cudaStream_t st) {
  constexpr int SMEM_BYTES = (int)sizeof(Smem<F32>) + SW_ATOM;
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<F32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((T + BQ - 1) / BQ, BH);
  flash_attn_kernel<F32><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      maps, static_cast<Out<F32>*>(out), static_cast<float*>(lse), T,
      scale_log2);
  return (int)cudaGetLastError();
}

// the f32 forward's split pre-pass: hi and lo of q, k and v into split
int split_launch(const void* q, const void* k, const void* v, void* split,
                 int BH, int T, cudaStream_t st) {
  const size_t n4 = (size_t)BH * T * HD / 4;
  const unsigned gx = (unsigned)std::min<size_t>((n4 + 255) / 256, 132 * 8);
  split_kernel<<<dim3(gx, 3), 256, 0, st>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(k),
      static_cast<const float4*>(v), static_cast<uint2*>(split), n4);
  return (int)cudaGetLastError();
}

// the bf16 maps of hi (part 0) and lo (part 1) of q, k and v in split
bool split_maps(Maps* maps, const void* split, int BH, int T) {
  const size_t n = (size_t)BH * T * HD;
  const bf16* s = static_cast<const bf16*>(split);
  return make_map(&maps->q[0], s, BH, T) &&
         make_map(&maps->q[1], s + n, BH, T) &&
         make_map(&maps->k[0], s + 2 * n, BH, T) &&
         make_map(&maps->k[1], s + 3 * n, BH, T) &&
         make_map(&maps->v[0], s + 4 * n, BH, T) &&
         make_map(&maps->v[1], s + 5 * n, BH, T);
}

}  // namespace

// q, k, v, out: [BH, T, 64] bf16, contiguous, 16-byte aligned; lse: [BH, T]
// f32 or null. scale_log2 = (scale applied to q.k) * log2(e). Returns
// cudaGetLastError()
// (cudaErrorInvalidValue for bad sizes or a tensor map that
// cuTensorMapEncodeTiled refuses).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int BH, int T,
                                 float scale_log2, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!make_map(&maps.q[0], q, BH, T) || !make_map(&maps.k[0], k, BH, T) ||
      !make_map(&maps.v[0], v, BH, T))
    return (int)cudaErrorInvalidValue;
  return launch<false>(maps, out, lse, BH, T, scale_log2,
                       static_cast<cudaStream_t>(stream));
}

// The same for f32 q, k, v, out, with split: a [6, BH, T, 64] bf16
// scratch tensor (16-byte aligned) that the split pre-pass fills with hi
// and lo of q, k and v before the main kernel reads them. Returns
// cudaGetLastError() of the first launch that fails.
extern "C" int flash_attn_f32_launch(const void* q, const void* k,
                                     const void* v, void* split, void* out,
                                     void* lse, int BH, int T,
                                     float scale_log2, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Maps maps;
  if (!split_maps(&maps, split, BH, T)) return (int)cudaErrorInvalidValue;
  const int e = split_launch(q, k, v, split, BH, T, st);
  if (e != 0) return e;
  return launch<true>(maps, out, lse, BH, T, scale_log2, st);
}


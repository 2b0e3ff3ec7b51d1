// Forward flash attention for head dimension 64, bf16 in and out, for
// Hopper (sm_90a): wgmma for both products, TMA for the loads.
//
// Replaces the TPU flash kernel that ipdm_tpu/models/unet.py:601
// _flash_attention calls (jax.experimental.pallas.ops.tpu.flash_attention)
// for self-attention over >= 4096 tokens:
//
//   out[bh,t,:] = sum_s softmax_s(scale2 * q[bh,t,:] . k[bh,s,:]) v[bh,s,:]
//
// q, k, v, out: [BH, T, 64] bf16, contiguous. With lse != nullptr (the
// autograd path asks for it) the kernel also writes the f32 natural-log
// softmax normaliser lse[bh, t] = log(sum_s exp(scale2 * q.k)) that the
// backward kernels (flash_bwd.cu) rebuild P from, the counterpart of the
// TPU kernel's saved l and m residuals. The scale is applied ONCE,
// to the f32 score: the caller passes scale2 * log2(e) with
// scale2 = (1/sqrt(sqrt(hd)))^2 = 1/sqrt(hd), the product of the two
// per-operand scales of the plain formula (unet.py:659-662, which scales
// q and k by 1/sqrt(sqrt(hd)) each in the activation dtype).
//
// What bounds it on an H100: the two products, 4*T*T*64 flops per head
// (52 GFLOP at T = 7125 and 4 heads: 0.053 ms at the 989 TFLOP/s bf16
// tensor-core peak), and, as long at head dimension 64, the T*T exp2 of
// the softmax on the special-function units (16 per clock per SM:
// 0.049 ms). The T x T score matrix never leaves the SM.
//
// Design (one CTA = 128 query rows of one head):
// - Warp 8 is the producer: one thread loads the CTA's Q tile once and
//   then walks the 64-key tiles of K and V through a ring of STAGES
//   shared-memory slots with TMA (3-D tensor maps [BH, T, 64] with
//   128-byte swizzle; rows past T arrive as zeros). Each slot has a full
//   mbarrier (TMA's transaction count) and an empty one (one arrival per
//   consumer warp), so up to STAGES tiles are in flight while the tensor
//   cores work.
// - Warps 0-7 are two consumer warpgroups of 64 query rows each.
//   S = Q K^T is one wgmma m64n64k16 chain from shared memory (Q and K
//   both K-major, 128-byte swizzle) into 32 f32 registers per thread.
//   The online softmax runs on those registers: a thread holds 16 scores
//   of two rows, the row max and sum are reduced over the quad of lanes
//   that shares a row, exp2 takes the scale folded into one FMA, and keys
//   >= T in the last tile are set to -inf (a zero-filled key would score
//   0, not -inf). P is rounded to bf16 in place into the wgmma A-fragment
//   layout (the m64n64 accumulator layout is the m64k16 A layout, tile by
//   tile), and O += P V is a register-A wgmma chain with V read from
//   shared memory as an MN-major (transposed) operand. O is rescaled in
//   registers. S, P and O never touch shared memory.
// - The overlap of the softmax's exp2 with the tensor cores comes from
//   the other warpgroup of the CTA and the second CTA on the SM: while
//   one warpgroup waits on its wgmma chain, the others run their softmax.
// - Waves: 128-row CTAs give 56 x 4 = 224 CTAs at T = 7125 and 128 at
//   T = 4096. The CTA takes ~83 KB of shared memory and at most 112
//   registers a thread at launch (__launch_bounds__(288, 2)), so two CTAs
//   fit on each of the 132 SMs and every CTA of both shapes is resident
//   at once: no second, part-empty wave. 128 rows rather than 64 halve
//   the K/V traffic from L2 (each CTA reads all of its head's K and V).
// - No setmaxnreg: a consumer thread needs under 100 registers, below the 112
//   that two CTAs per SM leave each thread at launch. An increase asks
//   for registers that some warp has given back (setmaxnreg.inc blocks
//   until they are free), and the one producer warp frees 72 x 32, too
//   few to lift 256 consumer threads by even one step of 8.
// The TPU kernel's 512/1024 blocks and segment-id padding (unet.py:611-
// 630) are VMEM tiling and do not carry over: keys past T are masked to
// -inf, queries past T are not written.
#include "hopper.cuh"

namespace {

using namespace ipdm::hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;                     // query rows per warpgroup
constexpr int NWG = 2;                     // consumer warpgroups per CTA
constexpr int BQ = BM * NWG;               // query rows per CTA
constexpr int BK = 64;                     // keys per tile
constexpr int STAGES = 4;                  // K/V ring depth
constexpr int NTHREADS = NWG * 128 + 32;   // + the producer warp
constexpr int TILE_BYTES = 64 * HD * 2;    // one 64-row tile, 8 KB

struct Smem {
  bf16 q[NWG][BM * HD];
  bf16 k[STAGES][BK * HD];
  bf16 v[STAGES][BK * HD];
  uint64_t qbar;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + SW_ATOM;  // + alignment

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One consumer warpgroup: 64 query rows against every key tile.
// Accumulator layout (m64nN f32): warp w of the group holds rows
// 16w + lane/4 (registers 4n, 4n+1) and 16w + lane/4 + 8 (4n+2, 4n+3), at
// columns 8n + 2*(lane%4) + {0, 1}, n = 0..7.
__device__ __forceinline__ void consume(Smem& sm, int wg, bf16* out,
                                        float* lse, int T, float scale_log2,
                                        int bh, int q0, int nk) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int c2 = (lane % 4) * 2;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(&sm.qbar, 0);
  const uint64_t dq = sw128_desc(sm.q[wg]);
  for (int j = 0; j < nk; ++j) {
    const int s = j % STAGES;
    mbar_wait(&sm.full[s], (j / STAGES) & 1);

    // S = Q K^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    const uint64_t dk = sw128_desc(sm.k[s]);
    reg_fence(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sc, dq + 2 * kk, dk + 2 * kk, kk);
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
    uint32_t p[16];  // P in bf16, m64k16 A fragments: p[4kk .. 4kk+3]
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p00 = fast_exp2(fmaf(sc[4 * n], scale_log2, -mn0));
      const float p01 = fast_exp2(fmaf(sc[4 * n + 1], scale_log2, -mn0));
      const float p10 = fast_exp2(fmaf(sc[4 * n + 2], scale_log2, -mn1));
      const float p11 = fast_exp2(fmaf(sc[4 * n + 3], scale_log2, -mn1));
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      p[2 * n] = pack_bf16(p00, p01);
      p[2 * n + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * cr0 + sum0;  // per-thread partial sums, reduced at the end
    l1 = l1 * cr1 + sum1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[4 * n] *= cr0;
      o[4 * n + 1] *= cr0;
      o[4 * n + 2] *= cr1;
      o[4 * n + 3] *= cr1;
    }

    // O += P V
    const uint64_t dv = sw128_desc(sm.v[s]);
    reg_fence(o);
    reg_fence(p);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               dv + kk * (16 * 128 >> 4));
    wg_commit();
    reg_fence(o);
    wg_wait_all();
    reg_fence(o);
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
  bf16* base = out + (size_t)bh * T * HD;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + c2;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(base + (size_t)r0 * HD + col) =
          pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(base + (size_t)r1 * HD + col) =
          pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
    flash_attn_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ out, float* __restrict__ lse, int T,
                      float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
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
      mbar_expect_tx(&sm.qbar, NWG * TILE_BYTES);
      for (int w = 0; w < NWG; ++w)
        tma_load(sm.q[w], &tq, &sm.qbar, q0 + w * BM, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        mbar_wait(&sm.empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);
        tma_load(sm.k[s], &tk, &sm.full[s], j * BK, bh);
        tma_load(sm.v[s], &tv, &sm.full[s], j * BK, bh);
      }
    }
  } else {
    consume(sm, warp / 4, out, lse, T, scale_log2, bh, q0, nk);
  }
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
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, BH, T) || !make_map(&tk, k, BH, T) ||
      !make_map(&tv, v, BH, T))
    return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, BH);
  flash_attn_kernel<<<grid, NTHREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), T,
      scale_log2);
  return (int)cudaGetLastError();
}

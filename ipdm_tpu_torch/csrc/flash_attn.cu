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
#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;                     // head dimension
constexpr int BM = 64;                     // query rows per warpgroup
constexpr int NWG = 2;                     // consumer warpgroups per CTA
constexpr int BQ = BM * NWG;               // query rows per CTA
constexpr int BK = 64;                     // keys per tile
constexpr int STAGES = 4;                  // K/V ring depth
constexpr int NTHREADS = NWG * 128 + 32;   // + the producer warp
constexpr int TILE_BYTES = 64 * HD * 2;    // one 64-row tile, 8 KB
constexpr int SW_ATOM = 1024;              // 8 rows x 128 B swizzle atom

struct Smem {
  bf16 q[NWG][BM * HD];
  bf16 k[STAGES][BK * HD];
  bf16 v[STAGES][BK * HD];
  uint64_t qbar;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};
constexpr int SMEM_BYTES = (int)sizeof(Smem) + SW_ATOM;  // + alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// waits until the phase of parity `parity` has completed; a wait longer
// than two seconds (a broken pipeline) traps, a launch error, instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins % 1024 == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > 2000000000ull)
        __trap();
    }
  }
}

// TMA: one box of the 3-D tensor map at (0, row, bh) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(bh)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle layout
// (1024-byte aligned): start address, leading offset 16 B (unused by the
// swizzled layouts at these widths), stride offset 1024 B between groups
// of 8 rows. For a K-major operand (Q, K) a 16-element step along K adds
// 32 B to the start; for the MN-major V a 16-key step adds 16 rows, 2 KB.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(SW_ATOM >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving register reads or writes across the
// asynchronous wgmma that owns these registers
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_D32_OPS(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B^T, A [64 x 16] and B [64 x 16] K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A [64 x 16] bf16 in registers, B [16 x 64] MN-major in shared
// memory (transposed operand)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32_OPS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// 2^x on the special-function unit with no range fix-up (x <= 0 here;
// -inf gives 0): exp2f adds a scale-and-select around the same MUFU.EX2
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// cuTensorMapEncodeTiled, looked up once per process through the CUDA
// runtime's entry-point query (no link against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// [BH, T, 64] bf16 as a 3-D map, innermost first, 64 x 64 x 1 boxes in
// the 128-byte swizzle; rows past T read as zeros
bool make_map(CUtensorMap* map, const void* base, int BH, int T) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {HD, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {HD * 2, (cuuint64_t)T * HD * 2};
  const cuuint32_t box[3] = {HD, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_attn.cu, flash_bwd.cu): mbarriers, TMA loads of [BH, T, 64]
// tensors, wgmma m64n64k16 in bf16 with f32 sums, f32 products as three
// bf16 passes, and the register layouts between them.
//
// Accumulator layout (m64nN f32): warp w of the warpgroup holds rows
// 16w + lane/4 (registers 4n, 4n+1) and 16w + lane/4 + 8 (4n+2, 4n+3), at
// columns 8n + 2*(lane%4) + {0, 1}, n = 0..7. Packed to bf16 pairs, the
// m64n64 accumulator is the m64k16 register-A fragment of four wgmmas:
// fragment kk is registers 4kk .. 4kk+3 of the packed array
// (pack_bf16(d[4n], d[4n+1]) at 2n, pack_bf16(d[4n+2], d[4n+3]) at 2n+1).
#pragma once

#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace ipdm {
namespace hopper {

constexpr int HD = 64;        // head dimension
constexpr int SW_ATOM = 1024; // 8 rows x 128 B swizzle atom

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

// f32 operands as three bf16 passes (flash_attn.cu's f32 body,
// flash_bwd.cu's): x ~ hi + lo with hi = bf16(x), lo = bf16(x - hi), and
// each product hi*hi + hi*lo + lo*hi into the same f32 sums (lo*lo dropped)

// x ~ hi + lo as two bf16 pairs
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

constexpr int MN_STEP = 16 * 128 >> 4;  // 16 rows of an MN-major B, in
                                        // descriptor units

// d (+)= A B^T over the head dimension, A and B K-major in shared memory:
// one pass, or three (hi hi, hi lo, lo hi)
template <bool F32>
__device__ __forceinline__ void product_ss(float (&d)[32], uint64_t aH,
                                           uint64_t aL, uint64_t bH,
                                           uint64_t bL) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(d, aH + 2 * kk, bH + 2 * kk, kk);
  if constexpr (F32) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(d, aH + 2 * kk, bL + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(d, aL + 2 * kk, bH + 2 * kk, 1);
  }
}

// d += A B over a 64-row tile, A in registers, B MN-major in shared
// memory: one pass, or three
template <int NP>
__device__ __forceinline__ void product_rs(float (&d)[32],
                                           const uint32_t (&a)[NP][16],
                                           uint64_t bH, uint64_t bL) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk)
    wgmma_rs(d, a[0][4 * kk], a[0][4 * kk + 1], a[0][4 * kk + 2],
             a[0][4 * kk + 3], bH + kk * MN_STEP);
  if constexpr (NP == 2) {
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk)
      wgmma_rs(d, a[0][4 * kk], a[0][4 * kk + 1], a[0][4 * kk + 2],
               a[0][4 * kk + 3], bL + kk * MN_STEP);
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk)
      wgmma_rs(d, a[1][4 * kk], a[1][4 * kk + 1], a[1][4 * kk + 2],
               a[1][4 * kk + 3], bH + kk * MN_STEP);
  }
}

template <int NP>
__device__ __forceinline__ void reg_fence_a(uint32_t (&a)[NP][16]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) reg_fence(a[p]);
}

// a named barrier over ``n`` threads (a multiple of 32)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// makes this thread's shared-memory stores visible to the async proxy
// (wgmma operands read from shared memory)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// cuTensorMapEncodeTiled, looked up once per process through the CUDA
// runtime's entry-point query (no link against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
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
inline bool make_map(CUtensorMap* map, const void* base, int BH, int T) {
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


// [BH, T, 64] f32 as a 3-D map, 64 x 64 x 1 boxes (256-byte rows) with no
// swizzle; rows past T read as zeros
inline bool make_map_f32(CUtensorMap* map, const void* base, int BH, int T) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {HD, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {HD * 4, (cuuint64_t)T * HD * 4};
  const cuuint32_t box[3] = {HD, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace ipdm

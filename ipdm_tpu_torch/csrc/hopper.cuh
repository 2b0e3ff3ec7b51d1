// Hopper (sm_90a) building blocks of the flash-attention kernels
// (flash_attn.cu, flash_narrow.cu, flash_bwd.cu, flash_narrow_bwd.cu):
// mbarriers, TMA loads of [BH, T, HD] tensors, wgmma m64nNk16 in bf16
// with f32 sums, f32 products as three bf16 passes, and the register
// layouts between them.
//
// Head dimensions: the kernels are templates over HD in {8, 16, 32, 64,
// 128} (ops/cuda/attention.py FLASH_HEAD_DIMS; other head dims up to 128
// run on the next instance up, zero-padded by the wrapper); above 128 one
// wide body per kernel takes the head dim as a runtime count of
// WIDE_CHUNK-column chunks (the wrapper zero-pads it to a multiple of 64),
// each chunk a Head<64> tile of its own; the f32 forward's wide body
// takes 128 too (IPDM_FLASH_FWD_WIDE_FROM_F32), the backward's 128 in both
// dtypes (IPDM_FLASH_BWD_WIDE_FROM). A tile of 64
// rows lies in shared memory HDP = max(HD, 16) columns wide: bf16 wgmma
// takes K in steps of 16, so at HD = 8 the contraction over the head
// dimension runs on operands zero-padded to 16 (the TMA box is 16 columns
// over an 8-column tensor and reads the pad as zeros, as it reads rows
// past T). A tile is NSUB sub-tiles of SUB = min(HDP, 64) columns, each a
// TMA box of its own: one at HD <= 64, two at HD = 128, whose 256-byte
// rows are wider than the largest (128-byte) swizzle. A sub-tile row is
// 2 * SUB bytes (128, 64 or 32), and the swizzle of the TMA maps and of
// the wgmma descriptors follows it: 128-, 64- or 32-byte swizzle, 8-row
// groups 8 * 2 * SUB bytes apart. A K-major contraction over the head
// dimension moves to the second sub-tile after four k16 steps. Products
// with N = HD (P V, dS K, dS^T Q, P^T dO) run one sub-tile at a time at
// N = SUB: 16 at HD = 8, where the pad columns of V, K, Q and dO are
// zeros and the output's pad columns are not written; two N = 64 halves
// at HD = 128.
//
// Accumulator layout (m64nN f32): warp w of the warpgroup holds rows
// 16w + lane/4 (registers 4n, 4n+1) and 16w + lane/4 + 8 (4n+2, 4n+3), at
// columns 8n + 2*(lane%4) + {0, 1}, n = 0..N/8-1 (so the m64n128 sums are
// the two m64n64 halves' registers one after the other). Packed to bf16
// pairs, the m64n64 accumulator is the m64k16 register-A fragment of four
// wgmmas: fragment kk is registers 4kk .. 4kk+3 of the packed array
// (pack_bf16(d[4n], d[4n+1]) at 2n, pack_bf16(d[4n+2], d[4n+3]) at 2n+1).
#pragma once

#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace ipdm {
namespace hopper {

// the head dimensions the flash kernels are instantiated for: one case
// each in the entry points' switches (flash_attn.cu, flash_bwd.cu).
// ops/cuda/_build.py FLASH_HEAD_DIMS names the same set on the Python
// side; tests/test_torch_flash_head_dims.py holds the two equal
#define IPDM_FLASH_HEAD_DIMS(X) X(8) X(16) X(32) X(64) X(128)
// the wide bodies' chunk of the head dimension (flash_attn.cu,
// flash_bwd.cu): head dims above the largest instance run as a runtime
// count of chunks this wide; _build.py FLASH_WIDE_CHUNK names it too
#define IPDM_FLASH_WIDE_CHUNK 64
constexpr int WIDE_CHUNK = IPDM_FLASH_WIDE_CHUNK;
// the first head dim whose forward runs on the wide body (flash_attn.cu),
// by dtype: the forward's template instances stop below it (bf16 keeps
// its hd-128 instance, faster there than the wide body; f32's spilled);
// _build.py FLASH_FWD_WIDE_FROM names them too
#define IPDM_FLASH_FWD_WIDE_FROM_BF16 192
#define IPDM_FLASH_FWD_WIDE_FROM_F32 128
// the backward's (flash_bwd.cu), both dtypes: its template instances stop
// below it; _build.py FLASH_BWD_WIDE_FROM names it too
#define IPDM_FLASH_BWD_WIDE_FROM 128

constexpr int SW_ATOM = 1024; // tile alignment: 8 rows x 128 B, the
                              // largest swizzle atom

// the shared-memory layout of a 64-row bf16 tile of head dimension HD
template <int HD>
struct Head {
  static_assert(HD == 8 || HD == 16 || HD == 32 || HD == 64 || HD == 128,
                "the layout takes rows of 32, 64 or 128 bytes");
  static constexpr int HDP = HD < 16 ? 16 : HD;  // columns in shared memory
  static constexpr int SUB = HDP < 64 ? HDP : 64;  // columns of a sub-tile
  static constexpr int NSUB = HDP / SUB;          // sub-tiles of a tile
  static constexpr int ROW = 2 * SUB;             // bytes of a sub-tile row
  // a sub-tile's bytes (64 rows), in wgmma descriptor units of 16 bytes
  static constexpr int SUB_UNITS = 64 * ROW >> 4;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  // swizzle
  static constexpr int LAYOUT = ROW == 128 ? 1 : ROW == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                  : CU_TENSOR_MAP_SWIZZLE_32B;
  // a 16-row step of an MN-major (transposed) B operand, descriptor units
  static constexpr int MN_STEP = 16 * ROW >> 4;
  // k16 step kk of a K-major operand over the head dimension, descriptor
  // units from the tile's start: 32 bytes a step within a sub-tile, the
  // next sub-tile after SUB / 16 steps
  static constexpr __host__ __device__ int k_step(int kk) {
    return kk / (SUB / 16) * SUB_UNITS + 2 * (kk % (SUB / 16));
  }
};

// byte offset of the 16-byte chunk at ``o`` (row-major offset in a tile of
// ``ROW``-byte rows) in the matching swizzle: chunk bits [4, 4 + log2(ROW
// / 16)) XOR bits [7, ...) of the offset, as TMA lays the tile out
template <int ROW>
__device__ __forceinline__ int swizzle(int o) {
  return o ^ (((o >> 7) & (ROW / 16 - 1)) << 4);
}

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

// TMA: one box of the 3-D tensor map at (col, row, bh) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh,
                                         int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(bh)
      : "memory");
}

// a 64-row bf16 tile of Head<HD>'s layout at (row, bh) of a make_map<HD>
// map into dst (1024-byte aligned): one TMA box per sub-tile
template <int HD>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  using H = Head<HD>;
#pragma unroll
  for (int h = 0; h < H::NSUB; ++h)
    tma_load(dst + h * 64 * H::SUB, map, bar, row, bh, h * H::SUB);
}

// wgmma shared-memory descriptor of a tile of Head<HD>'s layout
// (1024-byte aligned): start address, leading offset 16 B (unused by the
// swizzled layouts at these widths: a sub-tile is one swizzle atom wide),
// stride offset 8 rows (1024, 512 or 256 B) between groups of 8 rows, the
// swizzle of the row's bytes. For a K-major operand (Q, K) a 16-element
// step along K adds Head<HD>::k_step; for an MN-major one (V) a 16-row
// step adds 16 rows (MN_STEP), and sub-tile h starts h * SUB_UNITS on.
template <int HD>
__device__ __forceinline__ uint64_t sw_desc(const void* tile) {
  using H = Head<HD>;
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * H::ROW) >> 4) << 32) |
         ((uint64_t)H::LAYOUT << 62);
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
// waits until at most N committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
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

#define WG_D16                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D16_OPS(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WG_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_D8_OPS(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7])

#define WG_D4 "{%0, %1, %2, %3}"
#define WG_D4_OPS(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])

// d (+)= A B, A [64 x 16] bf16 in registers, B [16 x N] MN-major in
// shared memory (transposed operand; with TB = 0, B^T: [N x 16] K-major),
// N = 64, 32, 16 or 8 (N / 2 sums a thread); accumulate = 0 overwrites d.
// At N = 8 an MN-major B reads the first 8 columns of its tile's rows
template <int N, int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db,
                                         int accumulate = 1) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WG_D32_OPS(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate),
          "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : WG_D16_OPS(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate),
          "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " WG_D8
        ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : WG_D8_OPS(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate),
          "n"(TB));
  } else {
    static_assert(N == 8, "wgmma_rs: N is 64, 32, 16 or 8");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 " WG_D4
        ", {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : WG_D4_OPS(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate),
          "n"(TB));
  }
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

// d (+)= A B^T over the head dimension (HDP / 16 steps of 16), A and B
// K-major in shared memory: one pass, or three (hi hi, hi lo, lo hi); the
// first step overwrites d unless ``accumulate`` (a wide body's later
// chunks of the head dimension)
template <bool F32, int HD>
__device__ __forceinline__ void product_ss(float (&d)[32], uint64_t aH,
                                           uint64_t aL, uint64_t bH,
                                           uint64_t bL, int accumulate = 0) {
  using H = Head<HD>;
  constexpr int KS = H::HDP / 16;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_ss(d, aH + H::k_step(kk), bH + H::k_step(kk), kk | accumulate);
  if constexpr (F32) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(d, aH + H::k_step(kk), bL + H::k_step(kk), 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(d, aL + H::k_step(kk), bH + H::k_step(kk), 1);
  }
}

// d += A B over a 64-row tile (K = 64), A in registers, B MN-major in
// shared memory with N = SUB (one sub-tile: bH, bL its descriptors): one
// pass, or three
template <int NP, int HD>
__device__ __forceinline__ void product_rs(float (&d)[Head<HD>::SUB / 2],
                                           const uint32_t (&a)[NP][16],
                                           uint64_t bH, uint64_t bL) {
  constexpr int N = Head<HD>::SUB, STEP = Head<HD>::MN_STEP;
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk)
    wgmma_rs<N>(d, a[0][4 * kk], a[0][4 * kk + 1], a[0][4 * kk + 2],
                a[0][4 * kk + 3], bH + kk * STEP);
  if constexpr (NP == 2) {
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk)
      wgmma_rs<N>(d, a[0][4 * kk], a[0][4 * kk + 1], a[0][4 * kk + 2],
                  a[0][4 * kk + 3], bL + kk * STEP);
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk)
      wgmma_rs<N>(d, a[1][4 * kk], a[1][4 * kk + 1], a[1][4 * kk + 2],
                  a[1][4 * kk + 3], bH + kk * STEP);
  }
}

// sub-tile h's N = SUB sums of an m64nHDP accumulator (the m64n128 sums
// are two m64n64 halves one after the other; below 128, d itself)
template <int HD>
__device__ __forceinline__ float (&sub_of(float (&d)[Head<HD>::HDP / 2],
                                          int h))[Head<HD>::SUB / 2] {
  return *reinterpret_cast<float(*)[Head<HD>::SUB / 2]>(
      &d[h * (Head<HD>::SUB / 2)]);
}

template <int NP>
__device__ __forceinline__ void reg_fence_a(uint32_t (&a)[NP][16]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) reg_fence(a[p]);
}

// -- the narrow bodies' helpers (flash_narrow.cu, flash_narrow_bwd.cu): head
// dim 8 in f32 on packed 16-column bf16 tiles ------------------------------

// 8 f32 (two float4) as hi and lo bf16 (uint4 each)
__device__ __forceinline__ void split8(const float4* src, uint4& hi,
                                       uint4& lo) {
  const float4 a = src[0], b = src[1];
  split2(a.x, a.y, hi.x, lo.x);
  split2(a.z, a.w, hi.y, lo.y);
  split2(b.x, b.y, hi.z, lo.z);
  split2(b.z, b.w, hi.w, lo.w);
}

// p00, p01 (two f32 of one row) as hi (their top 16 bits) and
// lo = bf16(p - hi), each a bf16 pair
__device__ __forceinline__ void split_trunc(float p00, float p01,
                                            uint32_t& hi, uint32_t& lo) {
  const uint32_t b0 = __float_as_uint(p00), b1 = __float_as_uint(p01);
  hi = __byte_perm(b0, b1, 0x7632);
  lo = pack_bf16(p00 - __uint_as_float(b0 & 0xffff0000u),
                 p01 - __uint_as_float(b1 & 0xffff0000u));
}

// a Head<HD> tile's wgmma descriptor from its low word (start address,
// leading offset; sw_desc<HD>'s): the high word (8-row group stride, the
// swizzle) is a constant, so the low word alone moves between tiles, in
// 32-bit arithmetic
template <int HD>
__device__ __forceinline__ uint64_t desc_at(uint32_t lo) {
  constexpr uint32_t hi = (uint32_t)((8 * Head<HD>::ROW) >> 4) |
                          ((uint32_t)Head<HD>::LAYOUT << 30);
  return ((uint64_t)hi << 32) | lo;
}

// adds 1 to the shared counter at c and returns its value before, with
// release and acquire ordering at CTA scope (each warp's reads of a slot
// happen before the refill that the last of them issues)
__device__ __forceinline__ int count_release(int* c) {
  int old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "r"(smem_u32(c))
               : "memory");
  return old;
}

// the calling warpgroup's registers a thread lowered (dec) or raised (inc)
// to N, a multiple of 8 in [24, 256]: all four warps of the warpgroup
// execute it; an increase waits until other warpgroups of the CTA have
// given back enough (ptxas takes the kernel's launch bound as the count
// at entry)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
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

// The f32 bodies' split pre-pass (flash_attn.cu's forward, flash_bwd.cu's
// backward at HD = 128 and the wide bodies): hi and lo of n4 float4s of
// each of the gridDim.y (<= 4) tensors t0 .. t3 into dst:
// [2 * gridDim.y][n] bf16, tensor y's hi at 2y, its lo at 2y + 1
static __global__ void __launch_bounds__(256)
    split_kernel(const float4* __restrict__ t0, const float4* __restrict__ t1,
                 const float4* __restrict__ t2, const float4* __restrict__ t3,
                 uint2* __restrict__ dst, size_t n4) {
  const float4* src = blockIdx.y == 0   ? t0
                      : blockIdx.y == 1 ? t1
                      : blockIdx.y == 2 ? t2
                                        : t3;
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

// split_kernel over the ``count`` (<= 4) f32 tensors of n elements each
// (n a multiple of 4) at src, into split; returns cudaGetLastError()
static inline int split_launch(const void* const* src, int count,
                               void* split, size_t n, cudaStream_t st) {
  const float4* t[4] = {nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < count; ++i) t[i] = static_cast<const float4*>(src[i]);
  const size_t n4 = n / 4;
  const unsigned gx = (unsigned)((n4 + 255) / 256 < 132 * 8
                                     ? (n4 + 255) / 256 : 132 * 8);
  split_kernel<<<dim3(gx, count), 256, 0, st>>>(
      t[0], t[1], t[2], t[3], static_cast<uint2*>(split), n4);
  return (int)cudaGetLastError();
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

// [BH, T, HD] bf16 as a 3-D map, innermost first, SUB x 64 x 1 boxes in
// Head<HD>'s swizzle; rows past T, and at HD = 8 the columns past 8, read
// as zeros
template <int HD>
inline bool make_map(CUtensorMap* map, const void* base, int BH, int T) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {HD, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {HD * 2, (cuuint64_t)T * HD * 2};
  const cuuint32_t box[3] = {Head<HD>::SUB, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            Head<HD>::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// [BH, T, hdw] bf16 (hdw a multiple of WIDE_CHUNK) as a 3-D map of
// WIDE_CHUNK x 64 x 1 boxes in Head<WIDE_CHUNK>'s (128-byte) swizzle:
// chunk c of a 64-row tile is the box at column c * WIDE_CHUNK; rows past
// T read as zeros
inline bool make_map_wide(CUtensorMap* map, const void* base, int BH, int T,
                          int hdw) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hdw, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)hdw * 2,
                                 (cuuint64_t)T * hdw * 2};
  const cuuint32_t box[3] = {WIDE_CHUNK, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            Head<WIDE_CHUNK>::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [BH, T, HD] f32 as a 3-D map, HD x 64 x 1 boxes (4 * HD-byte rows) with
// no swizzle; rows past T read as zeros
template <int HD>
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

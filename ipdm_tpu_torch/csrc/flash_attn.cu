// Forward flash attention for head dimension 64, bf16 in and out.
//
// Replaces the TPU flash kernel that ipdm_tpu/models/unet.py:601
// _flash_attention calls (jax.experimental.pallas.ops.tpu.flash_attention)
// for self-attention over >= 4096 tokens:
//
//   out[bh,t,:] = sum_s softmax_s(scale2 * q[bh,t,:] . k[bh,s,:]) v[bh,s,:]
//
// q, k, v, out: [BH, T, 64] bf16, contiguous. The scale is applied ONCE,
// to the f32 score: the caller passes scale2 * log2(e) with
// scale2 = (1/sqrt(sqrt(hd)))^2 = 1/sqrt(hd), the product of the two
// per-operand scales of the plain formula (unet.py:659-662, which scales
// q and k by 1/sqrt(sqrt(hd)) each in the activation dtype).
//
// What bounds it on an H100: 4*T*T*64 flops per head (two products)
// against 4*T*64*2 bytes, so it is bound by operations: at T = 7125 and
// 4 heads, 52 GFLOP, ~0.05 ms at the 989 TFLOP/s bf16 tensor-core peak.
// The T x T score matrix is what a plain version writes to device memory
// (812 MB in f32 at T = 7125); this kernel keeps it on chip.
// Design: one block of four warps per (bh, 64-query tile); the block walks
// 64-key tiles of K and V staged in shared memory. Each warp owns 16 query
// rows: S = Q K^T by bf16 WMMA (16x16x16, f32 accumulate) into shared
// memory, an online-softmax update in f32 (running max m and sum l per
// row, exp2 with the scale folded in), P rounded to bf16, and
// O = corr * O + P V by WMMA with O kept in shared memory in f32 so the
// per-row rescale is a plain store. The TPU kernel's 512/1024 blocks and
// segment-id padding (unet.py:611-630) are VMEM tiling and do not carry
// over: keys past T are masked to -inf, queries past T are not written.
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int HD = 64;       // head dimension
constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per tile
constexpr int NW = BQ / 16;  // warps, 16 query rows each
constexpr int LDH = HD + 8;  // bf16 row stride in shared memory (elements)
constexpr int LDF = HD + 4;  // f32 row stride in shared memory (elements)

struct Smem {
  bf16 q[BQ][LDH];
  bf16 k[BK][LDH];
  bf16 v[BK][LDH];
  bf16 p[BQ][LDH];
  float s[BQ][LDF];
  float o[BQ][LDF];
  float m[BQ];
  float l[BQ];
};

__device__ __forceinline__ void load_tile(bf16 (*dst)[LDH], const bf16* src,
                                          int row0, int T, int tid) {
  // 64 rows x 64 bf16 as 16-byte vectors; rows past T are zero
  for (int i = tid; i < 64 * (HD / 8); i += NW * 32) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

__global__ void __launch_bounds__(NW * 32)
    flash_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      int T, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * T * HD;
  const int r0 = warp * 16;  // this warp's query rows

  load_tile(sm.q, q + base, q0, T, tid);
  for (int i = tid; i < BQ * HD; i += NW * 32) sm.o[i / HD][i % HD] = 0.f;
  if (tid < BQ) {
    sm.m[tid] = -INFINITY;
    sm.l[tid] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile(sm.k, k + base, k0, T, tid);
    load_tile(sm.v, v + base, k0, T, tid);
    __syncthreads();

    // S[r0:r0+16, :] = Q K^T
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, &sm.q[r0][kk * 16], LDH);
        wmma::load_matrix_sync(fb, &sm.k[j * 16][kk * 16], LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&sm.s[r0][j * 16], acc, LDF,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: two lanes per row, interleaved columns
    {
      const int r = r0 + (lane >> 1);
      const int half = lane & 1;
      float mx = -INFINITY;
      for (int c = half; c < BK; c += 2) {
        const float sv =
            (k0 + c < T) ? sm.s[r][c] * scale_log2 : -INFINITY;
        sm.s[r][c] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: key k0 is < T
      const float corr = exp2f(m_old - m_new);
      float sum = 0.f;
      for (int c = half; c < BK; c += 2) {
        const float p = exp2f(sm.s[r][c] - m_new);
        sum += p;
        sm.p[r][c] = __float2bfloat16(p);
        sm.o[r][c] *= corr;  // BK == HD: the same columns of O
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();  // both lanes have read m[r] and l[r]
      if (half == 0) {
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * corr + sum;
      }
    }
    __syncwarp();

    // O[r0:r0+16, :] += P V
    for (int d = 0; d < HD / 16; ++d) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, &sm.o[r0][d * 16], LDF,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, &sm.p[r0][kk * 16], LDH);
        wmma::load_matrix_sync(fb, &sm.v[kk * 16][d * 16], LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(&sm.o[r0][d * 16], acc, LDF,
                              wmma::mem_row_major);
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * HD; i += 32) {
    const int r = r0 + i / HD, c = i % HD;
    if (q0 + r < T)
      out[base + (size_t)(q0 + r) * HD + c] =
          __float2bfloat16(sm.o[r][c] / sm.l[r]);
  }
}

}  // namespace

// q, k, v, out: [BH, T, 64] bf16, contiguous, 16-byte aligned.
// scale_log2 = (scale applied to q.k) * log2(e). Returns cudaGetLastError().
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int BH, int T, float scale_log2,
                                 void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, BH);
  flash_attn_kernel<<<grid, NW * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), T, scale_log2);
  return (int)cudaGetLastError();
}

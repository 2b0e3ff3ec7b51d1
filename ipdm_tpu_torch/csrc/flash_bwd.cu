// Backward of flash attention for head dimension 64, bf16 or f32 operands,
// f32 sums, on the CUDA cores (SIMT).
//
// Replaces the two Pallas kernels of the TPU flash attention's backward
// that ipdm_tpu/models/unet.py:601 _flash_attention reaches when the JAX
// package trains (jax/experimental/pallas/ops/tpu/flash_attention.py:253
// _flash_attention_bwd): _flash_attention_bwd_dkv (:940) and
// _flash_attention_bwd_dq (:1286), and the di = sum(o * do) before them
// (:272). With c = scale2 (the one scale of the forward, applied to the
// f32 score) and lse the forward's natural-log normaliser per query row:
//
//   P    = exp(c * Q K^T - lse)         (rebuilt, never stored)
//   D    = rowsum(dO * O)               flash_bwd_dot_kernel
//   dV   = P^T dO                       flash_bwd_dkv_kernel
//   dS   = P * (dO V^T - D)
//   dK   = c * dS^T Q                   flash_bwd_dkv_kernel
//   dQ   = c * dS K                     flash_bwd_dq_kernel
//
// q, k, v, o, do, dq, dk, dv: [BH, T, 64] of one element type E (bf16 or
// f32), contiguous; lse, D: [BH, T] f32. The gradients are with respect to
// the unscaled q and k, so each carries c once.
//
// No atomics: as the JAX library splits the work, one kernel owns dK and dV
// per key tile (walking every query tile) and the other owns dQ per query
// tile (walking every key tile), so each output has one writer and a fixed
// sum order, and two launches give the same bits.
//
// What bounds them on an H100: 5 products of T*T*64 multiply-adds per head
// (10*T*T*64 operations; 0.13 ms at T = 7125 and 4 heads at the bf16
// tensor-core rate, 1.94 ms at the f32 rate). These first kernels run
// every product on the CUDA cores in f32 for both element types (bf16
// operands are widened as they are staged), and recompute S and dP in both
// kernels (14*T*T*64 operations): simple first; wgmma and TMA are later
// work. The T x T matrices never leave the SM.
//
// Ragged T: rows >= T of every tile are staged as zeros; keys >= T get
// P = 0 (the score's -inf) in the dQ kernel, query rows >= T get P = 0 in
// the dK/dV kernel; rows >= T are never written.
#include "flash_simt.cuh"

namespace {

using namespace ipdm::flash;
using bf16 = __nv_bfloat16;

// D[r] = sum_d o[r][d] * do[r][d], one warp per row
template <typename E>
__global__ void __launch_bounds__(NT)
    flash_bwd_dot_kernel(const E* __restrict__ o, const E* __restrict__ dout,
                         float* __restrict__ D, int rows) {
  const int r = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t at = (size_t)r * HD + 2 * lane;
  float acc = ipdm::to_f32(o[at]) * ipdm::to_f32(dout[at]) +
              ipdm::to_f32(o[at + 1]) * ipdm::to_f32(dout[at + 1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[r] = acc;
}

// the rows' log2-domain normalisers and D of a query tile; rows >= T get
// lse2 = +inf and D = 0, so their P and dS are 0
__device__ __forceinline__ void load_rows(float* lse2, float* Dr,
                                          const float* lse, const float* D,
                                          int row0, int T) {
  for (int r = threadIdx.x; r < TILE; r += NT) {
    const bool live = row0 + r < T;
    lse2[r] = live ? lse[row0 + r] * LOG2E : INFINITY;
    Dr[r] = live ? D[row0 + r] : 0.f;
  }
}

struct DqSmem {
  Tile q, dout, k, v, ds;
  float lse2[TILE], Dr[TILE];
};

// one block = 64 query rows of one head: dQ over every key tile
template <typename E>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, E* __restrict__ dq,
                        int T, float scale_log2, float scale2) {
  extern __shared__ float smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * TILE;
  const size_t base = (size_t)bh * T * HD;
  const int nk = (T + TILE - 1) / TILE;

  load_tile(sm.q, q + base, q0, T);
  load_tile(sm.dout, dout + base, q0, T);
  load_rows(sm.lse2, sm.Dr, lse + (size_t)bh * T, D + (size_t)bh * T, q0, T);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // every thread is done with the last K, V and dS
    load_tile(sm.k, k + base, kt * TILE, T);
    load_tile(sm.v, v + base, kt * TILE, T);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows(s, sm.q, sm.k, ty, tx);
    dot_rows(dp, sm.dout, sm.v, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = kt * TILE + tx + 16 * j < T;
        const float p =
            live ? exp2f(fmaf(s[i][j], scale_log2, -sm.lse2[r])) : 0.f;
        sm.ds[r][tx + 16 * j] = p * (dp[i][j] - sm.Dr[r]);
      }
    }
    __syncthreads();
    mul_tile(acc, sm.ds, sm.k, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[base + (size_t)r * HD + tx + 16 * j] =
          ipdm::from_f32<E>(acc[i][j] * scale2);
  }
}

struct DkvSmem {
  Tile k, v, q, dout, pt, dst;
  float lse2[TILE], Dr[TILE];
};

// one block = 64 keys of one head: dK and dV over every query tile. Thread
// (ty, tx) holds P^T and dS^T at keys ty + 16 i, queries tx + 16 j, and dK,
// dV at keys ty + 16 i, columns tx + 16 j.
template <typename E>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ D, E* __restrict__ dk,
                         E* __restrict__ dv, int T, float scale_log2,
                         float scale2) {
  extern __shared__ float smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, k0 = blockIdx.x * TILE;
  const size_t base = (size_t)bh * T * HD;
  const int nq = (T + TILE - 1) / TILE;

  load_tile(sm.k, k + base, k0, T);
  load_tile(sm.v, v + base, k0, T);
  float ak[4][4], av[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ak[i][j] = av[i][j] = 0.f;

  for (int qt = 0; qt < nq; ++qt) {
    __syncthreads();  // every thread is done with the last Q, dO, P, dS
    load_tile(sm.q, q + base, qt * TILE, T);
    load_tile(sm.dout, dout + base, qt * TILE, T);
    load_rows(sm.lse2, sm.Dr, lse + (size_t)bh * T, D + (size_t)bh * T,
              qt * TILE, T);
    __syncthreads();
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    dot_rows(st, sm.k, sm.q, ty, tx);
    dot_rows(dpt, sm.v, sm.dout, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
      const bool live = qt * TILE + r < T;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p =
            live ? exp2f(fmaf(st[i][j], scale_log2, -sm.lse2[r])) : 0.f;
        sm.pt[ty + 16 * i][r] = p;
        sm.dst[ty + 16 * i][r] = p * (dpt[i][j] - sm.Dr[r]);
      }
    }
    __syncthreads();
    mul_tile(av, sm.pt, sm.dout, ty, tx);
    mul_tile(ak, sm.dst, sm.q, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t at = base + (size_t)r * HD + tx + 16 * j;
      dk[at] = ipdm::from_f32<E>(ak[i][j] * scale2);
      dv[at] = ipdm::from_f32<E>(av[i][j]);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename E>
int dq_launch(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* D, void* dq, int BH,
              int T, float scale_log2, float scale2, cudaStream_t st) {
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    const cudaError_t e =
        set_smem(flash_bwd_dq_kernel<E>, (int)sizeof(DqSmem));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int rows = BH * T;
  flash_bwd_dot_kernel<E><<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      static_cast<const E*>(o), static_cast<const E*>(dout),
      static_cast<float*>(D), rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + TILE - 1) / TILE, BH);
  flash_bwd_dq_kernel<E><<<grid, NT, sizeof(DqSmem), st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<E*>(dq), T, scale_log2, scale2);
  return (int)cudaGetLastError();
}

template <typename E>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* D, void* dk, void* dv, int BH,
               int T, float scale_log2, float scale2, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        set_smem(flash_bwd_dkv_kernel<E>, (int)sizeof(DkvSmem));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((T + TILE - 1) / TILE, BH);
  flash_bwd_dkv_kernel<E><<<grid, NT, sizeof(DkvSmem), st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<E*>(dk), static_cast<E*>(dv), T, scale_log2, scale2);
  return (int)cudaGetLastError();
}

}  // namespace

// D = rowsum(o * do), then dQ. q, k, v, o, do, dq: [BH, T, 64] bf16
// (is_bf16 = 1) or f32, contiguous, 16-byte aligned; lse, D: [BH, T] f32 (D
// written here, read by flash_bwd_dkv_launch). scale_log2 = scale2 *
// log2(e). Returns cudaGetLastError().
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse, void* D,
                                   void* dq, int BH, int T, float scale_log2,
                                   float scale2, int is_bf16, void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dq_launch<bf16>(q, k, v, o, dout, lse, D, dq, BH, T,
                                scale_log2, scale2, st)
              : dq_launch<float>(q, k, v, o, dout, lse, D, dq, BH, T,
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
  return is_bf16 ? dkv_launch<bf16>(q, k, v, dout, lse, D, dk, dv, BH, T,
                                 scale_log2, scale2, st)
              : dkv_launch<float>(q, k, v, dout, lse, D, dk, dv, BH, T,
                                  scale_log2, scale2, st);
}

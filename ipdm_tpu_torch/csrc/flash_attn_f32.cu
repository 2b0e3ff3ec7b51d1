// Forward flash attention for head dimension 64 in f32: f32 in and out,
// f32 scores and sums, on the CUDA cores (SIMT).
//
// The f32 counterpart of flash_attn.cu's bf16 wgmma kernel, for the same
// TPU flash kernel (ipdm_tpu/models/unet.py:601 _flash_attention, which the
// JAX package runs for any activation dtype): the shipped presets run their
// UNets with f32 activations (compute_dtype "float32").
//
//   out[bh,t,:] = sum_s softmax_s(scale2 * q[bh,t,:] . k[bh,s,:]) v[bh,s,:]
//
// q, k, v, out: [BH, T, 64] f32, contiguous. The caller passes
// scale_log2 = scale2 * log2(e); the scale is applied once, to the f32
// score. With lse != nullptr the kernel also writes
// lse[bh, t] = log(sum_s exp(scale2 * q.k)), the natural-log softmax
// normaliser that the backward kernels (flash_bwd.cu) rebuild P from.
//
// What bounds it on an H100: its 4*T*T*64 f32 multiply-adds per head on
// the CUDA cores (67 TFLOP/s; 0.78 ms at T = 7125 and 4 heads). No TF32
// tensor-core product: its 10-bit mantissa would not meet an f32
// tolerance. The T x T score matrix never leaves the SM.
//
// Design (one block = 64 query rows of one head, 256 threads): the Q tile
// stays in shared memory; each 64-key tile of K and V is staged in turn;
// S = Q K^T is a 4 x 4 register tile per thread (flash_simt.cuh); the
// online softmax reduces each row over its half-warp; P goes through
// shared memory for O += P V. Keys >= T score -inf; query rows >= T are not
// written. Shared memory 66.5 KB: three blocks per SM.
#include "flash_simt.cuh"

namespace {

using namespace ipdm::flash;

struct Smem {
  Tile q, k, v, p;
};

__global__ void __launch_bounds__(NT)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, int T, float scale_log2) {
  extern __shared__ float smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * TILE;
  const size_t base = (size_t)bh * T * HD;
  const int nk = (T + TILE - 1) / TILE;

  load_tile(sm.q, q + base, q0, T);
  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // every thread is done with the last K, V and P
    load_tile(sm.k, k + base, kt * TILE, T);
    load_tile(sm.v, v + base, kt * TILE, T);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    dot_rows(s, sm.q, sm.k, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = kt * TILE + tx + 16 * j < T ? s[i][j] * scale_log2
                                               : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // finite: every key tile holds at least one key < T
      const float mn = fmaxf(m[i], row_max(mx));
      const float corr = exp2f(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mn);
        sum += p;
        sm.p[ty + 16 * i][tx + 16 * j] = p;
        o[i][j] *= corr;
      }
      l[i] = l[i] * corr + sum;  // this thread's partial row sum
      m[i] = mn;
    }
    __syncthreads();
    mul_tile(o, sm.p, sm.v, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const float total = row_sum(l[i]);
    if (r >= T) continue;
    const float inv = 1.f / total;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[base + (size_t)r * HD + tx + 16 * j] = o[i][j] * inv;
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * T + r] = (m[i] + log2f(total)) * LN2;
  }
}

}  // namespace

// q, k, v, out: [BH, T, 64] f32, contiguous, 16-byte aligned; lse: [BH, T]
// f32 or null. scale_log2 = (scale applied to q.k) * log2(e). Returns
// cudaGetLastError().
extern "C" int flash_attn_f32_launch(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int BH, int T, float scale_log2,
                                     void* stream) {
  if (BH < 1 || BH > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((T + TILE - 1) / TILE, BH);
  flash_fwd_f32_kernel<<<grid, NT, sizeof(Smem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), T, scale_log2);
  return (int)cudaGetLastError();
}

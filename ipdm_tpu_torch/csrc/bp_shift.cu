// Two-tap shifted-window backprojection accumulate, batched and single.
//
// Replaces the Pallas TPU kernels ipdm_tpu/ops/pallas/shift.py:119
// bp_shift_accumulate_batched (body _bp2_kernel :73) and :193
// bp_shift_accumulate (body _bp_kernel :168; the same sum for one signal
// per view, Q2 [V,L] -> [n,n], entry bp_shift_single_launch below):
//
//   out[b,y,j] = sum_v (1 - f[v,y]) * Q[v,b,s0[v,y]+j] + f[v,y] * Q[v,b,s1[v,y]+j]
//
// Q: [V,B,L] f32; s0, s1: [V,n] int32 with s + n - 1 < L (checked by the
// wrapper); f: [V,n] f32; out: [B,n,n] f32.
//
// What bounds it on an H100: the function reads Q once (V*B*L*4 bytes,
// ~25 MB per view group at SIEMENS_FBP, B=4) and writes B*n*n*4 bytes, so
// its device-memory bound is ~10 us; the work is 2*V*B*n*n taps, served
// from L1/L2 because neighbouring rows y read overlapping windows of the
// same view. Design: one thread per output element (b,y,j), with j along
// threadIdx.x so each warp reads 32 consecutive floats of Q per tap; the
// view loop runs inside the thread with an f32 register sum, so there are
// no atomics and the result is deterministic (views are added in order,
// like the TPU kernel's sequential grid). The per-(v,y) starts and weights
// are the same for the whole block and are broadcast loads. The TPU roll
// tables and 128-aligned window bases (shift.py:63-70, :93-97) exist for
// the TPU's lane-aligned dynamic slices and have no counterpart here.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BJ = 128;  // threads along j

__global__ void __launch_bounds__(BJ)
    bp_shift_kernel(const float* __restrict__ Q, const int* __restrict__ s0,
                    const int* __restrict__ s1, const float* __restrict__ frac,
                    float* __restrict__ out, int V, int B, int L, int n) {
  const int j = blockIdx.x * BJ + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= n) return;
  const float* qb = Q + (size_t)b * L + j;
  const size_t vstride = (size_t)B * L;
  float acc = 0.f;
  for (int v = 0; v < V; ++v) {
    const int t = v * n + y;
    const int i0 = __ldg(s0 + t), i1 = __ldg(s1 + t);
    const float f = __ldg(frac + t);
    const float* q = qb + v * vstride;
    acc += (1.f - f) * __ldg(q + i0) + f * __ldg(q + i1);
  }
  out[((size_t)b * n + y) * n + j] = acc;
}

}  // namespace

extern "C" int bp_shift_launch(const void* Q, const void* s0, const void* s1,
                               const void* frac, void* out, int V, int B,
                               int L, int n, void* stream) {
  if (V < 0 || B < 1 || n < 1 || L < n) return (int)cudaErrorInvalidValue;
  dim3 grid((n + BJ - 1) / BJ, n, B);
  bp_shift_kernel<<<grid, BJ, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Q), static_cast<const int*>(s0),
      static_cast<const int*>(s1), static_cast<const float*>(frac),
      static_cast<float*>(out), V, B, L, n);
  return (int)cudaGetLastError();
}

// Q2: [V,L] f32, one signal per view; out: [n,n]. The batched kernel at
// B = 1: the view stride is L and the grid has one z plane. The TPU
// kernel's multiple-of-8 view count is its block size and is not needed.
extern "C" int bp_shift_single_launch(const void* Q2, const void* s0,
                                      const void* s1, const void* frac,
                                      void* out, int V, int L, int n,
                                      void* stream) {
  if (V < 0 || n < 1 || L < n) return (int)cudaErrorInvalidValue;
  dim3 grid((n + BJ - 1) / BJ, n, 1);
  bp_shift_kernel<<<grid, BJ, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Q2), static_cast<const int*>(s0),
      static_cast<const int*>(s1), static_cast<const float*>(frac),
      static_cast<float*>(out), V, 1, L, n);
  return (int)cudaGetLastError();
}

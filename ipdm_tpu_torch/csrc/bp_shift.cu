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
// its device-memory bound is ~10 us; its 2*V*B*n*n taps are 4 flops each,
// 0.03 ms at the f32 rate. Each tap is one 4-byte load by one lane from
// L1 (the rows of a block read overlapping windows of the same view), so
// what sets the time is the SM's load path: a warp's 32 consecutive floats
// at an unaligned start span two cache lines, and the 1e9 taps of a
// batched FBP view group are 3.3e7 such warp loads.
//
// Design: the gather of bp_gather.cuh (one warp per row, each lane 4
// columns x up to 4 images in registers, the views taken in groups whose
// loads are all in flight before their sums; a fixed view order, no
// atomics, so two launches give the same bits). The starts are general:
// the FBP's flat layout puts s0 and s1 in different k-planes, so both taps
// are loaded.
// The single-signal entry is the batched kernel at B = 1, its own launch.
// The TPU roll tables and 128-aligned window bases (shift.py:63-70, :93-97)
// exist for the TPU's lane-aligned dynamic slices and have no counterpart.
#include "bp_gather.cuh"

namespace {

using ipdm::kBpCols;
using ipdm::kBpWarps;

template <int NB>
__global__ void __launch_bounds__(32 * kBpWarps)
    bp_shift_kernel(const float* __restrict__ Q, const int* __restrict__ s0,
                    const int* __restrict__ s1, const float* __restrict__ frac,
                    float* __restrict__ out, int V, int B, int L, int n) {
  using Gather = ipdm::BpGather<NB, kBpCols, false, false>;
  __shared__ typename Gather::Smem sm;
  const int lane = threadIdx.x & 31;
  const int y0 = blockIdx.y * kBpWarps;
  const int y = y0 + (threadIdx.x >> 5);
  const int j0 = blockIdx.x * 32 * kBpCols;
  const int b0 = blockIdx.z * NB;
  Gather g;
  g.run(sm, Q, (size_t)B * L, L, s0, s1, frac, V, n, y0, j0, b0);
  if (y >= n) return;  // whole warps
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float* o = out + ((size_t)(b0 + b) * n + y) * n + j0 + lane;
#pragma unroll
    for (int k = 0; k < kBpCols; ++k)
      if (j0 + lane + 32 * k < n) o[32 * k] = g.out(b, k, lane);
  }
}

int launch(const void* Q, const void* s0, const void* s1, const void* frac,
           void* out, int V, int B, int L, int n, void* stream) {
  if (V < 0 || B < 1 || n < 1 || L < n) return (int)cudaErrorInvalidValue;
  const int nb = B % 4 == 0 ? 4 : 1;  // images per block
  const dim3 grid((n + 32 * kBpCols - 1) / (32 * kBpCols),
                  (n + kBpWarps - 1) / kBpWarps, B / nb);
  auto* k = nb == 4 ? bp_shift_kernel<4> : bp_shift_kernel<1>;
  k<<<grid, 32 * kBpWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Q), static_cast<const int*>(s0),
      static_cast<const int*>(s1), static_cast<const float*>(frac),
      static_cast<float*>(out), V, B, L, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bp_shift_launch(const void* Q, const void* s0, const void* s1,
                               const void* frac, void* out, int V, int B,
                               int L, int n, void* stream) {
  return launch(Q, s0, s1, frac, out, V, B, L, n, stream);
}

// Q2: [V,L] f32, one signal per view; out: [n,n]. The batched kernel at
// B = 1. The TPU kernel's multiple-of-8 view count is its block size and is
// not needed.
extern "C" int bp_shift_single_launch(const void* Q2, const void* s0,
                                      const void* s1, const void* frac,
                                      void* out, int V, int L, int n,
                                      void* stream) {
  return launch(Q2, s0, s1, frac, out, V, 1, L, n, stream);
}

// Two-tap row deposit into per-view signals, batched and single.
//
// Replaces the Pallas TPU kernels ipdm_tpu/ops/pallas/shift.py:354
// fp_shift_deposit_batched (body _fp3_kernel :326) and :625
// fp_shift_deposit (body _fp_kernel :597):
//
//   out[v,b,s_t[v,y]+j] += w_t[v,y] * rows[y,b,j],   t in {0,1}
//
// batched: rows [n,B,W] -> out [V,B,L]; single: rows [n,W] -> out [V,L].
// s0, s1: [V,n] int32 with 0 <= s and s + W <= L (checked by the wrapper);
// w0, w1: [V,n] f32. The TPU kernels write each deposit through a
// 128-aligned base and a lane roll, which is where their 128-multiples of
// W and L and their start limit L - W - 128 come from; none of it applies
// here.
//
// Both use the gather form of fp_deposit.cuh (each bin sums the taps that
// land on it, rows in order: one writer per output, no atomics, the same
// sum order as fp_deposit.cu, so the three deposits agree bit for bit).
// The batched kernel differs from fp_deposit.cu in its thread mapping: one
// block per (view, tile of bins) serves every batch item, so a view's
// 4n starts and weights are staged once for the whole batch and the
// per-row window test is made once for up to NB items, which keep their
// sums in registers.
//
// What bounds them on an H100, at the full-width projector's shapes (n =
// W = 512, V = 504, L = 2560, B = 2): rows read once and out written once
// are 2 MB + 10 MB, ~4 us of device memory; the taps are 2 * 2 flops per
// (v, y, b, j), 1.1 GFLOP, ~16 us at the f32 rate.
#include "common.cuh"
#include "fp_deposit.cuh"

namespace {

constexpr int BT = 256;  // threads along the bins
constexpr int NB = 4;    // batch items per pass of the row loop

__device__ __forceinline__ void stage_taps(const ipdm::FpTaps& taps,
                                           const int* s0, const int* s1,
                                           const float* w0, const float* w1,
                                           size_t off, int n) {
  for (int y = threadIdx.x; y < n; y += BT) {
    taps.s0[y] = s0[off + y];
    taps.s1[y] = s1[off + y];
    taps.w0[y] = w0[off + y];
    taps.w1[y] = w1[off + y];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(BT)
    fp_shift_deposit_batched_kernel(const float* __restrict__ rows,
                                    const int* __restrict__ s0,
                                    const int* __restrict__ s1,
                                    const float* __restrict__ w0,
                                    const float* __restrict__ w1,
                                    float* __restrict__ out, int B, int W,
                                    int L, int n) {
  extern __shared__ unsigned char smem[];
  const ipdm::FpTaps taps = ipdm::fp_taps_smem(smem, n);
  const int v = blockIdx.y;
  stage_taps(taps, s0, s1, w0, w1, (size_t)v * n, n);
  const int t = blockIdx.x * BT + threadIdx.x;
  if (t >= L) return;
  const size_t row_stride = (size_t)B * W;
  for (int b0 = 0; b0 < B; b0 += NB) {
    const int nb = min(NB, B - b0);
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    for (int y = 0; y < n; ++y) {
      const int i0 = t - taps.s0[y];
      const int i1 = t - taps.s1[y];
      const bool in0 = (unsigned)i0 < (unsigned)W;
      const bool in1 = (unsigned)i1 < (unsigned)W;
      if (!(in0 || in1)) continue;
      const float* r = rows + (size_t)y * row_stride + (size_t)b0 * W;
      const float a0 = taps.w0[y], a1 = taps.w1[y];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < nb) {
          if (in0) acc[b] += a0 * __ldg(r + (size_t)b * W + i0);
          if (in1) acc[b] += a1 * __ldg(r + (size_t)b * W + i1);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) out[((size_t)v * B + b0 + b) * L + t] = acc[b];
  }
}

__global__ void __launch_bounds__(BT)
    fp_shift_deposit_kernel(const float* __restrict__ rows,
                            const int* __restrict__ s0,
                            const int* __restrict__ s1,
                            const float* __restrict__ w0,
                            const float* __restrict__ w1,
                            float* __restrict__ out, int W, int L, int n) {
  extern __shared__ unsigned char smem[];
  const ipdm::FpTaps taps = ipdm::fp_taps_smem(smem, n);
  const int v = blockIdx.y;
  stage_taps(taps, s0, s1, w0, w1, (size_t)v * n, n);
  const int t = blockIdx.x * BT + threadIdx.x;
  if (t >= L) return;
  out[(size_t)v * L + t] = ipdm::fp_gather(rows, (size_t)W, W, n, t, taps);
}

}  // namespace

extern "C" int fp_shift_deposit_batched_launch(
    const void* rows, const void* s0, const void* s1, const void* w0,
    const void* w1, void* out, int V, int B, int W, int L, int n,
    void* stream) {
  const int smem = ipdm::fp_taps_bytes(n);
  if (V < 1 || B < 1 || n < 1 || W < 1 || L < W || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + BT - 1) / BT, V);
  fp_shift_deposit_batched_kernel<<<grid, BT, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(s0),
      static_cast<const int*>(s1), static_cast<const float*>(w0),
      static_cast<const float*>(w1), static_cast<float*>(out), B, W, L, n);
  return (int)cudaGetLastError();
}

extern "C" int fp_shift_deposit_launch(const void* rows, const void* s0,
                                       const void* s1, const void* w0,
                                       const void* w1, void* out, int V,
                                       int W, int L, int n, void* stream) {
  const int smem = ipdm::fp_taps_bytes(n);
  if (V < 1 || n < 1 || W < 1 || L < W || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + BT - 1) / BT, V);
  fp_shift_deposit_kernel<<<grid, BT, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(s0),
      static_cast<const int*>(s1), static_cast<const float*>(w0),
      static_cast<const float*>(w1), static_cast<float*>(out), W, L, n);
  return (int)cudaGetLastError();
}

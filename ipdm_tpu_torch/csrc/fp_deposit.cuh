// The two-tap row deposit of the fast SART forward projection, in gather
// form: the row loop shared by fp_deposit.cu (plane deposit) and
// fp_shift_deposit.cu (the two shift deposits).
//
// Deposit (the TPU kernels' scatter form):
//   out[t] += w0[y] * row_y[t - s0[y]]   for 0 <= t - s0[y] < W
//   out[t] += w1[y] * row_y[t - s1[y]]   for 0 <= t - s1[y] < W
// for every row y. Gather form: each output bin t sums, over the rows in
// order, the taps that land on it. Every output is written once by one
// thread and the sum runs over y in a fixed order, so the result is
// deterministic and needs no atomics. A thread visits all n rows and
// reads a row only when its window covers t; on the SART plans the window
// of a row is n wide and its start moves by at most one bin per row, so
// the rows that cover a bin are a contiguous run of about n of them and
// the reads are about L/(|a|*n) ~ 1-1.4x those of the scatter form.
#pragma once

#include <cuda_runtime.h>

namespace ipdm {

// one view's per-row starts and weights, staged in shared memory
struct FpTaps {
  int* s0;
  int* s1;
  float* w0;
  float* w1;
};

__device__ __forceinline__ FpTaps fp_taps_smem(unsigned char* smem, int n) {
  FpTaps k;
  k.s0 = reinterpret_cast<int*>(smem);
  k.s1 = k.s0 + n;
  k.w0 = reinterpret_cast<float*>(k.s1 + n);
  k.w1 = k.w0 + n;
  return k;
}

// bytes of shared memory fp_taps_smem needs for n rows
inline int fp_taps_bytes(int n) { return 16 * n; }

// sum over rows y of the taps that land on bin t; row y starts at
// rows + y * row_stride and is W wide
__device__ __forceinline__ float fp_gather(const float* __restrict__ rows,
                                           size_t row_stride, int W, int n,
                                           int t, const FpTaps& k) {
  float acc = 0.f;
  for (int y = 0; y < n; ++y) {
    const float* r = rows + (size_t)y * row_stride;
    const int i0 = t - k.s0[y];
    const int i1 = t - k.s1[y];
    if ((unsigned)i0 < (unsigned)W) {
      const float v = __ldg(r + i0);
      acc += k.w0[y] * v;
    }
    if ((unsigned)i1 < (unsigned)W) {
      const float v = __ldg(r + i1);
      acc += k.w1[y] * v;
    }
  }
  return acc;
}

}  // namespace ipdm

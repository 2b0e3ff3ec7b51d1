// Windowed multi-tap resample.
//
// Replaces the Pallas TPU kernel ipdm_tpu/ops/pallas/shift.py:702
// anterp_taps (body _wtr_kernel :675):
//
//   out[v,b,d] = sum_k W[v,k,d] * P[v,b,qi0[v,d]+k],   k = 0..Wt-1
//
// P: [V,B,Ntp] f32; qi0: [V,Lp] int32 with 0 <= qi0 and qi0 + Wt - 1 < Ntp
// (checked by the wrapper); W: [V,Wt,Lp] f32; out: [V,B,Lp] f32.
//
// What bounds it on an H100: the bytes. At the SART convert's resample
// (V=504 views, B=4, Wt=2, Lp~1400) it reads P (~7 MB), qi0 and W (~8 MB)
// and writes ~11 MB, about 8 us; the work is 2*Wt flops per output. Design:
// one thread per output (v, b, d) with d along threadIdx.x, so the index
// and weight reads and the output writes coalesce; the Wt taps are summed
// in order in a register. The TPU kernel's contract (monotone qi0 whose
// span inside a 128-bin block stays below 288) exists for its aligned
// window reads, roll and banded tap matrix on the MXU; here any qi0 inside
// the source row is taken.
#include "common.cuh"

namespace {

constexpr int BT = 256;  // threads along d

__global__ void __launch_bounds__(BT)
    anterp_taps_kernel(const float* __restrict__ P,
                       const int* __restrict__ qi0,
                       const float* __restrict__ W, float* __restrict__ out,
                       int B, int Ntp, int Lp, int Wt) {
  const int d = blockIdx.x * BT + threadIdx.x;
  const int b = blockIdx.y;
  const int v = blockIdx.z;
  if (d >= Lp) return;
  const float* p = P + ((size_t)v * B + b) * Ntp + __ldg(qi0 + (size_t)v * Lp + d);
  const float* w = W + (size_t)v * Wt * Lp + d;
  float acc = 0.f;
  for (int k = 0; k < Wt; ++k) acc += __ldg(w + (size_t)k * Lp) * __ldg(p + k);
  out[((size_t)v * B + b) * Lp + d] = acc;
}

}  // namespace

extern "C" int anterp_taps_launch(const void* P, const void* qi0,
                                  const void* W, void* out, int V, int B,
                                  int Ntp, int Lp, int Wt, void* stream) {
  if (V < 1 || B < 1 || Lp < 1 || Wt < 1 || Ntp < Wt)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Lp + BT - 1) / BT, B, V);
  anterp_taps_kernel<<<grid, BT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P), static_cast<const int*>(qi0),
      static_cast<const float*>(W), static_cast<float*>(out), B, Ntp, Lp, Wt);
  return (int)cudaGetLastError();
}

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
// What bounds it on an H100: the bytes, each input read once and the
// output written once (at the ART slice's resample, V=504, B=4, Wt=2,
// Lp=1157, Ntp=913: ~24 MB, ~7 us at 3.35 TB/s); the work is 2*Wt flops
// per output. Design: one thread per (v, d) that serves every batch item.
// It reads qi0[v,d] and its Wt weights once into registers (the earlier
// kernel, one thread per (v, b, d), read them B times), then for each item
// gathers the Wt taps and sums them in k order from 0, and writes the
// item's output; threads run along d, so the index, weight and output
// accesses coalesce, and the items are unrolled so that their gathers are
// in flight together. The taps of a warp's 32 outputs lie within a few
// cache lines of P (qi0 advances 0.8-2.5 per d on the main path), so the
// gathers are served by the lines the warp's first tap brought into L1:
// staging the window in shared memory would add a barrier and a copy and
// save no device-memory byte. The TPU kernel's contract (monotone qi0 whose
// span inside a 128-bin block stays below 288) exists for its aligned
// window reads, roll and banded tap matrix on the MXU; here any qi0 inside
// the source row is taken.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // outputs d per block

// WT > 0: the tap count as a constant (weights in registers); WT == 0:
// any Wt, the weights read in the item loop
template <int WT>
__global__ void __launch_bounds__(kThreads)
    anterp_taps_kernel(const float* __restrict__ P,
                       const int* __restrict__ qi0,
                       const float* __restrict__ W, float* __restrict__ out,
                       int B, int Ntp, int Lp, int Wt) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int v = blockIdx.y;
  if (d >= Lp) return;
  const float* p = P + (size_t)v * B * Ntp + __ldg(qi0 + (size_t)v * Lp + d);
  const float* wv = W + (size_t)v * Wt * Lp + d;
  float* o = out + (size_t)v * B * Lp + d;
  float w[WT > 0 ? WT : 1];
#pragma unroll
  for (int k = 0; k < WT; ++k) w[k] = __ldg(wv + (size_t)k * Lp);
#pragma unroll 4  // items whose gathers are in flight together
  for (int b = 0; b < B; ++b) {
    const float* pb = p + (size_t)b * Ntp;
    float acc = 0.f;
    if (WT > 0) {
#pragma unroll
      for (int k = 0; k < WT; ++k) acc = fmaf(w[k], __ldg(pb + k), acc);
    } else {
      for (int k = 0; k < Wt; ++k)
        acc = fmaf(__ldg(wv + (size_t)k * Lp), __ldg(pb + k), acc);
    }
    o[(size_t)b * Lp] = acc;
  }
}

template <int WT>
void launch(const float* P, const int* qi0, const float* W, float* out,
            int V, int B, int Ntp, int Lp, int Wt, cudaStream_t stream) {
  dim3 grid((Lp + kThreads - 1) / kThreads, V);
  anterp_taps_kernel<WT><<<grid, kThreads, 0, stream>>>(P, qi0, W, out, B,
                                                        Ntp, Lp, Wt);
}

}  // namespace

extern "C" int anterp_taps_launch(const void* P, const void* qi0,
                                  const void* W, void* out, int V, int B,
                                  int Ntp, int Lp, int Wt, void* stream) {
  if (V < 1 || V > 65535 || B < 1 || Lp < 1 || Wt < 1 || Ntp < Wt)
    return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const float*>(P);
  const auto* q = static_cast<const int*>(qi0);
  const auto* w = static_cast<const float*>(W);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (Wt) {  // the resample (2), the plan's (4), the projector's (6)
    case 2: launch<2>(p, q, w, o, V, B, Ntp, Lp, Wt, s); break;
    case 4: launch<4>(p, q, w, o, V, B, Ntp, Lp, Wt, s); break;
    case 6: launch<6>(p, q, w, o, V, B, Ntp, Lp, Wt, s); break;
    default: launch<0>(p, q, w, o, V, B, Ntp, Lp, Wt, s); break;
  }
  return (int)cudaGetLastError();
}

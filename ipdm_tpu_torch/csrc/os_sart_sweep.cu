// One OS-SART sweep over one drive axis's ordered subsets.
//
// Replaces the Pallas TPU kernel ipdm_tpu/ops/pallas/shift.py:544
// os_sart_sweep_mm (body _oss_mm_kernel :432), f32 operand mode. For each
// subset s in order, on the drive-frame image x [B,n,n]:
//
//   FP:   P[v,b,t] = sum_y (1-f[v,y]) x[b,y,t-s0[v,y]] + f[v,y] x[b,y,t-s0[v,y]-1]
//   corr: T[v,b,t] = rf[s,v,b,t] - P[v,b,t] * inv2[s,v,t]
//   BP:   x[b,y,j] += lam * nrmi[s,y,j] * sum_v (1-f) T[v,b,s0+j] + f T[v,b,s0+1+j]
//   clamp x >= 0
//
// with s0, f = frac the subset's [Vp,n] tables (the second tap starts at
// s0 + 1). rf: [S,Vp,B,L], inv2: [S,Vp,L], frac, s0: [S,Vp,n], nrmi:
// [S,n,n], all f32 but s0 (int32, 0 <= s0 and s0 + n < L, checked by the
// wrapper); T: a [Vp,B,L] scratch.
//
// A CUDA grid cannot carry x from one subset to the next the way the TPU
// grid does (its sequential grid revisits the image block), so the host
// loop below issues two dependent launches per subset on one stream, 2*S
// launches per call:
//  1. FP + correction: the gather-form deposit of fp_deposit.cuh, one
//     thread per (v, b, t) with t along threadIdx.x, the view's starts and
//     weights staged in shared memory; it writes T.
//  2. BP + update + clamp: one thread per (b, y, j) with j along
//     threadIdx.x, the subset's views summed in order in a register (the
//     bp_shift.cu loop), then the relaxed update and the clamp in place.
// Both sums run in a fixed order with no atomics: the sweep is
// deterministic. Pad views of a subset (s0 = 0, frac = 0, rf = inv2 = 0)
// get T = 0 and add nothing.
//
// What bounds it on an H100, per call at the SIEMENS_FBP main path (B=4,
// n=512, 32 subsets of 16 views, L=1408): the real tap work is 2 taps * 2
// flops * B*n*n per view for the FP and again for the BP, 4.2 GFLOP over
// 500 views, 0.063 ms at the f32 rate; the bytes, each input read once and
// x written once, are ~46 MB (rf 11.5 MB dominates), 0.014 ms. Re-read
// per subset (x 4 MB for the FP, 8 MB read+write for the BP, nrmi 1 MB,
// rf and inv2) the traffic is ~430 MB, but x, T and one subset's tables
// fit in the 50 MB L2. The TPU kernel's tap matrices for the MXU, its
// 128-residue plane scratch and its rolls exist for the TPU and have no
// counterpart: the taps are computed directly in f32.
#include "common.cuh"
#include "fp_deposit.cuh"

namespace {

constexpr int BT = 256;  // FP threads along t
constexpr int BJ = 128;  // BP threads along j

__global__ void __launch_bounds__(BT)
    sweep_fp_kernel(const float* __restrict__ x, const float* __restrict__ rf,
                    const float* __restrict__ inv2,
                    const float* __restrict__ frac,
                    const int* __restrict__ s0, float* __restrict__ T, int B,
                    int n, int L) {
  extern __shared__ unsigned char smem[];
  const ipdm::FpTaps taps = ipdm::fp_taps_smem(smem, n);
  const int b = blockIdx.y;
  const int v = blockIdx.z;
  const size_t off = (size_t)v * n;
  for (int y = threadIdx.x; y < n; y += BT) {
    const int s = s0[off + y];
    const float f = frac[off + y];
    taps.s0[y] = s;
    taps.s1[y] = s + 1;
    taps.w0[y] = 1.f - f;
    taps.w1[y] = f;
  }
  __syncthreads();
  const int t = blockIdx.x * BT + threadIdx.x;
  if (t >= L) return;
  const float p = ipdm::fp_gather(x + (size_t)b * n * n, n, n, n, t, taps);
  const size_t o = ((size_t)v * B + b) * L + t;
  T[o] = rf[o] - p * inv2[(size_t)v * L + t];
}

__global__ void __launch_bounds__(BJ)
    sweep_bp_kernel(const float* __restrict__ T, const int* __restrict__ s0,
                    const float* __restrict__ frac,
                    const float* __restrict__ nrmi, float* __restrict__ x,
                    int Vp, int B, int n, int L, float lam) {
  const int j = blockIdx.x * BJ + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (j >= n) return;
  const float* tb = T + (size_t)b * L + j;
  const size_t vstride = (size_t)B * L;
  float acc = 0.f;
  for (int v = 0; v < Vp; ++v) {
    const int k = v * n + y;
    const int s = __ldg(s0 + k);
    const float f = __ldg(frac + k);
    const float* q = tb + v * vstride + s;
    acc += (1.f - f) * __ldg(q) + f * __ldg(q + 1);
  }
  const size_t o = ((size_t)b * n + y) * n + j;
  x[o] = fmaxf(x[o] + lam * __ldg(nrmi + (size_t)y * n + j) * acc, 0.f);
}

}  // namespace

extern "C" int os_sart_sweep_launch(void* x, const void* rf, const void* inv2,
                                    const void* frac, const void* s0,
                                    const void* nrmi, void* T, int S, int Vp,
                                    int B, int n, int L, float lam,
                                    void* stream) {
  const int smem = ipdm::fp_taps_bytes(n);
  if (S < 1 || Vp < 1 || B < 1 || n < 1 || L <= n || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  float* Tf = static_cast<float*>(T);
  const float* rff = static_cast<const float*>(rf);
  const float* inv2f = static_cast<const float*>(inv2);
  const float* fracf = static_cast<const float*>(frac);
  const int* s0i = static_cast<const int*>(s0);
  const float* nrmif = static_cast<const float*>(nrmi);
  const dim3 fp_grid((L + BT - 1) / BT, B, Vp);
  const dim3 bp_grid((n + BJ - 1) / BJ, n, B);
  for (int s = 0; s < S; ++s) {
    const size_t tab = (size_t)s * Vp * n;
    sweep_fp_kernel<<<fp_grid, BT, smem, st>>>(
        xf, rff + (size_t)s * Vp * B * L, inv2f + (size_t)s * Vp * L,
        fracf + tab, s0i + tab, Tf, B, n, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sweep_bp_kernel<<<bp_grid, BJ, 0, st>>>(Tf, s0i + tab, fracf + tab,
                                            nrmif + (size_t)s * n * n, xf, Vp,
                                            B, n, L, lam);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

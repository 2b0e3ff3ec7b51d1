// Two-tap plane deposit: the forward projection of the fast SART's
// static norms.
//
// Replaces the Pallas TPU kernel ipdm_tpu/ops/pallas/shift.py:279
// fp_plane_deposit (body _fp2_kernel :240):
//
//   out[v,b,s_t[v,y]+j] += w_t[v,y] * rows[y,b,j],   t in {0,1}
//
// rows: [n,B,W] f32; s0, s1: [V,n] int32 with 0 <= s and s + W <= L
// (checked by the wrapper); w0, w1: [V,n] f32; out: [V,B,L] f32.
//
// What bounds it on an H100: it reads rows once (n*B*W*4 bytes, 1 MB at
// the SIEMENS_FBP norms) and writes V*B*L*4 bytes (2.8 MB for 504 views),
// about 1 us of device memory; the real work is 2 taps * 2 flops per
// (v, y, b, j), 0.5 GFLOP, ~8 us at the f32 rate. Design: gather form
// (fp_deposit.cuh), one thread per output (v, b, t) with t along
// threadIdx.x so neighbouring threads read neighbouring floats of a row
// and write neighbouring outputs. The view's 4n starts and weights are
// staged once per block in shared memory and read as broadcasts. The TPU
// kernel's 128-residue plane scratch and its 128-roll combine exist for
// the TPU's lane-aligned slices and have no counterpart here.
#include "common.cuh"
#include "fp_deposit.cuh"

namespace {

constexpr int BT = 256;  // threads along t

__global__ void __launch_bounds__(BT)
    fp_deposit_kernel(const float* __restrict__ rows,
                      const int* __restrict__ s0, const int* __restrict__ s1,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1, float* __restrict__ out,
                      int B, int W, int L, int n) {
  extern __shared__ unsigned char smem[];
  const ipdm::FpTaps taps = ipdm::fp_taps_smem(smem, n);
  const int b = blockIdx.y;
  const int v = blockIdx.z;
  const size_t off = (size_t)v * n;
  for (int y = threadIdx.x; y < n; y += BT) {
    taps.s0[y] = s0[off + y];
    taps.s1[y] = s1[off + y];
    taps.w0[y] = w0[off + y];
    taps.w1[y] = w1[off + y];
  }
  __syncthreads();
  const int t = blockIdx.x * BT + threadIdx.x;
  if (t >= L) return;
  out[((size_t)v * B + b) * L + t] =
      ipdm::fp_gather(rows + (size_t)b * W, (size_t)B * W, W, n, t, taps);
}

}  // namespace

extern "C" int fp_deposit_launch(const void* rows, const void* s0,
                                 const void* s1, const void* w0,
                                 const void* w1, void* out, int V, int B,
                                 int W, int L, int n, void* stream) {
  const int smem = ipdm::fp_taps_bytes(n);
  if (V < 1 || B < 1 || n < 1 || W < 1 || L < W || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + BT - 1) / BT, B, V);
  fp_deposit_kernel<<<grid, BT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(s0),
      static_cast<const int*>(s1), static_cast<const float*>(w0),
      static_cast<const float*>(w1), static_cast<float*>(out), B, W, L, n);
  return (int)cudaGetLastError();
}

// Fused GroupNorm-affine -> SiLU -> 3x3 conv (+ bias [+ skip]) over NCHW.
//
// Replaces the Pallas TPU kernel ipdm_tpu/ops/pallas/planar.py:190
// planar_unit (bodies _unit_kernel_v2 :61 and _unit_kernel :123):
//
//   out[b,o,h,w] = sum_{c,dh,dw} w[dh,dw,c,o] * act(a[b,c]*x[b,c,h+dh-1,w+dw-1]
//                                                   + bb[b,c])
//                  + bias[b,o] (+ skip[b,o,h,w])
//
// with zero padding applied AFTER the activation (a halo pixel outside the
// image contributes 0, not act(bb)). Accumulates in f32, writes x's type.
//
// What bounds it on an H100: the shallow sinogram levels (C, O <= 16 at
// 2000x912 and 1000x456) do 9*C*O FMAs per pixel against 2*(C+O[+O])
// bytes per pixel in bf16, so for C*O up to 160 the unit sits near the
// ridge between the 3.35 TB/s memory roof and the 67 TF/s f32 FMA roof
// (no tensor-core shape fits K = 9*C <= 144 with N = O <= 16 well).
// Design: one thread per output pixel of a 32x8 tile; the block stages the
// input tile plus a one-pixel halo in shared memory with act(a*x+bb)
// already applied (each input pixel is read from device memory ~1.3x, and
// the activation is evaluated once per staged pixel, not 9*O times); the
// 9*C*O weights sit in shared memory and are read as warp-wide broadcasts;
// up to 16 output channels accumulate in registers, larger O runs in
// chunks of 16 over grid.z. Channels are staged 8 at a time so the shared
// footprint stays ~17 KB at any C. The Pallas blocking (8-row halo blocks,
// lane rolls, VMEM-fit row counts, 8-channel splits of C >= 16) is TPU
// layout and is not carried over: C is never split, so bf16 results
// differ from the TPU v2 path by its one intermediate rounding at C >= 16.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int TW = 32;        // tile width  (threadIdx.x)
constexpr int TH = 8;         // tile height (threadIdx.y)
constexpr int CC = 8;         // input channels staged per pass
constexpr int MAX_CO = 160;   // caller gate C*O <= 160 (models/unet.py)

template <typename T, int OT>
__global__ void __launch_bounds__(TW* TH)
    planar_unit_kernel(const T* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ bb,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const T* __restrict__ skip, T* __restrict__ out, int C,
                       int O, int H, int W, int act, int n_ochunks) {
  __shared__ float tile[CC][TH + 2][TW + 2];
  __shared__ float sw[9 * MAX_CO];  // [dh*3+dw][c][o], HWIO order

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int b = blockIdx.z / n_ochunks;
  const int o0 = (blockIdx.z % n_ochunks) * OT;
  const int h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const int h = h0 + ty, wc = w0 + tx;
  const size_t plane = (size_t)H * W;

  for (int i = tid; i < 9 * C * O; i += TW * TH) sw[i] = w[i];

  float acc[OT];
#pragma unroll
  for (int o = 0; o < OT; ++o) acc[o] = 0.f;

  constexpr int HALO = (TH + 2) * (TW + 2);
  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nc = min(CC, C - c0);
    __syncthreads();  // the previous pass's tile is consumed
    for (int i = tid; i < nc * HALO; i += TW * TH) {
      const int cc = i / HALO, r = i % HALO;
      const int yy = r / (TW + 2), xx = r % (TW + 2);
      const int gy = h0 + yy - 1, gx = w0 + xx - 1;
      float v = 0.f;  // the conv's zero padding, after the activation
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int c = c0 + cc;
        const float xv =
            ipdm::to_f32(x[((size_t)b * C + c) * plane + (size_t)gy * W + gx]);
        v = fmaf(xv, a[b * C + c], bb[b * C + c]);
        if (act) v = v / (1.f + expf(-v));
      }
      tile[cc][yy][xx] = v;
    }
    __syncthreads();
    for (int cc = 0; cc < nc; ++cc) {
      const float* wc_base = sw + (size_t)(c0 + cc) * O + o0;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float v = tile[cc][ty + k / 3][tx + k % 3];
        const float* wk = wc_base + (size_t)k * C * O;
#pragma unroll
        for (int o = 0; o < OT; ++o)
          if (o0 + o < O) acc[o] = fmaf(v, wk[o], acc[o]);
      }
    }
  }
  if (h >= H || wc >= W) return;
#pragma unroll
  for (int o = 0; o < OT; ++o) {
    if (o0 + o >= O) break;
    const size_t idx = ((size_t)b * O + o0 + o) * plane + (size_t)h * W + wc;
    float r = acc[o] + bias[b * O + o0 + o];
    if (skip != nullptr) r += ipdm::to_f32(skip[idx]);
    out[idx] = ipdm::from_f32<T>(r);
  }
}

template <typename T, int OT>
void launch(const void* x, const void* a, const void* bb, const void* w,
            const void* bias, const void* skip, void* out, int B, int C,
            int O, int H, int W, int act, cudaStream_t stream) {
  const int n_ochunks = (O + OT - 1) / OT;
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_ochunks);
  planar_unit_kernel<T, OT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(bb), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(skip),
      static_cast<T*>(out), C, O, H, W, act, n_ochunks);
}

template <typename T>
void dispatch(const void* x, const void* a, const void* bb, const void* w,
              const void* bias, const void* skip, void* out, int B, int C,
              int O, int H, int W, int act, cudaStream_t s) {
  // smallest register tile that holds min(O, 16) output channels
  if (O <= 1)
    launch<T, 1>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act, s);
  else if (O <= 2)
    launch<T, 2>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act, s);
  else if (O <= 4)
    launch<T, 4>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act, s);
  else if (O <= 8)
    launch<T, 8>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act, s);
  else
    launch<T, 16>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act, s);
}

}  // namespace

// x, skip, out: [B,C,H,W] / [B,O,H,W] / [B,O,H,W] in f32 (bf16 == 0) or
// bf16 (bf16 == 1); a, bb: [B,C] f32; w: [3,3,C,O] f32; bias: [B,O] f32;
// skip may be null. Requires C*O <= 160. Returns cudaGetLastError().
extern "C" int planar_unit_launch(const void* x, const void* a, const void* bb,
                                  const void* w, const void* bias,
                                  const void* skip, void* out, int B, int C,
                                  int O, int H, int W, int act, int bf16,
                                  void* stream) {
  if (C * O > MAX_CO || C < 1 || O < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    dispatch<__nv_bfloat16>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act,
                            s);
  else
    dispatch<float>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act, s);
  return (int)cudaGetLastError();
}

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
// image contributes 0, not act(bb)). f32 arithmetic, as the TPU kernel's
// VPU multiply-adds; writes x's type.
//
// What bounds it on an H100: the shallow sinogram levels (C, O <= 16 at
// 2000x912 and 1000x456) do 9*C*O FMAs per pixel against 2*(C+O[+O])
// bytes per pixel in bf16. At the 67 TF/s f32 rate that is the larger
// bound for every main-path shape but the stem (1->4) and the output
// conv (8->1), so the unit is bound by f32 FMAs, barely above its bytes.
//
// Design: a block covers a 64-wide, 16-row output tile; each thread owns
// a strip of P adjacent pixels along W (P = 8, or 4 at O > 8) for all OT
// output channels of its chunk (O > 16 runs in chunks of 16 over grid.z),
// so its P*OT sums live in registers. Per input channel and kernel row
// the thread reads its P+2 activated input values as float4 vectors and
// the 3*OT weights of that row as float4 broadcasts, then issues 3*P*OT
// FMAs: each weight feeds P FMAs and each input value OT of them.
// The activated input tile (plus its one-pixel halo) is staged in shared
// memory, up to 8 channels per pass, so every main-path unit but C = 12
// and 16 stages once: each thread issues the 16-byte vector loads (8 bf16
// or 4 f32) of all the pass's channels before it uses any, computes
// silu(a*x+bb) once per staged value (fast exp and divide) and stores
// float4s; its index math is shifts and masks, computed once per row, not
// per channel. The 9*C*OT weights of the block's chunk and the C affine
// pairs sit in shared memory too. Every (C, O) with C*O <= 160 runs one of
// five instantiations per dtype, chosen by O alone. Where W is not a
// multiple of 8, or x, skip or out is not 16-byte aligned, the loads and
// stores go element by element. The Pallas blocking
// (8-row halo blocks, lane rolls, VMEM-fit row counts, 8-channel splits of
// C >= 16) is TPU layout and is not carried over: C is never split, so
// bf16 results differ from the TPU v2 path by its one intermediate
// rounding at C >= 16.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_CO = 160;  // caller gate C*O <= 160 (models/unet.py)
constexpr int TW = 64;       // tile width (pixels)
constexpr int TH = 16;       // tile rows
constexpr int RS = TW + 8;   // floats per staged row: columns -4 .. TW+3
constexpr int CC = 8;        // channels staged per pass
// weights of one chunk: 9*C*OT floats; OT < 2*O while O <= 16, and
// OT = 16 < O above, so C*OT < 2*MAX_CO; C <= MAX_CO affine pairs
constexpr int MAX_SMEM =
    (CC * (TH + 2) * RS + 9 * 2 * MAX_CO + 2 * MAX_CO) * (int)sizeof(float);

template <typename T>
struct Vec;  // 16-byte vector of T
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// P consecutive values at p (P a multiple of the vector width when vec)
template <typename T, int P>
__device__ __forceinline__ void load_strip(const T* p, float* v, bool vec,
                                          int n) {
  constexpr int VN = Vec<T>::N;
  if (vec && n == P && P % VN == 0) {
#pragma unroll
    for (int i = 0; i < P / VN; ++i) Vec<T>::load(p + i * VN, v + i * VN);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = i < n ? ipdm::to_f32(p[i]) : 0.f;
  }
}

template <typename T, int P>
__device__ __forceinline__ void store_strip(T* p, const float* v, bool vec,
                                           int n) {
  constexpr int VN = Vec<T>::N;
  if (vec && n == P && P % VN == 0) {
#pragma unroll
    for (int i = 0; i < P / VN; ++i) Vec<T>::store(p + i * VN, v + i * VN);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < n) p[i] = ipdm::from_f32<T>(v[i]);
  }
}

template <int P>
struct Tiling {
  static constexpr int NG = TW / P;   // thread columns (power of two)
  static constexpr int NT = NG * TH;  // threads per block
};

// shared-memory bytes of a launch: the activated tile of CC channels, the
// chunk's 9*C*OT weights, the C affine pairs
inline int smem_bytes(int C, int OT) {
  return (CC * (TH + 2) * RS + 9 * C * OT + 2 * C) * (int)sizeof(float);
}

template <typename T, int OT, int P>
__global__ void __launch_bounds__(Tiling<P>::NT)
    planar_unit_kernel(const T* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ bb,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const T* __restrict__ skip, T* __restrict__ out, int C,
                       int O, int H, int W, int act, int n_ochunks, int vec) {
  constexpr int NG = Tiling<P>::NG, NT = Tiling<P>::NT;
  constexpr int VN = Vec<T>::N;
  constexpr int VPR = TW / VN;             // vectors per tile row
  constexpr int NV4 = (P + 2 + 3 + 3) / 4; // float4 reads per strip row
  // tile[cc][r][i]: tile column i - 4 (-1 .. TW) of tile row r (image row
  // h0 + r - 1), activated, 0 outside the image
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* sw = smem + CC * (TH + 2) * RS;  // [c][dh*3+dw][o]
  float* sa = sw + 9 * C * OT;            // a[b, c], then bb[b, c]

  const int tid = threadIdx.x;
  const int g = tid % NG, ty = tid / NG;  // NG is a power of two
  const int b = blockIdx.z / n_ochunks;
  const int o0 = (blockIdx.z - b * n_ochunks) * OT;
  const int h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W;

  for (int i = tid; i < 9 * C * OT; i += NT) {
    const int o = i % OT, ck = i / OT, c = ck / 9, k = ck - 9 * c;
    sw[i] = o0 + o < O ? w[((size_t)k * C + c) * O + o0 + o] : 0.f;
  }
  for (int i = tid; i < C; i += NT) {
    sa[i] = a[b * C + i];
    sa[C + i] = bb[b * C + i];
  }

  float acc[P][OT];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int o = 0; o < OT; ++o) acc[p][o] = 0.f;

  const T* xb = x + (size_t)b * C * plane;
  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nc = min(CC, C - c0);
    __syncthreads();  // the weights are in; the previous pass is consumed
    // silu(a*x + bb) (or the affine alone) of channel c0 + cc
    auto activate = [&](int cc, float xv) {
      const float v = fmaf(xv, sa[c0 + cc], sa[C + c0 + cc]);
      return act ? __fdividef(v, 1.f + __expf(-v)) : v;
    };
    if (vec) {  // whole 16-byte vectors inside the image
      const int q = tid % VPR, gx = w0 + q * VN;
      for (int r = tid / VPR; r < TH + 2; r += NT / VPR) {
        const int gy = h0 + r - 1;
        const bool in = gy >= 0 && gy < H && gx < W;
        const T* src = xb + (size_t)c0 * plane + (size_t)gy * W + gx;
        float v[CC][VN];
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {  // every load before any use
          if (in && cc < nc)
            Vec<T>::load(src + cc * plane, v[cc]);
        }
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          if (cc >= nc) break;
          float* dst = tile + (cc * (TH + 2) + r) * RS + 4 + q * VN;
#pragma unroll
          for (int e = 0; e < VN; e += 4)
            *reinterpret_cast<float4*>(dst + e) =
                in ? make_float4(activate(cc, v[cc][e]),
                                 activate(cc, v[cc][e + 1]),
                                 activate(cc, v[cc][e + 2]),
                                 activate(cc, v[cc][e + 3]))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      const int col = tid % TW, gx = w0 + col;
      for (int r = tid / TW; r < TH + 2; r += NT / TW) {
        const int gy = h0 + r - 1;
        const bool in = gy >= 0 && gy < H && gx < W;
        const T* src = xb + (size_t)c0 * plane + (size_t)gy * W + gx;
        for (int cc = 0; cc < nc; ++cc)
          tile[(cc * (TH + 2) + r) * RS + 4 + col] =
              in ? activate(cc, ipdm::to_f32(src[cc * plane])) : 0.f;
      }
    }
    for (int t = tid; t < 2 * (TH + 2); t += NT) {  // the side halo
      const int r = t >> 1, col = (t & 1) ? TW : -1;
      const int gy = h0 + r - 1, gx = w0 + col;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* src = xb + (size_t)c0 * plane + (size_t)gy * W + gx;
      for (int cc = 0; cc < nc; ++cc)
        tile[(cc * (TH + 2) + r) * RS + 4 + col] =
            in ? activate(cc, ipdm::to_f32(src[cc * plane])) : 0.f;
    }
    __syncthreads();

    for (int cc = 0; cc < nc; ++cc) {
      const float* wc = sw + (c0 + cc) * 9 * OT;
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        // strip row: v[i] is tile column g*P + i - 4
        float v[4 * NV4];
        const float4* src = reinterpret_cast<const float4*>(
            tile + (cc * (TH + 2) + ty + dh) * RS + g * P);
#pragma unroll
        for (int i = 0; i < NV4; ++i) {
          const float4 t4 = src[i];
          v[4 * i] = t4.x;
          v[4 * i + 1] = t4.y;
          v[4 * i + 2] = t4.z;
          v[4 * i + 3] = t4.w;
        }
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          const float* wk = wc + (dh * 3 + dw) * OT;
          float wr[OT];
          if constexpr (OT % 4 == 0) {
#pragma unroll
            for (int i = 0; i < OT / 4; ++i) {
              const float4 t4 = reinterpret_cast<const float4*>(wk)[i];
              wr[4 * i] = t4.x;
              wr[4 * i + 1] = t4.y;
              wr[4 * i + 2] = t4.z;
              wr[4 * i + 3] = t4.w;
            }
          } else {
#pragma unroll
            for (int o = 0; o < OT; ++o) wr[o] = wk[o];
          }
          // pixel p, tap dw reads tile column g*P + p + dw - 1
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int o = 0; o < OT; ++o)
              acc[p][o] = fmaf(v[p + dw + 3], wr[o], acc[p][o]);
        }
      }
    }
  }

  const int h = h0 + ty, x0 = w0 + g * P;
  if (h >= H || x0 >= W) return;
  const int n = min(P, W - x0);
#pragma unroll
  for (int o = 0; o < OT; ++o) {
    if (o0 + o >= O) break;
    const size_t idx = ((size_t)b * O + o0 + o) * plane + (size_t)h * W + x0;
    const float bo = bias[b * O + o0 + o];
    float r[P];
    if (skip != nullptr) load_strip<T, P>(skip + idx, r, vec, n);
#pragma unroll
    for (int p = 0; p < P; ++p)
      r[p] = acc[p][o] + bo + (skip != nullptr ? r[p] : 0.f);
    store_strip<T, P>(out + idx, r, vec, n);
  }
}

template <typename T, int OT, int P>
cudaError_t launch(const void* x, const void* a, const void* bb,
                   const void* w, const void* bias, const void* skip,
                   void* out, int B, int C, int O, int H, int W, int act,
                   cudaStream_t stream) {
  static bool smem_set = false;  // the attribute is set once per process
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        planar_unit_kernel<T, OT, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const int n_ochunks = (O + OT - 1) / OT;
  // 16-byte loads and strips need whole vectors per row and 16-byte
  // aligned x, skip and out (a view may start at any element)
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = W % 8 == 0 && aligned(x) && aligned(out) &&
                  (skip == nullptr || aligned(skip));
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * n_ochunks);
  planar_unit_kernel<T, OT, P>
      <<<grid, Tiling<P>::NT, smem_bytes(C, OT), stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(a),
          static_cast<const float*>(bb), static_cast<const float*>(w),
          static_cast<const float*>(bias), static_cast<const T*>(skip),
          static_cast<T*>(out), C, O, H, W, act, n_ochunks, vec);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* a, const void* bb,
                     const void* w, const void* bias, const void* skip,
                     void* out, int B, int C, int O, int H, int W, int act,
                     cudaStream_t s) {
  // the smallest register tile that holds min(O, 16) output channels;
  // P*OT <= 64 sums a thread
  if (O <= 1)
    return launch<T, 1, 8>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act,
                           s);
  else if (O <= 2)
    return launch<T, 2, 8>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act,
                           s);
  else if (O <= 4)
    return launch<T, 4, 8>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act,
                           s);
  else if (O <= 8)
    return launch<T, 8, 8>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act,
                           s);
  else
    return launch<T, 16, 4>(x, a, bb, w, bias, skip, out, B, C, O, H, W, act,
                           s);
}

}  // namespace

// x, skip, out: [B,C,H,W] / [B,O,H,W] / [B,O,H,W] in f32 (bf16 == 0) or
// bf16 (bf16 == 1), contiguous (16-byte aligned ones with W % 8 == 0
// take the vector loads, any others element by element); a, bb: [B,C] f32;
// w: [3,3,C,O] f32; bias: [B,O] f32; skip may be null. Requires
// C*O <= 160. Returns cudaGetLastError().
extern "C" int planar_unit_launch(const void* x, const void* a, const void* bb,
                                  const void* w, const void* bias,
                                  const void* skip, void* out, int B, int C,
                                  int O, int H, int W, int act, int bf16,
                                  void* stream) {
  if (C * O > MAX_CO || C < 1 || O < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? dispatch<__nv_bfloat16>(x, a, bb, w, bias, skip, out, B, C, O,
                                     H, W, act, s)
           : dispatch<float>(x, a, bb, w, bias, skip, out, B, C, O, H, W,
                             act, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

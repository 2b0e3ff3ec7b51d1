// Shared pieces of the SIMT flash-attention kernels (flash_attn_f32.cu,
// flash_bwd.cu): head dimension 64, 64-row tiles staged in shared memory
// as f32, one 256-thread block computing a 64 x 64 tile of products as a
// 16 x 16 grid of threads with a 4 x 4 register tile each.
//
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns
// tx + 16 j, i, j = 0..3. With the tiles' row stride of LD = 65 floats a
// warp (two values of ty, sixteen of tx) reads row-indexed operands as two
// broadcast addresses and column-indexed ones as sixteen distinct banks,
// so the inner loops have no bank conflicts. The sixteen threads that
// share a row are the sixteen lanes of one half-warp, so a row reduction is
// four shuffles.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace ipdm {
namespace flash {

constexpr int HD = 64;     // head dimension
constexpr int TILE = 64;   // rows (queries or keys) per tile
constexpr int LD = 65;     // shared-memory row stride, in floats
constexpr int NT = 256;    // threads per block
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

typedef float Tile[TILE][LD];

// four consecutive elements of a row, as f32
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  o[0] = __low2float(a);
  o[1] = __high2float(a);
  o[2] = __low2float(b);
  o[3] = __high2float(b);
}

// rows row0 .. row0 + 63 of a [T, 64] matrix into a tile; rows >= T are
// zeros
template <typename E>
__device__ __forceinline__ void load_tile(Tile& dst, const E* src, int row0,
                                          int T) {
  for (int i = threadIdx.x; i < TILE * (HD / 4); i += NT) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < T) load4(src + (size_t)(row0 + r) * HD + c, o);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r][c + e] = o[e];
  }
}

// acc[i][j] += sum_d a[ty + 16 i][d] * b[tx + 16 j][d]: a 64 x 64 tile of
// row-by-row dot products over the head dimension
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const Tile& a,
                                         const Tile& b, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[ty + 16 * i][d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[tx + 16 * j][d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c p[ty + 16 i][c] * b[c][tx + 16 j]: a 64 x 64 tile of
// weights times a 64 x 64 tile of values
__device__ __forceinline__ void mul_tile(float (&acc)[4][4], const Tile& p,
                                         const Tile& b, int ty, int tx) {
#pragma unroll 8
  for (int c = 0; c < TILE; ++c) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = p[ty + 16 * i][c];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[c][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// reductions over the sixteen lanes of a half-warp (one row's threads)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace flash
}  // namespace ipdm

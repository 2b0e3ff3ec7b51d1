// Two-tap row deposit: the forward projection of the fast SART plans and of
// the fast projector, one kernel behind three wrappers.
//
// Replaces the Pallas TPU kernels ipdm_tpu/ops/pallas/shift.py:279
// fp_plane_deposit (body _fp2_kernel :240), :354 fp_shift_deposit_batched
// (body _fp3_kernel :326) and :625 fp_shift_deposit (body _fp_kernel :597):
//
//   out[v,b,s_t[v,y]+j] += w_t[v,y] * rows[y,b,j],   t in {0,1}
//
// rows: [n,B,W] f32 (the single-image deposit is B = 1); s0, s1: [V,n]
// int32 with 0 <= s and s + W <= L (checked by the wrapper), any table:
// neither monotone starts nor s1 = s0 + 1 is assumed; w0, w1: [V,n] f32;
// out: [V,B,L] f32.
//
// What bounds it on an H100, at the main path's shapes (n = W = 512, V =
// 504 views, B = 1 or 2, L = 1408 or 2560): the bytes are small (rows 1 MB
// per image read once, out 2.8-10 MB written once, ~1-4 us); the real work
// is 2 taps * 2 flops per (v, y, b, j), 0.53 GFLOP per image, 7.9 us at the
// f32 rate. Every tap reads one staged value: 264M taps per image are ~36
// us of the SMs' shared-memory rate (128 bytes a clock each). This body
// runs at about a third of that; bodies with a third fewer shared-memory
// loads (one load for both taps where s1 = s0 + 1) or twice the warps per
// block were no faster on the card, so the tap loads alone do not hold it
// there (PERF.md, PR 6).
//
// Design: the row-band form. All views read the same rows at different
// shifts, so a block holds kBand rows of one image in shared memory and
// walks up to kViews views over them, instead of each view pulling the
// rows from L2 again (504 MB of L2 reads per image in the gather form of
// the earlier kernel, which also walked all n rows for every bin). The
// band is copied with cp.async (a second buffer bought no overlap worth
// its shared memory: a band's copy is short beside its sums). Each staged
// row carries kPad zero columns on both sides, so a lane reads its tap
// without a window test. A block owns whole output rows out[v,b,:] of its
// views in shared memory (acc) for the whole launch: no other block
// writes them, so there is no cross-block reduction and no atomic.
//
// Per band and view, lane l holds tap (l & 1) of the band's rows
// 16 p + (l >> 1), p < kPairs. The view's warps walk the tiles of kTile
// bins that some tap window meets (one ballot per tile and p; on the fast
// projector's Kf = 2 plan the two taps of a row land in different
// k-planes, so the span between the planes is dead) and take the live
// tiles in turn. For a tile, the warp compacts its live taps into a list
// in (row, tap) order (popc of the ballots: offset of the tap's first
// value, weight), pads it to a multiple of 4 with weight-0 taps that read
// a zero pad, and walks it 4 taps at a time: 4 list entries, then
// 4 x kBins staged values, all loads in flight before the multiply-adds.
// A lane keeps kBins bins (t0 + lane + 32 j) in registers; at the end of
// the tile it adds the band's partial sums to acc. So every output is
//   (((0 + P_0) + P_1) + ...) + P_{nb-1},  P_k = band k's taps that meet
//                                          the tile, in (row, tap) order,
// a fixed order whatever the launch shape, views per block or batch (a
// tap whose window meets the tile but not the bin adds an exact zero):
// two launches on the same inputs give the same bits, and the three
// wrappers (one image or a batch) give the same bits for the same item.
// 32-row bands halve the tiles' fixed work (ballots, list, acc update)
// against 16-row bands. tests/test_torch_deposit_tiles.py writes this
// order out on the CPU (its DEP_BAND and DEP_TILE mirror kBand and kTile).
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBand = 32;            // rows per band: sets the sum order
constexpr int kPairs = 2 * kBand / 32;  // a lane's (row, tap)s of a band
constexpr int kBins = 4;             // bins per lane
constexpr int kTile = 32 * kBins;    // bins per warp tile
constexpr int kPad = kTile;          // zero columns on each side of a row
constexpr int kViews = 4;            // views per block (at most)
constexpr int kThreads = 256;        // 8 warps, split evenly over the views
constexpr unsigned kFull = 0xffffffffu;
static_assert(2 * kBand % 32 == 0, "a band's taps fill whole warps");

struct __align__(16) Tap {
  int s0, s1;
  float w0, w1;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// floats of one staged row: W rounded up to 16 bytes, plus both pads
__host__ __device__ inline int row_len(int W) {
  return ((W + 3) & ~3) + 2 * kPad;
}

__host__ __device__ inline int acc_len(int L) {
  return (L + kTile - 1) / kTile * kTile;
}

inline size_t smem_bytes(int W, int L, int nvg) {
  return sizeof(float) * ((size_t)kBand * row_len(W)) +
         sizeof(Tap) * ((size_t)nvg * kBand) +
         sizeof(int2) * (2 * kBand * kThreads / 32) +
         sizeof(float) * ((size_t)nvg * acc_len(L));
}

__global__ void __launch_bounds__(kThreads)
    fp_deposit_kernel(const float* __restrict__ rows,
                      const int* __restrict__ s0, const int* __restrict__ s1,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1, float* __restrict__ out,
                      int V, int B, int W, int L, int n, int nvg, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rl = row_len(W);
  const int Lr = acc_len(L);
  // [kBand][rl] rows, [nvg][kBand] taps, [warps][2 kBand] tap lists,
  // [nvg][Lr] sums
  float* band = reinterpret_cast<float*>(smem);
  Tap* taps = reinterpret_cast<Tap*>(band + kBand * rl);
  int2* lists = reinterpret_cast<int2*>(taps + nvg * kBand);
  float* acc = reinterpret_cast<float*>(lists + 2 * kBand * kThreads / 32);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wpv = kThreads / 32 / nvg;  // warps per view
  const int vi = warp / wpv;            // this warp's view in the group
  const int sub = warp % wpv;           // its turn among the view's warps
  const int v0 = blockIdx.x * nvg;
  const int b = blockIdx.y;
  const int v = v0 + vi;
  const bool active = vi < nvg && v < V;

  for (int i = tid; i < kBand * rl; i += kThreads) band[i] = 0.f;
  for (int i = tid; i < nvg * Lr; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  // band kb's rows of image b and the group's taps
  auto load = [&](int kb) {
    const int y0 = kb * kBand;
    const int nr = min(kBand, n - y0);
    float* dst = band + kPad;
    if (vec) {
      const int w4 = W / 4;
      for (int i = tid; i < nr * w4; i += kThreads) {
        const int r = i / w4, c = 4 * (i % w4);
        cp_async16(dst + r * rl + c,
                   rows + ((size_t)(y0 + r) * B + b) * W + c);
      }
    } else {
      for (int i = tid; i < nr * W; i += kThreads) {
        const int r = i / W, c = i % W;
        cp_async4(dst + r * rl + c, rows + ((size_t)(y0 + r) * B + b) * W + c);
      }
    }
    for (int i = tid; i < nvg * kBand; i += kThreads) {
      const int vv = v0 + i / kBand, y = y0 + i % kBand;
      if (vv < V && y < n) {
        const size_t k = (size_t)vv * n + y;
        cp_async4(&taps[i].s0, s0 + k);
        cp_async4(&taps[i].s1, s1 + k);
        cp_async4(&taps[i].w0, w0 + k);
        cp_async4(&taps[i].w1, w1 + k);
      }
    }
  };

  const int nb = (n + kBand - 1) / kBand;
  for (int kb = 0; kb < nb; ++kb) {
    load(kb);
    cp_async_wait_all();
    __syncthreads();
    if (active) {
      // lane l stands for tap (l & 1) of the band's rows 16 p + (l >> 1),
      // p < kPairs, and holds their starts, weights and spans of tiles
      // (none for rows past n)
      const Tap* tp = taps + vi * kBand;
      int s[kPairs], lo[kPairs], hi[kPairs];
      float w[kPairs];
      int kmin = INT_MAX, kmax = -1;
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int y = 16 * p + (lane >> 1);
        const Tap e = tp[y];
        s[p] = lane & 1 ? e.s1 : e.s0;
        w[p] = lane & 1 ? e.w1 : e.w0;
        const bool row = kb * kBand + y < n;
        lo[p] = row ? s[p] / kTile : INT_MAX;
        hi[p] = row ? (s[p] + W - 1) / kTile : -1;
        kmin = min(kmin, lo[p]);
        kmax = max(kmax, hi[p]);
      }
      kmin = __reduce_min_sync(kFull, kmin);
      kmax = __reduce_max_sync(kFull, kmax);
      const float* rb = band + lane;
      float* ac = acc + vi * Lr + lane;
      int2* list = lists + warp * 2 * kBand;
      const unsigned below = (1u << lane) - 1;
      int live = 0;
      for (int k = kmin; k <= kmax; ++k) {
        unsigned M[kPairs];
        unsigned any = 0;
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          M[p] = __ballot_sync(kFull, lo[p] <= k && k <= hi[p]);
          any |= M[p];
        }
        if (!any || live++ % wpv != sub) continue;
        const int t0 = k * kTile;
        // the tile's live taps, compacted in (row, tap) order, padded to a
        // multiple of 4 with weight-0 taps that read row 0's left pad
        int c = 0;
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          if ((M[p] >> lane) & 1u)
            list[c + __popc(M[p] & below)] = make_int2(
                (16 * p + (lane >> 1)) * rl + kPad + t0 - s[p],
                __float_as_int(w[p]));
          c += __popc(M[p]);
        }
        const int c4 = (c + 3) & ~3;
        if (lane < c4 - c) list[c + lane] = make_int2(0, 0);
        __syncwarp();
        float a[kBins];
#pragma unroll
        for (int j = 0; j < kBins; ++j) a[j] = 0.f;
        for (int i = 0; i < c4; i += 4) {
          int2 q[4];
          float x[4][kBins];
#pragma unroll
          for (int u = 0; u < 4; ++u) q[u] = list[i + u];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < kBins; ++j) x[u][j] = rb[q[u].x + 32 * j];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < kBins; ++j)
              a[j] = fmaf(__int_as_float(q[u].y), x[u][j], a[j]);
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kBins; ++j) ac[t0 + 32 * j] += a[j];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nvg * L; i += kThreads) {
    const int g = i / L, t = i % L;
    if (v0 + g < V) out[((size_t)(v0 + g) * B + b) * L + t] = acc[g * Lr + t];
  }
}

}  // namespace

extern "C" int fp_deposit_launch(const void* rows, const void* s0,
                                 const void* s1, const void* w0,
                                 const void* w1, void* out, int V, int B,
                                 int W, int L, int n, void* stream) {
  if (V < 1 || B < 1 || B > 65535 || n < 1 || W < 1 || L < W)
    return (int)cudaErrorInvalidValue;
  int dev = 0, cap = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // as many views per block as the shared memory holds (each block reads
  // the rows once); the sum order does not depend on it
  int nvg = kViews;
  while (nvg > 1 && smem_bytes(W, L, nvg) > (size_t)cap) nvg /= 2;
  const size_t smem = smem_bytes(W, L, nvg);
  if (smem > (size_t)cap) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fp_deposit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  dim3 grid((V + nvg - 1) / nvg, B);
  fp_deposit_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(s0),
      static_cast<const int*>(s1), static_cast<const float*>(w0),
      static_cast<const float*>(w1), static_cast<float*>(out), V, B, W, L,
      n, nvg, vec);
  return (int)cudaGetLastError();
}

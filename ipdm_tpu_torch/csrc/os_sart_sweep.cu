// One OS-SART sweep over one drive axis's ordered subsets.
//
// Replaces the Pallas TPU kernel ipdm_tpu/ops/pallas/shift.py:544
// os_sart_sweep_mm (body _oss_mm_kernel :432), both operand modes. For each
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
// wrapper); rows: [S,Vp,nTiles,2] int32, for each tile of kTile bins the
// first row and one past the last whose taps can land in it (0 <= r0,
// r1 <= n, checked by the wrapper; r1 <= r0 is an empty tile); T: a
// [Vp,B,L] scratch.
//
// A CUDA grid cannot carry x from one subset to the next the way the TPU
// grid does (its sequential grid revisits the image block), so the host
// loop below issues two dependent launches per subset on one stream, 2*S
// launches per call:
//  1. FP + correction, one cluster of kFpSplit blocks per (tile of 64
//     bins, view, group of NB images). Only the rows of the tile's range
//     are visited: a row's window [s0, s0 + n] is n + 1 of L bins wide, so
//     most rows miss most tiles. The range is cut into one contiguous
//     chunk per block of the cluster and each chunk into one share per
//     warp (a tile in the middle of a view holds all n rows, an edge tile
//     few: chunks of a heavy tile run on several SMs); each lane keeps 2
//     bins x NB images in registers, and the view's taps are staged in
//     shared memory. A
//     loaded value x[b,y,u] is tap 0 of bin u + s0 and tap 1 of bin
//     u + s0 + 1, so one load serves both: the lane keeps the two sums
//     apart and the tap-1 sum moves one bin over by a shuffle at the end
//     (bp_gather.cuh does the same along j). The warps' partial sums are
//     added in shared memory in warp order, the blocks' by the cluster's
//     first block through distributed shared memory in rank order, and T
//     is written. Inside the range each lane still tests its window, so a
//     table that is not monotone is summed right.
//  2. BP + update + clamp: the gather of bp_gather.cuh with s1 = s0 + 1
//     (one warp per row, 4 columns x NB images per lane, the subset's
//     views in order, their loads in flight in groups), the relaxed update
//     and the clamp in place.
// Every sum runs in a fixed order with no atomics: two launches on the same
// inputs give the same bits. Pad views of a subset (s0 = 0, frac = 0, rf =
// inv2 = 0) get T = 0 and add nothing.
//
// What bounds it on an H100, per call at the SIEMENS_FBP main path (B=4,
// n=512, 32 subsets of 16 views, L=1408): the real tap work is 2 taps * 2
// flops * B*n*n per view for the FP and again for the BP, 4.2 GFLOP over
// 500 views, 0.063 ms at the f32 rate; the bytes, each input read once and
// x written once, are ~46 MB (rf 11.5 MB dominates), 0.014 ms. What the
// kernels meet first is the SM's load path: each FP launch reads x from L2
// once per view (16 x 4 MB, ~1.4x that in whole sectors), ~20 us at the
// L2's rate; the BP reads every tap from L1, 4 bytes a lane. The TPU
// kernel's tap matrices for the MXU, its 128-residue plane scratch and its
// rolls exist for the TPU and have no counterpart: the taps are computed
// directly in f32.
//
// The bf16 operand mode (shift.py:441, :470, :480, :526) is the second
// instantiation of the two kernels (BF16 = true). The TPU kernel casts its
// two-hot tap matrix and the other matmul operand to bf16 and sums in f32,
// so each output is a sum of exact bf16 x bf16 products: here the tap
// weights (1-f, f), the image value (FP half) and the correction T (BP
// half) are rounded to bf16 before each product and the products are
// summed in f32. rf, inv2, nrmi, the correction's own arithmetic and the
// update stay f32, as on the TPU.
#include <cooperative_groups.h>

#include "bp_gather.cuh"

namespace cg = cooperative_groups;

namespace {

using ipdm::kBpCols;
using ipdm::kBpWarps;

constexpr int kFpWarps = 8;
constexpr int kFpSplit = 4;           // blocks (a cluster) per FP tile
constexpr int kFpBins = 2;            // bins per lane
constexpr int kTile = 32 * kFpBins;   // bins per FP tile (the rows table's)

// the FP sums of one warp over rows [i, i + NG) of the block's staged
// range: the group's loads first (addresses clamped into the row, values
// zeroed after the load where the column is off the row), then the sums
template <int NG, int NB, bool BF16>
__device__ __forceinline__ void fp_rows(
    int i, const int* ts, const float* tw0, const float* tw1,
    const float* __restrict__ xb, int r0, int n, int t0, int lane,
    float (&a)[NB][kFpBins], float (&c)[NB][kFpBins], float (&e)[NB]) {
  float q[NG][NB][kFpBins], qe[NG][NB];
  int u0[NG], ue[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int s = ts[i + g];
    u0[g] = t0 + lane - s;  // column of this lane's first bin
    ue[g] = t0 - 1 - s;     // column whose tap 1 lands on the tile's bin 0
    const float* xr = xb + (size_t)(r0 + i + g) * n;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float* r = xr + (size_t)b * n * n;
#pragma unroll
      for (int k = 0; k < kFpBins; ++k)
        q[g][b][k] = __ldg(r + min(max(u0[g] + 32 * k, 0), n - 1));
      qe[g][b] = __ldg(r + min(max(ue[g], 0), n - 1));
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const float w0 = tw0[i + g], w1 = tw1[i + g];
    const bool ein = (unsigned)ue[g] < (unsigned)n;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int k = 0; k < kFpBins; ++k) {
        float v = (unsigned)(u0[g] + 32 * k) < (unsigned)n ? q[g][b][k] : 0.f;
        if (BF16) v = ipdm::round_bf16(v);
        a[b][k] += w0 * v;
        c[b][k] += w1 * v;
      }
      float v = ein ? qe[g][b] : 0.f;
      if (BF16) v = ipdm::round_bf16(v);
      e[b] += w1 * v;
    }
  }
}

template <int NB, bool BF16>
__global__ void __cluster_dims__(kFpSplit, 1, 1)
    __launch_bounds__(32 * kFpWarps)
        sweep_fp_kernel(const float* __restrict__ x,
                        const float* __restrict__ rf,
                        const float* __restrict__ inv2,
                        const float* __restrict__ frac,
                        const int* __restrict__ s0,
                        const int* __restrict__ rows, float* __restrict__ T,
                        int B, int n, int L, int nTiles) {
  constexpr int G = 8 / NB;  // rows per group
  extern __shared__ unsigned char smem[];
  __shared__ float part[kFpWarps][NB][kTile];
  __shared__ float blk[NB][kTile];
  int* ts = reinterpret_cast<int*>(smem);               // [n] starts
  float* tw0 = reinterpret_cast<float*>(ts + n);        // [n] 1 - f
  float* tw1 = tw0 + n;                                 // [n] f
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();           // the row chunk
  const int tile = blockIdx.x / kFpSplit;
  const int v = blockIdx.y;
  const int b0 = blockIdx.z * NB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = tile * kTile;
  const int* rr = rows + ((size_t)v * nTiles + tile) * 2;
  const int all = max(rr[1] - rr[0], 0);
  const int chunk = (all + kFpSplit - 1) / kFpSplit;
  const int r0 = rr[0] + rank * chunk;
  const int cnt = max(min(all - rank * chunk, chunk), 0);
  // the correction's operands, loaded by the block that writes T before
  // the sums so that their latency hides behind them
  constexpr int kPer = (NB * kTile + 32 * kFpWarps - 1) / (32 * kFpWarps);
  float rfv[kPer], iv[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = threadIdx.x + m * 32 * kFpWarps;
    const int t = t0 + i % kTile;
    rfv[m] = iv[m] = 0.f;
    if (rank == 0 && i < NB * kTile && t < L) {
      rfv[m] = rf[((size_t)v * B + b0 + i / kTile) * L + t];
      iv[m] = inv2[(size_t)v * L + t];
    }
  }
  for (int i = threadIdx.x; i < cnt; i += 32 * kFpWarps) {
    const int k = v * n + r0 + i;
    const float f = frac[k];
    ts[i] = s0[k];
    tw0[i] = BF16 ? ipdm::round_bf16(1.f - f) : 1.f - f;
    tw1[i] = BF16 ? ipdm::round_bf16(f) : f;
  }
  __syncthreads();
  // a: tap-0 sums at this lane's bins; c: tap-1 sums at the bin of the
  // value (they belong one bin over); e: the tap-1 sum that lands on the
  // tile's first bin, from the bin before it (a broadcast load per row)
  float a[NB][kFpBins], c[NB][kFpBins], e[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    e[b] = 0.f;
#pragma unroll
    for (int k = 0; k < kFpBins; ++k) a[b][k] = c[b][k] = 0.f;
  }
  const int share = (cnt + kFpWarps - 1) / kFpWarps;
  const int ia = warp * share;
  const int ib = min(cnt, ia + share);
  const float* xb = x + (size_t)b0 * n * n;
  int i = ia;
  for (; i + G <= ib; i += G)
    fp_rows<G, NB, BF16>(i, ts, tw0, tw1, xb, r0, n, t0, lane, a, c, e);
  for (; i < ib; ++i)
    fp_rows<1, NB, BF16>(i, ts, tw0, tw1, xb, r0, n, t0, lane, a, c, e);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int k = 0; k < kFpBins; ++k) {
      const float up = __shfl_up_sync(0xffffffffu, c[b][k], 1);
      const float prev =
          k > 0 ? __shfl_sync(0xffffffffu, c[b][k - 1], 31) : e[b];
      part[warp][b][lane + 32 * k] = a[b][k] + (lane == 0 ? prev : up);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NB * kTile; i += 32 * kFpWarps) {
    float p = 0.f;
#pragma unroll
    for (int w = 0; w < kFpWarps; ++w) p += part[w][i / kTile][i % kTile];
    blk[i / kTile][i % kTile] = p;
  }
  // the cluster's row chunks, added in rank order by its first block
  // through distributed shared memory
  cluster.sync();
  if (rank == 0) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int i = threadIdx.x + m * 32 * kFpWarps;
      const int t = t0 + i % kTile;
      if (i >= NB * kTile || t >= L) continue;
      float p = 0.f;
#pragma unroll
      for (int r = 0; r < kFpSplit; ++r)
        p += cluster.map_shared_rank(&blk[0][0], r)[i];
      T[((size_t)v * B + b0 + i / kTile) * L + t] = rfv[m] - p * iv[m];
    }
  }
  cluster.sync();  // the chunks' shared memory outlives the reads
}

template <int NB, bool BF16>
__global__ void __launch_bounds__(32 * kBpWarps)
    sweep_bp_kernel(const float* __restrict__ T, const int* __restrict__ s0,
                    const float* __restrict__ frac,
                    const float* __restrict__ nrmi, float* __restrict__ x,
                    int Vp, int B, int n, int L, float lam) {
  using Gather = ipdm::BpGather<NB, kBpCols, true, BF16>;
  __shared__ typename Gather::Smem sm;
  const int lane = threadIdx.x & 31;
  const int y0 = blockIdx.y * kBpWarps;
  const int y = y0 + (threadIdx.x >> 5);
  const int j0 = blockIdx.x * 32 * kBpCols;
  const int b0 = blockIdx.z * NB;
  // the update's operands, loaded before the sums so that their latency
  // hides behind them (no other block writes this block's pixels)
  const int yc = min(y, n - 1);
  float xv[NB][kBpCols], gv[kBpCols];
#pragma unroll
  for (int k = 0; k < kBpCols; ++k) {
    const int j = min(j0 + lane + 32 * k, n - 1);
    gv[k] = lam * __ldg(nrmi + (size_t)yc * n + j);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      xv[b][k] = x[((size_t)(b0 + b) * n + yc) * n + j];
  }
  Gather g;
  g.run(sm, T, (size_t)B * L, L, s0, nullptr, frac, Vp, n, y0, j0, b0);
  if (y >= n) return;  // whole warps
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float* xr = x + ((size_t)(b0 + b) * n + y) * n;
#pragma unroll
    for (int k = 0; k < kBpCols; ++k) {
      const float acc = g.out(b, k, lane);  // every lane: shuffles
      const int j = j0 + lane + 32 * k;
      if (j < n) xr[j] = fmaxf(xv[b][k] + gv[k] * acc, 0.f);
    }
  }
}

template <int NB, bool BF16>
int sweep(float* x, const float* rf, const float* inv2, const float* frac,
          const int* s0, const int* rows, const float* nrmi, float* T, int S,
          int Vp, int B, int n, int L, int nTiles, float lam,
          cudaStream_t st) {
  const int smem = 12 * n;  // the FP's staged taps
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 fp_grid(nTiles * kFpSplit, Vp, B / NB);
  const dim3 bp_grid((n + 32 * kBpCols - 1) / (32 * kBpCols),
                     (n + kBpWarps - 1) / kBpWarps, B / NB);
  for (int s = 0; s < S; ++s) {
    const size_t tab = (size_t)s * Vp * n;
    sweep_fp_kernel<NB, BF16><<<fp_grid, 32 * kFpWarps, smem, st>>>(
        x, rf + (size_t)s * Vp * B * L, inv2 + (size_t)s * Vp * L, frac + tab,
        s0 + tab, rows + (size_t)s * Vp * nTiles * 2, T, B, n, L, nTiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sweep_bp_kernel<NB, BF16><<<bp_grid, 32 * kBpWarps, 0, st>>>(
        T, s0 + tab, frac + tab, nrmi + (size_t)s * n * n, x, Vp, B, n, L,
        lam);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// tile: the bins per tile of the rows table, which must be this build's
// kTile (the wrapper passes its own constant: a mismatch is refused)
extern "C" int os_sart_sweep_launch(void* x, const void* rf, const void* inv2,
                                    const void* frac, const void* s0,
                                    const void* rows, const void* nrmi,
                                    void* T, int S, int Vp, int B, int n,
                                    int L, int tile, float lam, int bf16,
                                    void* stream) {
  if (S < 1 || Vp < 1 || B < 1 || n < 1 || L <= n || tile != kTile)
    return (int)cudaErrorInvalidValue;
  // 4 images per block where the batch allows it, else 1
  const int nTiles = (L + kTile - 1) / kTile;
  auto* fn = B % 4 == 0 ? (bf16 ? sweep<4, true> : sweep<4, false>)
                        : (bf16 ? sweep<1, true> : sweep<1, false>);
  return fn(static_cast<float*>(x), static_cast<const float*>(rf),
            static_cast<const float*>(inv2), static_cast<const float*>(frac),
            static_cast<const int*>(s0), static_cast<const int*>(rows),
            static_cast<const float*>(nrmi), static_cast<float*>(T), S, Vp, B,
            n, L, nTiles, lam, static_cast<cudaStream_t>(stream));
}

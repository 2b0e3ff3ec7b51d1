// The two-tap backprojection gather shared by bp_shift.cu (bp_shift #2 and
// #7) and os_sart_sweep.cu (the sweep's BP half):
//
//   out[b,y,j] = sum_v w0[v,y] * Q[v,b,s0[v,y]+j] + w1[v,y] * Q[v,b,s1[v,y]+j]
//
// with w0 = 1 - f, w1 = f from the view's [V,n] frac table, Q: [V,B,L].
//
// Thread mapping: one warp per output row y; lane l of the warp holds the
// columns j = j0 + l + 32k (k < KJ) of NB images in f32 registers, so each
// Q load of a warp reads 32 consecutive floats. The view loop runs inside
// the thread, views added in order (no atomics: two launches give the
// same bits). Each warp takes the views in groups of G: the group's starts
// and weights, then all its Q values (G * NB * KJ loads per tap, every
// address clamped into the signal and the value zeroed after the load
// where the column is past the row), and only then the sums, so many
// loads are in flight per warp. With several images per block the block
// first stages its rows' starts and weights for a chunk of up to 64 views
// in shared memory (one barrier a chunk), so no group's Q addresses wait
// on a load from L2; with one image the warp loads its own, one group
// ahead (the next group's starts are in flight while this group's sums
// run): there the barriers cost more than they save.
// Neighbouring rows (the block's other warps) read windows that overlap
// almost entirely, so the Q reads after the first come from L1. (Staging
// the Q windows too, a chunk of 8 views a barrier, was slower at every
// main-path shape.)
//
// ADJ (the sweep: s1 = s0 + 1, the frac table's second tap) needs one load
// per column instead of two: a loaded value Q[s0+j] is tap 0 of column j
// and tap 1 of column j - 1, so the thread keeps two sums, a (w0 taps) and
// c (w1 taps, at the column of the value), and column j's output is
// a[j] + c[j+1], the second from the next lane by a shuffle (from lane 0
// of the next chunk for lane 31, and for the warp's last column from e,
// one broadcast load per view). The order of the sums changes, not the
// taps. With BF16 the weights and each Q value are rounded to bf16 before
// their products (exact in f32) and the sums stay f32: the TPU kernel's
// bf16 matmul operands.
#pragma once

#include "common.cuh"

namespace ipdm {

constexpr int kBpWarps = 8;  // rows per block, one warp each
constexpr int kBpCols = 4;   // KJ: columns per lane, 128 per warp

template <int NB, int KJ, bool ADJ, bool BF16>
struct BpGather {
  // with several images per block the rows' taps are staged in shared
  // memory a chunk of views at a time; with one, each warp loads its own
  static constexpr bool kStage = NB > 1;
  static constexpr int G = 4;  // views per group
  static constexpr int kVt = kStage ? 64 : 1;  // views whose taps are staged

  // the taps of the block's rows for a chunk of views
  struct Smem {
    int s0[kVt][kBpWarps];
    int s1[ADJ ? 1 : kVt][kBpWarps];
    float w0[kVt][kBpWarps];
    float w1[kVt][kBpWarps];
  };

  float a[NB][KJ];
  float c[NB][KJ];
  float e[NB];
  // per-thread constants of run()
  const float* qb;
  size_t vstride;
  int L, n, y, warp;
  int col[KJ];   // the lane's columns, clamped to the last one read
  bool in[KJ];   // the column is read (not past the row)
  int ce;        // ADJ: the warp's next column, clamped
  bool tail;     // ADJ: that column exists

  template <int NG>
  struct Taps {
    int i0[NG], i1[NG];
    float w0[NG], w1[NG];
  };

  // the starts and weights of views [v, v + NG): from the staged chunk
  // (u: v's place in it), or from the tables, where a view past V reads
  // view V - 1's (loaded for the next group, never summed)
  template <int NG>
  __device__ __forceinline__ void taps(Taps<NG>& tp, const Smem& sm, int v,
                                       int u, int V,
                                       const int* __restrict__ s0,
                                       const int* __restrict__ s1,
                                       const float* __restrict__ frac) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if constexpr (kStage) {
        tp.i0[g] = sm.s0[u + g][warp];
        tp.i1[g] = ADJ ? 0 : sm.s1[ADJ ? 0 : u + g][warp];
        tp.w0[g] = sm.w0[u + g][warp];
        tp.w1[g] = sm.w1[u + g][warp];
      } else {
        const int t = min(v + g, V - 1) * n + y;
        const float f = __ldg(frac + t);
        tp.i0[g] = __ldg(s0 + t);
        tp.i1[g] = ADJ ? 0 : __ldg(s1 + t);
        tp.w0[g] = BF16 ? round_bf16(1.f - f) : 1.f - f;
        tp.w1[g] = BF16 ? round_bf16(f) : f;
      }
    }
  }

  // the views [v, v + NG): every Q load, then next() (the caller's loads
  // for the following group, in flight behind these), then the sums
  template <int NG, class Next>
  __device__ __forceinline__ void group(const Taps<NG>& tp, int v,
                                        Next next) {
    float q0[NG][NB][KJ], q1[ADJ ? 1 : NG][NB][KJ], qe[NG][NB];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float* q = qb + (size_t)(v + g) * vstride + (size_t)b * L;
#pragma unroll
        for (int k = 0; k < KJ; ++k) {
          q0[g][b][k] = __ldg(q + tp.i0[g] + col[k]);
          if (!ADJ) q1[ADJ ? 0 : g][b][k] = __ldg(q + tp.i1[g] + col[k]);
        }
        if (ADJ) qe[g][b] = __ldg(q + tp.i0[g] + ce);
      }
    }
    next();
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int k = 0; k < KJ; ++k) {
          float u0 = in[k] ? q0[g][b][k] : 0.f;
          if (BF16) u0 = round_bf16(u0);
          if (ADJ) {
            a[b][k] += tp.w0[g] * u0;
            c[b][k] += tp.w1[g] * u0;
          } else {
            const float u1 = in[k] ? q1[ADJ ? 0 : g][b][k] : 0.f;
            a[b][k] += tp.w0[g] * u0 + tp.w1[g] * u1;
          }
        }
        if (ADJ) {
          float ue = tail ? qe[g][b] : 0.f;
          if (BF16) ue = round_bf16(ue);
          e[b] += tp.w1[g] * ue;
        }
      }
    }
  }

  // sum over views [0, V) for the block's rows y0 + warp, columns
  // j0 + lane + 32k, images [b0, b0 + NB) of Q (image stride L, view
  // stride vstride); s1 is read only when !ADJ. Every thread of the block
  // calls it (it synchronises); a warp whose row is past n sums nothing.
  __device__ __forceinline__ void run(Smem& sm, const float* __restrict__ Q,
                                      size_t vstride_, int L_,
                                      const int* __restrict__ s0,
                                      const int* __restrict__ s1,
                                      const float* __restrict__ frac, int V,
                                      int n_, int y0, int j0, int b0) {
    const int lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    vstride = vstride_;
    L = L_;
    n = n_;
    y = y0 + warp;
    qb = Q + (size_t)b0 * L;
    // ADJ reads one column past the last output (tap 1 of column n - 1)
    const int jmax = ADJ ? n : n - 1;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      e[b] = 0.f;
#pragma unroll
      for (int k = 0; k < KJ; ++k) a[b][k] = c[b][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < KJ; ++k) {
      const int j = j0 + lane + 32 * k;
      in[k] = j <= jmax;
      col[k] = min(j, jmax);
    }
    ce = min(j0 + 32 * KJ, jmax);
    tail = j0 + 32 * KJ <= n;
    if constexpr (!kStage) {
      // the taps of each group are loaded while the one before it sums
      if (y >= n || V <= 0) return;
      Taps<G> cur, nxt;
      taps(cur, sm, 0, 0, V, s0, s1, frac);
      int v = 0;
      for (; v + G <= V; v += G) {
        group(cur, v, [&] { taps(nxt, sm, v + G, 0, V, s0, s1, frac); });
        cur = nxt;
      }
      for (; v < V; ++v) {
        Taps<1> one;
        taps(one, sm, v, 0, V, s0, s1, frac);
        group(one, v, [] {});
      }
    } else {
      for (int vt = 0; vt < V; vt += kVt) {
        const int nv = min(kVt, V - vt);
        for (int i = threadIdx.x; i < nv * kBpWarps; i += 32 * kBpWarps) {
          const int u = i / kBpWarps, r = i % kBpWarps;
          if (y0 + r >= n) continue;
          const int t = (vt + u) * n + y0 + r;
          const float f = __ldg(frac + t);
          sm.s0[u][r] = __ldg(s0 + t);
          if (!ADJ) sm.s1[ADJ ? 0 : u][r] = __ldg(s1 + t);
          sm.w0[u][r] = BF16 ? round_bf16(1.f - f) : 1.f - f;
          sm.w1[u][r] = BF16 ? round_bf16(f) : f;
        }
        __syncthreads();
        if (y < n) {
          int u = 0;
          for (; u + G <= nv; u += G) {
            Taps<G> tp;
            taps(tp, sm, vt + u, u, V, s0, s1, frac);
            group(tp, vt + u, [] {});
          }
          for (; u < nv; ++u) {
            Taps<1> one;
            taps(one, sm, vt + u, u, V, s0, s1, frac);
            group(one, vt + u, [] {});
          }
        }
        __syncthreads();  // the next chunk restages the taps
      }
    }
  }

  // the output of column j0 + lane + 32k of image b0 + b; every lane of
  // the warp must call it (shuffles)
  __device__ __forceinline__ float out(int b, int k, int lane) const {
    if (!ADJ) return a[b][k];
    const float up = __shfl_down_sync(0xffffffffu, c[b][k], 1);
    const float next =
        k + 1 < KJ ? __shfl_sync(0xffffffffu, c[b][k + 1], 0) : e[b];
    return a[b][k] + (lane == 31 ? next : up);
  }
};

}  // namespace ipdm

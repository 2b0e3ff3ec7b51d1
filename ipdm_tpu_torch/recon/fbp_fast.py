"""Fast fan-beam FBP: rebin to parallel, ramp filter, shifted-window
backprojection (port of ipdm_tpu/recon/fbp_fast.py).

1. **Fan → parallel rebinning.** A fan ray (view θ, fan angle γ) is the
   parallel ray (φ = θ−γ, t = D·sinγ). On a uniform (φ, t) grid the fan
   detector index depends only on the t-column and the view shift is
   affine in the φ-index: a per-column row gather, a per-column circular
   view shift and two lerps.
2. **Half-turn fold and parallel ramp filter.** View φ+π samples the rays
   of view φ with t reversed, so the two halves are added before the R-L
   ramp (by rFFT), which halves both the filter and the backprojection.
3. **Backprojection.** For a parallel view the t-index of pixel (i, j) is
   affine in j along the view's drive axis, so each filtered row is
   resampled once onto a fine grid (``_prep_group``) and every image row
   becomes a contiguous window of it at a per-row start with a per-row
   lerp: the ``bp_shift_accumulate_batched`` kernel (ops/cuda/shift.py),
   or for a single sinogram its one-signal-per-view entry
   ``bp_shift_accumulate``.
   Views split into an x-driven and a y-driven group; the y-driven group
   accumulates into the transposed image.

Same discretisation as the JAX package's ``fbp_convert_fast``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ipdm_tpu_torch.ops.cuda.shift import (bp_shift_accumulate,
                                           bp_shift_accumulate_batched)
from ipdm_tpu_torch.recon.fbp import SIEMENS_FBP, FBPGeometry


class _FastPlan:
    """Precomputed static tables for one FBPGeometry (host numpy), with
    per-device tensor copies made at first use (fbp_fast.py:49-124).
    ``oversample`` sets the parallel t grid to ``oversample·N`` bins: 2
    for the FBP, 1 for the OS-SART plan (recon/sart_fast.py)."""

    def __init__(self, g: FBPGeometry, oversample: float = 2.0):
        self.g = g
        N, M = g.N, g.M
        self.D = float(g.D)
        self.da = float(g.da)
        nda = g.nda.astype(np.float64)
        self.nda0 = float(nda[0])
        gamma_max = float(np.abs(nda).max())
        # parallel t grid
        self.Nt = int(N * oversample)
        T = self.D * math.sin(gamma_max + self.da)
        self.T = T
        self.dt = 2 * T / (self.Nt - 1)
        t = -T + np.arange(self.Nt) * self.dt
        gamma_t = np.arcsin(np.clip(t / self.D, -1, 1))
        # per-column fan detector index (reference lerp convention)
        dp = (gamma_t - self.nda0) / self.da - 0.5
        self.det_i0 = np.clip(np.floor(dp).astype(np.int64), 0, N - 2)
        self.det_f = (dp - np.floor(dp)).astype(np.float32)
        self.det_valid = ((dp >= 0.0) & (dp <= N - 1)).astype(np.float32)
        # parallel angle φ = θ − γ: view shift +γ/Δθ, circular
        dtheta = 2 * math.pi / M
        self.dphi = dtheta
        sv_mod = np.mod(gamma_t / dtheta, M)
        self.view_i0 = np.floor(sv_mod).astype(np.int64)
        self.view_f = (sv_mod - self.view_i0).astype(np.float32)
        # parallel-beam R-L kernel on the t grid, length 2·Nt−1
        nn = np.arange(-(self.Nt - 1), self.Nt)
        h = np.zeros(2 * self.Nt - 1)
        h[self.Nt - 1] = 1.0 / (4 * self.dt ** 2)
        odd = nn % 2 != 0
        h[odd] = -1.0 / (math.pi * nn[odd] * self.dt) ** 2
        self.h_par = (h * self.dt).astype(np.float32)
        # pixel grids (FBPGeometry._getrphi conventions)
        n, L = g.grid_n, g.grid_l
        i = np.arange(1, n + 1)
        self.y = ((n + 1 - i - n / 2 - 0.5) * 2 * L / n)   # rows (desc)
        self.x = ((i - n / 2 - 0.5) * 2 * L / n)           # cols (asc)
        self.dp_pix = 2 * L / n
        self.n = n
        phis = np.arange(M) * dtheta
        c, s = np.cos(phis), np.sin(phis)
        # pos = (x·sinφ + y·cosφ + T)/dt → x-driven when |sinφ| dominates
        self.group_xdrive = np.abs(s) >= np.abs(c)
        self.cosphi = c
        self.sinphi = s
        # fine resample: Kq sub-steps per drive pixel keep the grid at
        # ≤ 1 t-bin spacing
        self.Lq = 2 * n + 8
        self.Kq = max(1, int(math.ceil(self.dp_pix / self.dt)))
        self._dev = {}

    def tensors(self, device) -> dict:
        """The plan's tables as tensors on ``device`` (made once)."""
        key = str(device)
        if key not in self._dev:
            f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                            device=device)
            i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                            device=device)
            self._dev[key] = dict(
                det_i0=i64(self.det_i0), det_f=f32(self.det_f),
                det_valid=f32(self.det_valid), view_i0=i64(self.view_i0),
                view_f=f32(self.view_f), x=f32(self.x), y=f32(self.y),
                cos=f32(self.cosphi), sin=f32(self.sinphi),
                h_par=f32(self.h_par))
        return self._dev[key]


_PLANS = {}


def _plan_for(g: FBPGeometry, oversample: float = 2.0) -> _FastPlan:
    k = (g.N, g.M, g.grid_n, g.grid_l, g.D, g.da, oversample)
    if k not in _PLANS:
        _PLANS[k] = _FastPlan(g, oversample=oversample)
    return _PLANS[k]


def _rebin(pj: torch.Tensor, p: _FastPlan) -> torch.Tensor:
    """[B, M, N] fan (already det-flipped) → [B, M, Nt] parallel
    (fbp_fast.py:127-149)."""
    B, M, N = pj.shape
    tb = p.tensors(pj.device)
    det_major = pj.transpose(1, 2)                           # [B, N, M]
    r0 = det_major[:, tb["det_i0"], :]                       # [B, Nt, M]
    r1 = det_major[:, tb["det_i0"] + 1, :]
    fd = tb["det_f"][None, :, None]
    G = ((1 - fd) * r0 + fd * r1) * tb["det_valid"][None, :, None]
    # per-column circular view shift (k + s_j) mod M as a window of the
    # doubled view axis
    Gpad = torch.cat([G, G], dim=2)                          # [B, Nt, 2M]
    idx = tb["view_i0"][:, None] + torch.arange(M, device=pj.device)
    idx = idx[None].expand(B, -1, -1)
    fv = tb["view_f"][None, :, None]
    P = ((1 - fv) * torch.gather(Gpad, 2, idx)
         + fv * torch.gather(Gpad, 2, idx + 1))
    return P.transpose(1, 2)                                 # [B, M, Nt]


def _ramp_parallel(P: torch.Tensor, p: _FastPlan) -> torch.Tensor:
    """Ramp filter along t via rFFT, the centre slice of the 'full'
    convolution (fbp_fast.py:152-159)."""
    Nt = p.Nt
    Lf = int(2 ** math.ceil(math.log2(3 * Nt - 2)))
    K = torch.fft.rfft(p.tensors(P.device)["h_par"], n=Lf)
    F = torch.fft.rfft(P, n=Lf, dim=-1)
    full = torch.fft.irfft(F * K, n=Lf, dim=-1)
    return full[..., Nt - 1: 2 * Nt - 1]


def _prep_group(Pf, p: _FastPlan, view_idx: np.ndarray, xdrive: bool):
    """Per-view fine resample and per-row tap offsets for one view group
    (fbp_fast.py:173-245). Pf: [B, M, Nt]. Returns (T2 [V, B, LqK],
    start0 [V, n] int32, start1 [V, n] int32, o_frac [V, n] f32)."""
    n, dt, T, Lq, Kq, Nt = p.n, p.dt, p.T, p.Lq, p.Kq, p.Nt
    LqK = Lq * Kq
    dev = Pf.device
    tb = p.tensors(dev)
    vidx = torch.as_tensor(view_idx, dtype=torch.long, device=dev)
    cos_g, sin_g = tb["cos"][vidx], tb["sin"][vidx]
    P_g = Pf[:, vidx, :]                                     # [B, V, Nt]
    if xdrive:
        drive, other, a_trig, o_trig = tb["x"], tb["y"], sin_g, cos_g
    else:
        drive, other, a_trig, o_trig = tb["y"], tb["x"], cos_g, sin_g
    # pos(o, d) = (drive[d]·a_trig + other[o]·o_trig + T)/dt = a·d + b_o
    a = (drive[1] - drive[0]) * a_trig / dt                  # [V]
    b = (other[None, :] * o_trig[:, None]
         + drive[0] * a_trig[:, None] + T) / dt              # [V, n]
    sgn = torch.sign(a)
    a_abs = a.abs()
    b_adj = torch.where(sgn[:, None] > 0, b, -b)
    beta0 = b_adj.amin(dim=1) - a_abs
    step = a_abs / Kq
    mq = torch.arange(LqK, dtype=torch.float32, device=dev)
    qpos = sgn[:, None] * (step[:, None] * mq + beta0[:, None])  # [V, LqK]
    qi = torch.floor(qpos)
    qf = qpos - qi
    qi0 = qi.long().clamp(0, Nt - 1)
    qi1 = (qi0 + 1).clamp_max(Nt - 1)
    qvalid = ((qpos >= 0.0) & (qpos <= Nt - 1)).float()
    o_real = (b_adj - beta0[:, None]) / step[:, None]        # [V, n]
    o_floor = torch.floor(o_real)
    o_frac = o_real - o_floor
    o_int = o_floor.long().clamp(0, LqK - n * Kq - 2)
    o1 = o_int + 1
    start0 = (o_int % Kq) * Lq + o_int // Kq
    start1 = (o1 % Kq) * Lq + o1 // Kq
    # Q'[v, b, m] = lerp of P_g[b, v] at qpos[v, m], zero outside the row
    V = vidx.numel()
    B = Pf.shape[0]
    Pv = P_g.transpose(0, 1)                                 # [V, B, Nt]
    g0 = torch.gather(Pv, 2, qi0[:, None, :].expand(V, B, LqK))
    g1 = torch.gather(Pv, 2, qi1[:, None, :].expand(V, B, LqK))
    Qp = ((1 - qf)[:, None] * g0 + qf[:, None] * g1) * qvalid[:, None]
    # flat layout T2[k·Lq + r] = Q'[r·Kq + k]: the tap at Q'-index
    # Kq·j + o_i is the contiguous window start_i + j
    T2 = Qp.reshape(V, B, Lq, Kq).transpose(2, 3).reshape(V, B, LqK)
    return (T2.contiguous(), start0.int().contiguous(),
            start1.int().contiguous(), o_frac.contiguous())


def _bp_group(Pf, p: _FastPlan, view_idx: np.ndarray, xdrive: bool):
    """Backproject one view group (fbp_fast.py:248-292). Pf: [B, M, Nt].
    Returns [B, n, n] in standard row/col orientation."""
    T2, start0, start1, o_frac = _prep_group(Pf, p, view_idx, xdrive)
    if T2.shape[1] == 1:    # one sinogram: one signal per view
        acc = bp_shift_accumulate(T2[:, 0].contiguous(), start0, start1,
                                  o_frac, p.n)[None]
    else:
        acc = bp_shift_accumulate_batched(T2, start0, start1, o_frac, p.n)
    return acc if xdrive else acc.transpose(1, 2)


def fbp_convert_fast(pj: torch.Tensor,
                     g: FBPGeometry = SIEMENS_FBP) -> torch.Tensor:
    """[B, M, N] sinograms → [B, n, n] images, with the reference
    ``convert``'s detector flip on input and image flip on output
    (fbp_fast.py:295-323)."""
    p = _plan_for(g)
    P = _rebin(pj.float().flip(-1), p)
    M = g.M
    if M % 2 == 0:
        # half-turn fold before the (even) ramp: same output, half the work
        P = P[:, :M // 2] + P[:, M // 2:].flip(-1)
        xdm = p.group_xdrive[:M // 2]
    else:
        xdm = p.group_xdrive
    Pf = _ramp_parallel(P, p) * (p.dphi * 0.5)  # 360° covers each ray twice
    img = (_bp_group(Pf, p, np.nonzero(xdm)[0], True)
           + _bp_group(Pf, p, np.nonzero(~xdm)[0], False))
    return img.flip(-1)

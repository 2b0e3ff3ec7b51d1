"""Fast OS-SART on the rebinned parallel geometry (port of the fused path
of ipdm_tpu/recon/sart_fast.py).

* The measured fan sinogram is rebinned once to parallel geometry
  (recon/fbp_fast.py at t-oversampling 1) and folded to a half turn:
  parallel views φ and φ+π sample the same rays with t reversed, so the
  two halves are averaged.
* The iteration runs on each view's fine ray grid in ratio space. Once
  per convert the measured sinogram becomes the ray-average ratio
  R = m_t / n_t (n_t = FP of ones, static) and is resampled onto the fine
  grids (:func:`anterp_taps`); the per-subset SART correction is then
  elementwise, ``corr = R_fine − T·scale/n_fine`` on the live rays.
* Views split into an x-driven and a y-driven set (by which pixel axis
  moves the ray fastest); each set is cut into angle-interleaved ordered
  subsets. One sweep runs the x-driven subsets on the image and the
  y-driven ones on its transpose, each drive as one
  :func:`os_sart_sweep` call (FP by two-tap row deposits, correction, BP,
  relaxed update, clamp per subset).
* SART constants follow the reference: relaxation 0.24·0.95^sweep,
  correction (m−p)/n, nonnegativity clamp, the post-SART image of the last
  sweep returned, NSL0-TV steps with annealed σ (recon/sart.py).

* :func:`project_fast` is the forward projector on the same plan class at
  the natural fine-grid refinement Kf = ceil(pixel pitch / t-bin) (fine
  ray spacing ≤ 1 t-bin): image rows deposited onto each view's fine grid
  (:func:`fp_shift_deposit_batched`), anterpolated onto the t bins
  (:func:`anterp_taps`), the half turn mirrored to the full one and
  rebinned back to the fan (:func:`_inverse_rebin`). The OS-SART convert
  runs at Kf = 1.

The static tables are host numpy (as in the JAX package) or f32 tensors
computed once on the CPU and copied to each device at first use; the
static norms are computed once per (plan, device). The unfused sweep is
ported with a later slice. Output orientation matches
``fbp_convert_fast``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ipdm_tpu_torch.ops.cuda.shift import (anterp_taps,
                                           bp_shift_accumulate_batched,
                                           fp_plane_deposit, fp_shift_deposit,
                                           fp_shift_deposit_batched,
                                           os_sart_sweep, sweep_row_ranges)
from ipdm_tpu_torch.recon.fbp import FBPGeometry
from ipdm_tpu_torch.recon.fbp_fast import _FastPlan, _plan_for, _rebin
from ipdm_tpu_torch.recon.sart import nsl0_tv_grad

# The JAX plan pads each view set to a multiple of 8 views and caps a
# drive subset at 16 views (its TPU blocks); both shape the ordered
# subsets and the table layouts, so the port keeps them to reconstruct
# the same image.
VB = 8
_MAX_SUBSET_VIEWS = 16
_EPS = 1e-8


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class _Group:
    """Static tables of one view group (sart_fast.py:95-203). Fine ray m
    sits at t position sgn·(step·m + β0), with step the view's per-row
    advance over K. One flat fine layout serves both projectors: ray
    m ∈ [0, K·Lq) lives at flat index f = (m % K)·Lq + m // K, so a row
    deposit (stride K in m) is a contiguous width-n window of one k-plane,
    and the BP taps read the same windows. At K = 1 the layout is m itself.

    ``ids`` are global view indices (they pick the angles); ``local_ids``
    the rows of the folded, subsampled parallel sinogram."""

    def __init__(self, p: _FastPlan, ids: np.ndarray, local_ids: np.ndarray,
                 xdrive: bool, Kf: int = 1):
        self.p = p
        self.local_ids = local_ids
        self.xdrive = xdrive
        self.V = len(ids)
        self.Vpad = _round_up(max(self.V, 1), VB)
        self.K = Kf
        n = p.n
        dt = p.dt
        if xdrive:
            drive, other = p.x, p.y
            dtrig, otrig = p.sinphi[ids], p.cosphi[ids]
        else:
            drive, other = p.y, p.x
            dtrig, otrig = p.cosphi[ids], p.sinphi[ids]
        a = (drive[1] - drive[0]) * dtrig / dt                 # [V]
        b = (other[:, None] * otrig[None, :]
             + drive[0] * dtrig[None, :] + p.T) / dt           # [n, V]
        sgn = np.sign(a)
        step = np.abs(a) / Kf                                  # [V]
        b_adj = np.where(sgn > 0, b, -b)
        beta0 = b_adj.min(axis=0) - 2 * step                   # [V]
        o_real = (b_adj - beta0[None, :]) / step[None, :]      # [n, V]
        self.sgn = sgn.astype(np.float32)
        self.step = step.astype(np.float32)
        self.beta0 = beta0.astype(np.float32)
        # per-view scalars the row tables are rebuilt from
        self.other = other.astype(np.float32)                  # [n]
        self.ob = (otrig / dt).astype(np.float32)              # [V]
        self.c0 = ((drive[0] * dtrig + p.T) / dt).astype(np.float32)
        # Lq rays per k-plane, sized so every deposit/read window stays
        # inside one plane
        self.Wn = _round_up(n, 128)
        o_hi = int(np.floor(o_real).max() + 1 if self.V else 0)
        self.Lq = o_hi // Kf + self.Wn + 132
        self.L = _round_up(Kf * self.Lq + 128, 128)
        self._host = {}
        self._dev = {}
        self._bounds = {}

    def _pad_vec(self, v: np.ndarray, fill=0.0) -> torch.Tensor:
        """[V] host vector → [Vpad] f32 tensor."""
        if self.Vpad > self.V:
            v = np.pad(v, (0, self.Vpad - self.V), constant_values=fill)
        return torch.as_tensor(np.asarray(v, np.float32))

    def _live(self) -> torch.Tensor:
        return (torch.arange(self.Vpad) < self.V)[:, None]

    def _row_tables(self):
        """(s0, s1 int32, frac f32), each [Vpad, n] (sart_fast.py:154-180):
        row y of view v deposits at fine ray o = (sgn·b(y, v) − β0_v)/step_v
        with b = other_y·ob_v + c0_v, in f32 as the JAX plan computes it;
        s0, s1 are the flat starts of rays ⌊o⌋ and ⌊o⌋ + 1."""
        other = torch.as_tensor(self.other)
        ob, c0, sgn = (self._pad_vec(a) for a in (self.ob, self.c0, self.sgn))
        step = self._pad_vec(self.step, fill=1.0)
        beta0 = self._pad_vec(self.beta0)
        b = other[None, :] * ob[:, None] + c0[:, None]         # [Vpad, n]
        o = (torch.where(sgn[:, None] > 0, b, -b)
             - beta0[:, None]) / step[:, None]
        oi = torch.floor(o)
        frac = o - oi
        smax = self.L - self.Wn - 128
        oi = oi.to(torch.int32).clamp(0, smax)
        K, Lq = self.K, self.Lq
        flat = lambda m: (m % K) * Lq + torch.div(m, K, rounding_mode="floor")
        live = self._live()
        zero = torch.zeros((), dtype=torch.int32)
        return (torch.where(live, flat(oi), zero).clamp(0, smax),
                torch.where(live, flat(oi + 1), zero).clamp(0, smax),
                torch.where(live, frac, torch.zeros(())))

    def _ray_of(self, f: torch.Tensor) -> torch.Tensor:
        """Fine ray m = (f % Lq)·K + f // Lq at flat index f."""
        return (f % self.Lq) * self.K + torch.div(f, self.Lq,
                                                  rounding_mode="floor")

    def _qpos(self, m: torch.Tensor) -> torch.Tensor:
        """t positions sgn·(step·m + β0) of fine rays m [M]: [Vpad, M]."""
        sgn = self._pad_vec(self.sgn)[:, None]
        step = self._pad_vec(self.step, fill=1.0)[:, None]
        beta0 = self._pad_vec(self.beta0)[:, None]
        return sgn * (step * m[None, :].float() + beta0)

    def _valid_table(self):
        """qvalid f32 [Vpad, L] (sart_fast.py:182-203): the fine rays that
        land inside the t grid; pad rows and the tail past the K planes
        are dead."""
        f = torch.arange(self.L, dtype=torch.int32)
        qpos = self._qpos(self._ray_of(f))
        return ((qpos >= 0.0) & (qpos <= self.p.Nt - 1)
                & (f < self.K * self.Lq)[None, :] & self._live()).float()

    def _resample_tables(self):
        """The two taps of the t → fine resample (sart_fast.py:417-438):
        qi [Vpad, K·Lq] int32 and W [Vpad, 2, K·Lq] over the flat layout,
        where a second tap clipped onto the first folds into it
        (w0 = (1−qf) + qf·same), the clipped lerp exactly."""
        Nt = self.p.Nt
        qpos = self._qpos(self._ray_of(
            torch.arange(self.K * self.Lq, dtype=torch.int32)))
        qi = torch.floor(qpos)
        qf = qpos - qi
        qi = qi.to(torch.int32)
        qi0u = qi.clamp(0, Nt - 1)
        same = ((qi + 1).clamp(0, Nt - 1) == qi0u).float()
        w0 = (1 - qf) + qf * same
        w1 = qf * (1 - same)
        return qi0u.contiguous(), torch.stack([w0, w1], dim=1).contiguous()

    def tables(self, device) -> dict:
        """The group's tables as tensors on ``device`` (computed once on
        the CPU, copied once per device)."""
        if not self._host:
            s0, s1, frac = self._row_tables()
            rqi, rw = self._resample_tables()
            self._host = dict(s0=s0, s1=s1, frac=frac,
                              qvalid=self._valid_table(), rqi=rqi, rw=rw)
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = {k: v.to(device) for k, v in self._host.items()}
        return self._dev[key]

    def bounds(self, name: str) -> tuple:
        """(min, max) of an int table, read once from its host copy: the
        window bounds its kernels check without a device read."""
        if name not in self._bounds:
            t = self.tables("cpu")[name]
            self._bounds[name] = (int(t.min()), int(t.max()))
        return self._bounds[name]


class _SartFastPlan:
    """Static tables for one (geometry, nsubsets, view subset)
    (sart_fast.py:206-355). ``kf`` sets the fine-grid refinement: None
    takes ceil(dp_pix/dt), which keeps the fine ray spacing ≤ 1 t-bin (the
    forward projector's plan); kf=1 sets it to the view's per-row advance,
    the grid the fused sweep runs on (its second tap starts at s0 + 1)."""

    def __init__(self, g: FBPGeometry, nsubsets: int,
                 view_ids: np.ndarray = None, kf: int = None):
        self.g = g
        self.p = _plan_for(g, oversample=1.0)
        p = self.p
        self.Kf = int(kf) if kf else max(1, int(math.ceil(p.dp_pix / p.dt)))
        if view_ids is None:
            view_ids = np.arange(g.M)
        self.view_ids = np.asarray(view_ids)
        nv = len(self.view_ids)
        while nsubsets > 1 and nv % nsubsets:
            nsubsets -= 1
        self.nsubsets = nsubsets
        xd = p.group_xdrive
        loc_all = np.arange(nv)
        m = xd[self.view_ids]
        self.gx_all = _Group(p, self.view_ids[m], loc_all[m], True, self.Kf)
        self.gy_all = _Group(p, self.view_ids[~m], loc_all[~m], False,
                             self.Kf)
        # each drive's views in angle-interleaved subsets of ≤ 16 views:
        # drive -> (S, Vp, idx [S, Vp] into the drive's rows, pad = -1)
        self.dsub = {}
        vp_target = max(1, -(-nv // max(1, self.nsubsets)))
        for key, grp in (("x", self.gx_all), ("y", self.gy_all)):
            Vd = grp.V
            if Vd == 0:
                self.dsub[key] = (0, 0, np.zeros((0, 0), np.int64))
                continue
            S = max(1, -(-Vd // vp_target))
            while -(-Vd // S) > _MAX_SUBSET_VIEWS:
                S += 1
            Vp = _round_up(-(-Vd // S), VB)
            idx = np.full((S, Vp), -1, np.int64)
            for s in range(S):
                rows = np.arange(s, Vd, S)
                idx[s, :len(rows)] = rows
            self.dsub[key] = (S, Vp, idx)
        self._norms = {}

    def group(self, key: str) -> _Group:
        return self.gx_all if key == "x" else self.gy_all

    def subset_take(self, key: str, a: torch.Tensor) -> torch.Tensor:
        """Rows [V, ...] of a drive group laid out by subset [S, Vp, ...],
        pad entries zero (sart_fast.py:277-281)."""
        grp = self.group(key)
        _, _, idx = self.dsub[key]
        ext = torch.cat([a[:grp.V], a.new_zeros((1,) + tuple(a.shape[1:]))])
        ii = torch.as_tensor(np.where(idx < 0, grp.V, idx), device=a.device)
        return ext[ii]

    def fused_tables(self, key: str, device):
        """s0, s1 int32 and frac f32, each [S, Vp, n]: one drive's row
        tables by subset (sart_fast.py:268-281)."""
        tb = self.group(key).tables(device)
        return tuple(self.subset_take(key, tb[k]).contiguous()
                     for k in ("s0", "s1", "frac"))

    # -- FP ------------------------------------------------------------

    def fp_group_fine(self, img: torch.Tensor, grp: _Group,
                      deposit=None) -> torch.Tensor:
        """FP of one group onto its fine grid (sart_fast.py:285-302).
        img [B, n, n] (fbp frame). Returns [Vpad, B, L] ray sums in
        deposit units. ``deposit`` is the kernel wrapper that lands the
        rows, :func:`fp_plane_deposit` unless the caller passes another
        of the same contract; it gets the starts' bounds from the host
        tables, so its window check reads nothing from the device."""
        B = img.shape[0]
        if grp.V == 0:
            return img.new_zeros((grp.Vpad, B, grp.L))
        src = img if grp.xdrive else img.transpose(1, 2)
        rows = src.transpose(0, 1).float().contiguous()        # [n, B, n]
        scale = float(np.float32(self.p.dp_pix * self.p.dp_pix / self.p.dt))
        tb = grp.tables(img.device)
        live = (torch.arange(grp.Vpad, device=img.device) < grp.V)[:, None]
        w0 = torch.where(live, (1.0 - tb["frac"]) * scale,
                         torch.zeros((), device=img.device))
        w1 = tb["frac"] * scale
        taps = (tb["s0"], tb["s1"], w0.contiguous(), w1.contiguous(), grp.L)
        (lo0, hi0), (lo1, hi1) = grp.bounds("s0"), grp.bounds("s1")
        return (deposit or fp_plane_deposit)(
            rows, *taps, bounds=(min(lo0, lo1), max(hi0, hi1)))

    def fp_group(self, img: torch.Tensor, grp: _Group, anterp: bool = True,
                 deposit=None) -> torch.Tensor:
        """FP of one group anterpolated onto the t bins (sart_fast.py:
        304-378): t bin d takes the fine rays within one bin of it, with
        linear weights, Wt = 2·Kf + 2 taps from ray
        m0 = ⌊(±d − 1 − β0)/step⌋ on. img [B, n, n]. Returns [B, V, Nt].

        ``anterp`` picks the form. True: the k-planes de-interleaved to
        ray order ([K, Lq] → [Lq, K], exact data movement) and one
        :func:`anterp_taps` call, whose windows the wrapper checks
        (the TPU kernel's span limit per 128-bin block does not exist
        here, so this form serves every geometry). False: the JAX plan's
        fallback, one windowed gather per tap straight from the flat
        layout."""
        p = self.p
        Kf = self.Kf
        B = img.shape[0]
        dev = img.device
        if grp.V == 0:
            return img.new_zeros((B, 0, p.Nt))
        T = self.fp_group_fine(img, grp, deposit)[:grp.V]      # [V, B, L]
        Mfine = Kf * grp.Lq
        Wt = 2 * Kf + 2
        d = torch.arange(p.Nt, dtype=torch.float32, device=dev)[None, :]
        f32 = lambda a: torch.as_tensor(a, device=dev)[:, None]
        sgn, step, beta0 = f32(grp.sgn), f32(grp.step), f32(grp.beta0)
        d_adj = torch.where(sgn > 0, d, -d)
        m0 = torch.floor((d_adj - 1.0 - beta0) / step).to(torch.int32)
        if anterp:
            Tm = T[:, :, :Mfine]
            if Kf > 1:                                         # ray order
                Tm = (Tm.reshape(grp.V, B, Kf, grp.Lq).transpose(2, 3)
                      .reshape(grp.V, B, Mfine))
            qi0 = m0.clamp(0, max(Mfine - 1, 0))               # [V, Nt]
            ks = torch.arange(Wt, dtype=torch.float32,
                              device=dev)[None, :, None]
            midx = qi0[:, None, :].float() + ks                # [V, Wt, Nt]
            qpos = sgn[:, None] * (step[:, None] * midx + beta0[:, None])
            W = ((1.0 - (qpos - d[:, None]).abs()).clamp_min(0.0)
                 * (midx < Mfine))
            Tp = F.pad(Tm, (0, Wt)).contiguous()  # the last window's room
            out = anterp_taps(Tp, qi0.contiguous(), W.contiguous(),
                              qi0_bounds=(0, max(Mfine - 1, 0)))
            return out.transpose(0, 1)                         # [B, V, Nt]
        out = img.new_zeros((grp.V, B, p.Nt))
        for k in range(Wt):
            m = m0 + k
            qpos = sgn * (step * m.float() + beta0)
            w = (1.0 - (qpos - d).abs()).clamp_min(0.0)
            mc = m.clamp(0, Mfine - 1)
            fi = ((mc % Kf) * grp.Lq
                  + torch.div(mc, Kf, rounding_mode="floor")).long()
            valid = ((m >= 0) & (m < Mfine)).to(img.dtype)
            idx = fi[:, None, :].expand(grp.V, B, p.Nt)
            out = out + torch.gather(T, 2, idx) * (w * valid)[:, None, :]
        return out.transpose(0, 1)                             # [B, V, Nt]

    # -- the measured ratios on the fine grid -----------------------------

    def resample_to_fine(self, R: torch.Tensor, grp: _Group) -> torch.Tensor:
        """Resample per-view t-grid signals R [B, nv, Nt] onto the group's
        flat fine grid with two clipped-lerp taps (sart_fast.py:394-443),
        one :func:`anterp_taps` call. Returns [Vpad, B, L]."""
        B = R.shape[0]
        if grp.V == 0:
            return R.new_zeros((grp.Vpad, B, grp.L))
        rv = R[:, torch.as_tensor(grp.local_ids, device=R.device)]
        rv = rv.transpose(0, 1).float()                        # [V, B, Nt]
        rv = F.pad(rv, (0, 1, 0, 0, 0, grp.Vpad - grp.V))     # [Vpad,B,Nt+1]
        tb = grp.tables(R.device)
        out = anterp_taps(rv.contiguous(), tb["rqi"], tb["rw"],
                          qi0_bounds=grp.bounds("rqi"))      # [Vpad,B,K·Lq]
        return F.pad(out, (0, grp.L - grp.K * grp.Lq))


_SPLANS = {}


def _splan_for(g: FBPGeometry, nsubsets: int, fold: bool = False,
               sample_rate: int = 1, kf: int = None) -> _SartFastPlan:
    k = (g.N, g.M, g.grid_n, g.grid_l, g.D, g.da, nsubsets, fold,
         sample_rate, kf)
    if k not in _SPLANS:
        ids = np.arange(g.M // 2 if fold else g.M)
        if sample_rate > 1:
            ids = ids[::sample_rate]
        _SPLANS[k] = _SartFastPlan(g, nsubsets, view_ids=ids, kf=kf)
    return _SPLANS[k]


def _norms_for(sp: _SartFastPlan, device):
    """The static norms of the fused sweep on ``device``, computed at the
    first request and kept on the plan."""
    key = str(torch.device(device))
    if key not in sp._norms:
        sp._norms[key] = _compute_norms_fused(sp, device)
    return sp._norms[key]


def _compute_norms_fused(sp: _SartFastPlan, device):
    """Static tables of the fused sweeps (sart_fast.py:549-596):

      nt_full [nv, Nt] — t-grid FP of ones per view (the R denominator)
      per drive key: dict with
        valid [Vpad, L]  — live-ray mask over the drive's views
        inv2  [S, Vp, L] — masked scale/n_fine by subset
        nrmi  [S, n, n]  — per-subset 1/BP(valid), drive frame
        s0, frac [S, Vp, n] — the sweep's row tables
        s0_bounds        — (min, max) of s0, read from its host copy
        rows [S, Vp, nTiles, 2] — per tile of the sweep's FP, the rows
                           whose taps can land in it (sweep_row_ranges of
                           the host copy of s0), and rows_bounds its
                           (min, max)
    """
    p = sp.p
    n = p.n
    nv = len(sp.view_ids)
    scale = float(np.float32(p.dp_pix * p.dp_pix / p.dt))
    ones_img = torch.ones((1, n, n), dtype=torch.float32, device=device)
    nt_full = torch.zeros((nv, p.Nt), dtype=torch.float32, device=device)
    zero = torch.zeros((), device=device)
    per_drive = {}
    for key in ("x", "y"):
        grp = sp.group(key)
        if grp.V == 0:
            continue
        nt = sp.fp_group(ones_img, grp)[0]                     # [V, Nt]
        nt_full[torch.as_tensor(grp.local_ids, device=device)] = nt
        S = sp.dsub[key][0]
        nf = sp.fp_group_fine(ones_img, grp)[:, 0, :]          # [Vpad, L]
        valid = (nf > _EPS).float() * grp.tables(device)["qvalid"]
        inv2_rows = torch.where(valid > 0, scale / nf.clamp_min(_EPS), zero)
        s0, s1, frac = sp.fused_tables(key, device)
        vsub = sp.subset_take(key, valid)                      # [S, Vp, L]
        # the starts' range from the host tables (pad entries hold 0)
        bounds = (0, max(grp.bounds("s0")[1], grp.bounds("s1")[1]))
        nrm = []
        for s in range(S):
            bpn = bp_shift_accumulate_batched(
                vsub[s][:, None, :].contiguous(), s0[s], s1[s], frac[s],
                n, bounds=bounds)[0]
            nrm.append(torch.where(bpn > _EPS, 1.0 / bpn.clamp_min(_EPS),
                                   zero))
        s0_host = sp.subset_take(key, grp.tables("cpu")["s0"])
        rows = sweep_row_ranges(s0_host, n, grp.L)
        per_drive[key] = dict(valid=valid,
                              inv2=sp.subset_take(key, inv2_rows).contiguous(),
                              nrmi=torch.stack(nrm).contiguous(),
                              s0=s0, frac=frac,
                              s0_bounds=(int(s0_host.min()),
                                         int(s0_host.max())),
                              rows=rows.to(device),
                              rows_bounds=(int(rows.min()), int(rows.max())))
    return nt_full, per_drive


def _tv_steps(x, ntv: int, sigma: float, dtvg):
    """ntv NSL0-TV descent steps of length dtvg [B] (sart_fast.py:651-661)."""
    for _ in range(ntv):
        gr = nsl0_tv_grad(x, sigma)
        gr = torch.where((x < 0) & (gr > 0), torch.full_like(gr, 1e-8), gr)
        x = x.clamp_min(0.0)
        normg = torch.sqrt((gr ** 2).sum(dim=(1, 2)))
        x = x - (dtvg / normg.clamp_min(1e-12))[:, None, None] * gr
    return x


def _sart_iterate_fused(sp: _SartFastPlan, par: torch.Tensor, norms,
                        nstart: int, ntv: int,
                        mm_bf16: bool = False) -> torch.Tensor:
    """OS-SART of a batch of parallel sinograms par [B, nv, Nt] →
    [B, n, n] (fbp frame), one :func:`os_sart_sweep` call per drive axis
    per sweep (sart_fast.py:599-671), in its bf16 operand mode when
    ``mm_bf16``. The relaxation and σ are host f32 numbers, updated as
    the JAX scan updates them."""
    n = sp.p.n
    B = par.shape[0]
    nt_full, per_drive = norms
    R = torch.where(nt_full[None] > _EPS, par / nt_full[None].clamp_min(_EPS),
                    torch.zeros((), device=par.device))
    rf = {}
    for key, d in per_drive.items():
        rfa = sp.resample_to_fine(R, sp.group(key)) * d["valid"][:, None, :]
        rf[key] = sp.subset_take(key, rfa).contiguous()       # [S,Vp,B,L]

    lam, sigma = np.float32(0.24), np.float32(0.8)
    alpha = torch.full((B,), 0.1, dtype=torch.float32, device=par.device)
    x = torch.zeros((B, n, n), dtype=torch.float32, device=par.device)
    x_res = x
    for _ in range(int(nstart)):
        x_back = x
        for key, d in per_drive.items():
            args = (rf[key], d["inv2"], d["frac"], d["s0"], d["nrmi"],
                    float(lam))
            kw = dict(s0_bounds=d["s0_bounds"], bf16=mm_bf16,
                      row_ranges=d["rows"],
                      row_ranges_bounds=d["rows_bounds"])
            if key == "x":
                x = os_sart_sweep(x.contiguous(), *args, **kw)
            else:   # the y-driven views run on the transposed image
                x = os_sart_sweep(x.transpose(1, 2).contiguous(), *args,
                                  **kw).transpose(1, 2)
        x_res = x
        sigma = max(np.float32(sigma * np.float32(0.9)), np.float32(0.1))
        if ntv > 0:
            dp = torch.sqrt(((x - x_back) ** 2).sum(dim=(1, 2)))
            x_pre = x
            x = _tv_steps(x, int(ntv), float(sigma), alpha * dp)
            dg = torch.sqrt(((x - x_pre) ** 2).sum(dim=(1, 2)))
            alpha = torch.where(dg > 0.995 * dp, alpha * 0.96, alpha)
        lam = np.float32(lam * np.float32(0.95))
    return x_res


def sart_fast_convert(pj: torch.Tensor, g: FBPGeometry, nstart: int = 10,
                      ntv: int = 0, nsubsets: int = 40,
                      sample_rate: int = 1,
                      mm_bf16: bool = False) -> torch.Tensor:
    """[B, na, nr] fan sinograms → [B, n, n] images in fbp_convert_fast
    orientation (sart_fast.py:741-772): the reference's recons_torch
    semantics (nstart sweeps, ntv TV steps per sweep, every sample_rate-th
    view) on the rebinned-parallel geometry, folded to a half turn when
    the view count is even, the fused sweep on the Kf=1 fine grid, the
    whole batch at once. ``mm_bf16`` runs the sweeps with bf16-rounded
    product operands (:func:`os_sart_sweep`)."""
    sample_rate = int(sample_rate)
    fold = g.M % 2 == 0
    sp = _splan_for(g, nsubsets, fold=fold, sample_rate=sample_rate, kf=1)
    norms = _norms_for(sp, pj.device)
    par = _rebin(pj.float().flip(-1), sp.p)  # detector flip (fbp convention)
    if fold:
        M = g.M
        par = 0.5 * (par[:, :M // 2] + par[:, M // 2:].flip(-1))
    if sample_rate > 1:
        par = par[:, ::sample_rate]
    img = _sart_iterate_fused(sp, par, norms, int(nstart), int(ntv),
                              mm_bf16=bool(mm_bf16))
    return img.flip(-1)                      # x flip (fbp convention)


# ---------------------------------------------------------------------------
# Fast forward projection: image → fan sinogram
# ---------------------------------------------------------------------------


def _inverse_rebin(par: torch.Tensor, p: _FastPlan, n_det: int, nda0: float,
                   da: float) -> torch.Tensor:
    """[B, M, Nt] parallel → [B, M, n_det] fan, detector-flipped
    convention (sart_fast.py:780-815), the mirror of ``_rebin``: fan ray
    (θ_i, γ_b) is the parallel ray (φ = θ_i − γ_b, t = D·sinγ_b), so per
    fan-detector column the t coordinate is constant and the view shift is
    affine in the view index."""
    B, M, Nt = par.shape
    dev = par.device
    gamma_b = nda0 + np.arange(n_det) * da
    tb = (p.D * np.sin(gamma_b) + p.T) / p.dt
    tb0 = np.clip(np.floor(tb).astype(np.int64), 0, Nt - 2)
    tbf = (tb - np.floor(tb)).astype(np.float32)
    tvalid = ((tb >= 0) & (tb <= Nt - 1)).astype(np.float32)
    sv_mod = np.mod(-gamma_b / (2 * math.pi / M), M)  # φ index i − γ_b/Δθ
    v0 = np.floor(sv_mod).astype(np.int64)
    vf = (sv_mod - v0).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)

    det_major = par.transpose(1, 2)                          # [B, Nt, M]
    r0 = det_major[:, t(tb0), :]                             # [B, n_det, M]
    r1 = det_major[:, t(tb0 + 1), :]
    f = t(tbf)[None, :, None]
    G = ((1 - f) * r0 + f * r1) * t(tvalid)[None, :, None]
    Gpad = torch.cat([G, G], dim=2)                          # circular views
    idx = (t(v0)[:, None] + torch.arange(M, device=dev))[None].expand(
        B, -1, -1)
    fv = t(vf)[None, :, None]
    fan = ((1 - fv) * torch.gather(Gpad, 2, idx)
           + fv * torch.gather(Gpad, 2, idx + 1))
    return fan.transpose(1, 2)                               # [B, M, n_det]


def _shift_deposit(rows: torch.Tensor, *taps, bounds=None) -> torch.Tensor:
    """:func:`fp_plane_deposit`'s contract through the shift deposits:
    rows [n, B, W] through :func:`fp_shift_deposit_batched`, one image
    through :func:`fp_shift_deposit`."""
    if rows.shape[1] == 1:
        return fp_shift_deposit(rows[:, 0].contiguous(), *taps,
                                bounds=bounds)[:, None]
    return fp_shift_deposit_batched(rows, *taps, bounds=bounds)


def project_fast(volume: torch.Tensor, g: FBPGeometry, n_det: int,
                 nda0: float, da: float, anterp: bool = True) -> torch.Tensor:
    """[B, ny, nx] images (the projector's volume convention) → [B, na,
    nr] fan sinograms (sart_fast.py:819-862), on the tensor's device. The
    FP runs on the folded half-turn view set at the natural Kf, one group
    per drive axis, with the shift deposits (:func:`_shift_deposit`); the
    φ + π half is the exact t-mirror. ``anterp`` picks
    :meth:`_SartFastPlan.fp_group`'s form."""
    fold = g.M % 2 == 0
    sp = _splan_for(g, 1, fold=fold)
    # the two groups' views back in view order: par[v] = cat[perm[v]]
    nv = len(sp.view_ids)
    perm = np.zeros((nv,), np.int64)
    perm[np.concatenate([sp.gx_all.local_ids,
                         sp.gy_all.local_ids])] = np.arange(nv)
    internal = volume.float().transpose(1, 2).flip(-1).contiguous()
    cat = torch.cat([sp.fp_group(internal, grp, anterp, deposit=_shift_deposit)
                     for grp in (sp.gx_all, sp.gy_all)], dim=1)
    par = cat[:, torch.as_tensor(perm, device=volume.device)]
    if fold:
        par = torch.cat([par, par.flip(-1)], dim=1)
    fan = _inverse_rebin(par, sp.p, int(n_det), float(nda0), float(da))
    return fan.flip(-1)                      # undo the detector flip
